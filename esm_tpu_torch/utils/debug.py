"""Run-time NaN checks.

Port of esm_tpu/utils/debug.py. esm_tpu turns on ``jax_debug_nans``, which
raises as soon as any operation, forward or backward, produces a NaN, and
names it. ``torch.autograd.set_detect_anomaly`` checks only the backward,
so the port checks every operation's outputs in a dispatch mode instead.
Each check reads the values back, so it synchronizes with the device: a
debugging aid, not for timed runs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class NanCheckMode(TorchDispatchMode):
    """Raises FloatingPointError, naming the operation, when one returns a
    floating-point tensor holding a NaN. Use it as a context manager, or
    through :func:`enable_nan_checks`. Uninitialised allocations
    (``empty*``) are not checked. The autograd engine carries the mode into
    the backward, so gradients are checked too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.startswith(("empty", "new_empty")):
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


_active: Optional[NanCheckMode] = None


def enable_nan_checks(enable: bool = True) -> None:
    """Turn the NaN check of every operation on (or off) for this thread, as
    ``jax_debug_nans`` does for JAX."""
    global _active
    if enable and _active is None:
        _active = NanCheckMode()
        _active.__enter__()
    elif not enable and _active is not None:
        _active.__exit__(None, None, None)
        _active = None
