"""Host-side input validation at the public API boundary.

Port of esm_tpu/utils/validation.py: token dtype/range/rank and
representation-layer indices and backbone coordinates, with the same
errors. Accepts torch tensors,
numpy arrays or nested lists. The value-range check of a token tensor that
already lies on the card is skipped (it would cost a device-to-host copy per
call), and a warning says so once.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

_warned_skip_range_check = False


def _warn_range_check_skipped(name: str) -> None:
    global _warned_skip_range_check
    if _warned_skip_range_check:
        return
    _warned_skip_range_check = True
    warnings.warn(
        f"{name} is on the GPU: the token value-range check is skipped to "
        "avoid a device-to-host copy per call. Out-of-range ids fail in the "
        "embedding lookup — validate on the host if unsure. (warned once)",
        stacklevel=3,
    )


def check_tokens(tokens, alphabet, *, msa: bool = False, name: str = "tokens"):
    """Validate a token tensor against the model's alphabet: shape (B, T),
    or (B, R, C) for MSA models; integer dtype; values in [0, len(alphabet)).
    Returns the input, converted with np.asarray when it is not an array or
    tensor."""
    want = 3 if msa else 2
    arr = tokens if hasattr(tokens, "ndim") else np.asarray(tokens)
    if arr.ndim != want:
        raise ValueError(
            f"{name}: expected {want}D {'(B, R, C)' if msa else '(B, T)'}, "
            f"got shape {tuple(arr.shape)}"
        )
    if isinstance(arr, torch.Tensor):
        integer = not (arr.dtype.is_floating_point or arr.dtype.is_complex
                       or arr.dtype == torch.bool)
    else:
        integer = np.issubdtype(np.dtype(arr.dtype), np.integer)
    if not integer:
        raise TypeError(
            f"{name}: expected integer token ids, got dtype {arr.dtype} "
            "(use alphabet.get_batch_converter() to tokenize strings)"
        )
    size = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
    if size:
        if isinstance(arr, torch.Tensor) and arr.device.type != "cpu":
            _warn_range_check_skipped(name)
        else:
            lo, hi = int(arr.min()), int(arr.max())
            if lo < 0 or hi >= len(alphabet):
                raise ValueError(
                    f"{name}: token ids must be in [0, {len(alphabet)}), "
                    f"found range [{lo}, {hi}]"
                )
    return arr


def check_coords(coords, *, name: str = "coords", batched: bool = False):
    """Backbone coordinates: (L, 3, 3) N/CA/C (or (B, L, 3, 3) when
    ``batched``), floating dtype (esm_tpu/utils/validation.py:107-121).
    NaN/inf rows are legal: missing residues and the padding convention
    (reference esm/inverse_folding/util.py:96-105)."""
    arr = coords if hasattr(coords, "ndim") else np.asarray(coords)
    want = 4 if batched else 3
    if arr.ndim != want or tuple(arr.shape[-2:]) != (3, 3):
        raise ValueError(
            f"{name}: expected {'(B, L, 3, 3)' if batched else '(L, 3, 3)'} "
            f"N/CA/C backbone coordinates, got shape {tuple(arr.shape)}"
        )
    floating = (arr.is_floating_point() if isinstance(arr, torch.Tensor)
                else np.issubdtype(np.dtype(arr.dtype), np.floating))
    if not floating:
        raise TypeError(f"{name}: expected floating coordinates, got {arr.dtype}")
    return arr


def check_repr_layers(repr_layers: Sequence[int], num_layers: int):
    """Representation-layer indices must resolve within [0, num_layers]
    (negative indices count from the end, reference scripts/extract.py:84-85)."""
    for i in repr_layers:
        if not isinstance(i, (int, np.integer)):
            raise TypeError(f"repr_layers entry {i!r}: expected an int")
        if not -(num_layers + 1) <= i <= num_layers:
            raise ValueError(
                f"repr_layers entry {i} out of range "
                f"[-{num_layers + 1}, {num_layers}]"
            )
