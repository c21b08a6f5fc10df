"""The guard of the CUDA routes that have no backward (K6, K7, K8).

Those kernels write into buffers that autograd does not see, so an output
computed on the card would carry no gradient back to its inputs. Rather than
drop the gradient silently, the CUDA route raises when autograd would need
one; the CPU routes run the plain versions, which autograd differentiates.
"""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` naming ``kernel`` when grad mode is on and any
    of ``tensors`` (``None`` entries are skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input or weight requires grad; "
            f"call it under torch.no_grad() (inference), or run the plain version for training")
