"""Host-to-device copies that do not synchronize the host with the card."""

from __future__ import annotations

import numpy as np
import torch


def host_to_device(x, device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) on ``device``: on the card through
    pinned memory with a non-blocking copy, since a copy from pageable memory
    synchronizes the host with the card."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)
