"""Seeded weights, drawn on the device in a few large calls.

A layout is a list of entries ``(name, shape, dist, scale)``:
  * ``uniform``: U(-1, 1) times ``scale``;
  * ``normal``: N(0, 1) times ``scale``;
  * ``const``: every element ``scale``;
  * ``inv_freq``: the rotary frequencies 1/10000^(2i/d) of a head of width 2·shape[0];
  * ``tie``: the same tensor as the entry named ``scale``.
All uniform entries are views of one buffer filled by one call, and so are
the normal ones, each entry then scaled in place. The same (layout, seed)
gives the same numbers on the same device: the program's weights and, once
its state is freed, the reference's are drawn alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Entry = Tuple[str, Tuple[int, ...], str, object]


def draw(layout: Sequence[Entry], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out: Dict[str, torch.Tensor] = {}
    for dist in ("uniform", "normal"):
        entries = [e for e in layout if e[2] == dist]
        total = sum(math.prod(e[1]) for e in entries)
        buf = torch.empty(total, device=device)
        if dist == "uniform":
            buf.uniform_(-1.0, 1.0, generator=gen)
        else:
            buf.normal_(generator=gen)
        at = 0
        for name, shape, _, scale in entries:
            n = math.prod(shape)
            out[name] = buf[at:at + n].view(shape).mul_(scale)
            at += n
    for name, shape, dist, scale in layout:
        if dist == "const":
            out[name] = torch.full(shape, float(scale), device=device)
        elif dist == "inv_freq":
            d = 2 * shape[0]
            out[name] = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                        device=device) / d))
    for name, _, dist, target in layout:
        if dist == "tie":
            out[name] = out[target]
    return {name: out[name] for name, *_ in layout}


def linear(name: str, fan_in: int, fan_out: int, weight: Tuple[str, float],
           bias: Tuple[str, float] = None) -> List[Entry]:
    """A Linear's entries: (out, in) weight and, unless ``bias`` is None, its bias."""
    out = [(f"{name}.weight", (fan_out, fan_in), *weight)]
    if bias is not None:
        out.append((f"{name}.bias", (fan_out,), *bias))
    return out


def layer_norm(name: str, dim: int, bias: Tuple[str, float] = ("const", 0.0)) -> List[Entry]:
    return [(f"{name}.weight", (dim,), "const", 1.0), (f"{name}.bias", (dim,), *bias)]
