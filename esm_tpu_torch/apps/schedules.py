"""Annealing schedules for MCMC design.

Port of esm_tpu/apps/schedules.py (reference examples/lm-design/utils/
scheduler.py:15-68; config default StepLR step_size=10000 gamma=0.5
initial=8, conf/config.yaml:19-39). The reference steps stateful torch
lr_scheduler wrappers once per iteration; here each schedule is a frozen
dataclass mapping the *global step index* to a Python float, so a chain
that resumes across free-generation rounds (utils/free_generation.py:66-72)
reads the same value the reference's shared scheduler state gives.

The chains never call a schedule inside their loop: :func:`schedule_values`
evaluates one at every step once, into an fp32 tensor on the chain's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import torch

from ..utils.device import host_to_device


@dataclass(frozen=True)
class ConstantSchedule:
    """A fixed value (reference scheduler.py ConstantSchedule)."""

    value: float

    def __call__(self, step: int) -> float:
        del step
        return float(self.value)


@dataclass(frozen=True)
class StepLR:
    """value = initial * gamma ** (step // step_size) — torch StepLR."""

    initial: float
    step_size: int
    gamma: float = 0.1

    def __call__(self, step: int) -> float:
        return self.initial * self.gamma ** (int(step) // self.step_size)


@dataclass(frozen=True)
class MultiStepLR:
    """value = initial * gamma ** (#milestones <= step) — torch MultiStepLR."""

    initial: float
    milestones: Tuple[int, ...]
    gamma: float = 0.1

    def __call__(self, step: int) -> float:
        return self.initial * self.gamma ** sum(int(step) >= m for m in self.milestones)


@dataclass(frozen=True)
class ExponentialLR:
    """value = initial * gamma ** step — torch ExponentialLR."""

    initial: float
    gamma: float

    def __call__(self, step: int) -> float:
        return self.initial * self.gamma ** int(step)


@dataclass(frozen=True)
class LinearLR:
    """Linear factor ramp start_factor -> end_factor over total_iters
    (constant end_factor after) — torch LinearLR."""

    initial: float
    start_factor: float = 1.0 / 3.0
    end_factor: float = 1.0
    total_iters: int = 5

    def __call__(self, step: int) -> float:
        frac = min(max(int(step) / max(self.total_iters, 1), 0.0), 1.0)
        return self.initial * (self.start_factor + (self.end_factor - self.start_factor) * frac)


@dataclass(frozen=True)
class CosineAnnealingLR:
    """eta_min + (initial - eta_min) * (1 + cos(pi * step / T_max)) / 2 —
    torch CosineAnnealingLR (no restarts)."""

    initial: float
    T_max: int
    eta_min: float = 0.0

    def __call__(self, step: int) -> float:
        cos = math.cos(math.pi * int(step) / max(self.T_max, 1))
        return self.eta_min + (self.initial - self.eta_min) * (1.0 + cos) / 2.0


Schedule = Union[
    ConstantSchedule, StepLR, MultiStepLR, ExponentialLR, LinearLR, CosineAnnealingLR
]
ScheduleSpec = Union[float, int, Dict, Schedule]

_SCHEDULE_CLASSES = {
    c.__name__: c
    for c in (StepLR, MultiStepLR, ExponentialLR, LinearLR, CosineAnnealingLR)
}


def to_schedule(spec: ScheduleSpec) -> Schedule:
    """Build a schedule from a config value (reference scheduler.to_scheduler):
    a number is constant; a dict names the scheduler like the reference YAML,
    e.g. ``{"scheduler": "StepLR", "initial": 8, "step_size": 10000,
    "gamma": 0.5}``; an existing schedule passes through."""
    if isinstance(spec, (int, float)):
        return ConstantSchedule(float(spec))
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("scheduler")
        cls = _SCHEDULE_CLASSES.get(name)
        if cls is None:
            raise ValueError(
                f"unknown scheduler {name!r}; known: {sorted(_SCHEDULE_CLASSES)}"
            )
        if "milestones" in kw:
            kw["milestones"] = tuple(kw["milestones"])
        return cls(**kw)
    if callable(spec):
        return spec
    raise TypeError(f"cannot build a schedule from {spec!r}")


def schedule_values(spec: ScheduleSpec, steps: Sequence[int], device=None) -> torch.Tensor:
    """The schedule at each of ``steps``, as an fp32 tensor on ``device``
    (esm_tpu/apps/lm_design.py:271-280): built once, before a chain starts,
    with one host-to-device copy."""
    fn = to_schedule(spec)
    values = torch.tensor([fn(int(s)) for s in steps], dtype=torch.float32)
    return values if device is None else host_to_device(values, device)
