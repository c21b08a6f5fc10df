"""The traced run: torch.profiler over a steady stretch of the window, kept in
memory, and what the per-layer readers take from it.

Busy time is the union of the device events' intervals (as the port's
``chip_smoke.py`` ``profile()`` reads it), device time is summed by kernel
name and, for the operators that launched the kernels, by ``aten::``
operator; each idle gap of the device is named by what the host was doing
in its middle: the benchmark's own span (``bench.*``) and the innermost
host event there. Spans are ``record_function`` ranges the benchmark puts
around its calls into the program; off, they cost nothing.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


@dataclass
class TraceSummary:
    window_s: float                       # the traced stretch, by its span
    busy_s: float                         # union of device intervals inside it
    kernels: Dict[str, Tuple[float, int]]  # kernel name -> (device s, launches)
    ops: Dict[str, float]                 # aten:: operator -> self device s
    gaps: List[Tuple[str, float]]         # the longest idle gaps, named
    events: int                           # device events in the stretch
    items: int = 0                        # window items (batches, folds, steps) traced
    counters: Dict[str, int] = field(default_factory=dict)  # program counters' deltas

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of every kernel whose name holds one of ``parts``."""
        return sum(s for name, (s, _) in self.kernels.items() if any(p in name for p in parts))


class Tracer:
    """Holds the profiler of a ``--trace 1`` run; with ``enabled=False``
    every method is a no-op and :meth:`span` costs nothing."""

    WINDOW = "bench.window"

    def __init__(self, enabled: bool, device_type: str = "cuda"):
        self.enabled = enabled
        self.device_type = device_type
        self._prof = None
        self._window = None
        self.items = 0
        self.counters: Dict[str, int] = {}

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def begin(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(self.WINDOW)
        self._window.__enter__()

    def end(self) -> None:
        if self._prof is None or self._window is None:
            return
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._window = None
        self._prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self._window is not None

    def summary(self, top: int = 10) -> Optional[TraceSummary]:
        if self._prof is None:
            return None
        t0 = time.perf_counter()
        s = summarize(self._prof, top)
        s.items, s.counters = self.items, dict(self.counters)
        print(f"[trace] {s.events} device events, {len(self._prof.events())} events in all, "
              f"read in {time.perf_counter() - t0:.1f} s", flush=True)
        return s


def _is_device(e) -> bool:
    """A kernel, copy or set on the card; the benchmark's own spans also show
    on the device's timeline (as user annotations) and are not work."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")


def _is_host(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CPU


def summarize(prof, top: int = 10) -> TraceSummary:
    events = prof.events()
    window = [e for e in events if e.name == Tracer.WINDOW and _is_host(e)]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev = [e for e in events if _is_device(e) and e.time_range.end > w0 and e.time_range.start < w1]
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev)
    busy, end = 0.0, w0
    merged: List[Tuple[float, float]] = []
    for a, b in spans:
        if b <= end:
            continue
        a = max(a, end)
        busy += b - a
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
        end = b
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        kernels[e.name][0] += e.time_range.elapsed_us() / 1e6
        kernels[e.name][1] += 1
    ops = {}
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if us:
                ops[e.key] = us / 1e6
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
        kernels={k: (v[0], int(v[1])) for k, v in kernels.items()}, ops=ops,
        gaps=_gaps(events, merged, w0, w1, top), events=len(dev))


def _gaps(events, merged, w0, w1, top) -> List[Tuple[str, float]]:
    """The ``top`` longest idle stretches of the device inside the window,
    each named by the host's innermost event and enclosing bench span at
    its middle."""
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:top]
    host = [e for e in events if _is_host(e) and e.name != Tracer.WINDOW]
    out = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        over = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        spans = [e for e in over if e.name.startswith("bench.")]
        inner = min(over, key=lambda e: e.time_range.elapsed_us(), default=None)
        name = "/".join(x for x in (
            min(spans, key=lambda e: e.time_range.elapsed_us()).name if spans else "",
            inner.name if inner is not None and not inner.name.startswith("bench.") else "")
            if x) or "host idle"
        out.append((name, length / 1e6))
    return out


def untraced(window, items: int):
    """(items, seconds) of the window's items that ran after the traced
    stretch had closed, where the profiler's own cost does not slow the
    host; the whole window when no item ran untraced."""
    return window.info.get("untraced") or (items, window.seconds)


def breakdown(s: TraceSummary, top: int = 10) -> dict:
    ops = sorted(s.kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[name[:160], sec] for name, (sec, _) in ops],
            "idle_gaps": [[name, sec] for name, sec in s.gaps[:top]]}
