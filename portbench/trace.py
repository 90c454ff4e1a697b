"""The traced slice of a run: torch.profiler over whole passes or steps,
read in memory (nothing is written to disk) into the device's intervals.

The slice is the range `portbench.slice` on the host's timeline. It opens
after a settle kernel of the benchmark's own and a 50 ms wait: the tracer
has been seen to drop a trace's first kernel, and to date a kernel up to a
few ms before its launch, so nothing of the slice is launched in the
trace's first moments. Busy time is the union of the kernels' and copies'
intervals inside the slice, idle time the rest of its wall time; each idle
gap is labelled by the host operation open across its middle (the
outermost on the thread that called the slice), or `host` where none was.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SLICE = "portbench.slice"
SETTLE = "portbench.settle"


class TraceIncomplete(RuntimeError):
    """The profiler returned no device events, or fewer than were launched."""


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    if f is not None and f():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


@dataclass
class Slice:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds)
    copies: Dict[str, Tuple[int, float]]
    idle_gaps: List[Tuple[str, float]]
    result: object = None

    def kernel_time(self, names) -> Tuple[int, float]:
        n = t = 0
        for name, (c, s) in self.kernels.items():
            if any(k in name for k in names):
                n, t = n + c, t + s
        return n, t

    def launches(self) -> int:
        return sum(c for c, _ in self.kernels.values())

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        ops = {**{n: s for n, (_, s) in self.kernels.items()},
               **{n: s for n, (_, s) in self.copies.items()}}
        return sorted(ops.items(), key=lambda kv: -kv[1])[:k]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def traced(fn: Callable[[], object], top_gaps: int = 10) -> Slice:
    """Run fn() as the traced slice and read its device activity. Raises
    TraceIncomplete when the profiler saw no device event in it."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SETTLE):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function(SLICE):
            result = fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == SLICE]
    if not marks:
        raise TraceIncomplete("the slice's range is missing from the trace")
    s0, s1 = _ns(marks[0], "start"), _ns(marks[0], "end")
    tid = marks[0].start_thread_id()
    # a range opened on the host is mirrored on the device's timeline (a
    # user annotation, no work of the device's): left out
    annotations = {e.name() for e in events if _annotation(e)}
    dev, host = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _annotation(e) or e.name() in annotations:
                continue
            a, b = _ns(e, "start"), _ns(e, "end")
            if a >= s0 and b <= s1:
                dev.append((e.name(), a, b))
        elif e.start_thread_id() == tid and e.name() not in (SLICE, SETTLE):
            a, b = _ns(e, "start"), _ns(e, "end")
            if b > s0 and a < s1:
                host.append((e.name(), a, b))
    if not dev:
        raise TraceIncomplete("the profiler returned no device event in the slice")
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    copies: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in dev:
        bucket = copies if name.startswith(("Memcpy", "Memset")) else kernels
        bucket[name][0] += 1
        bucket[name][1] += (b - a) / 1e9
    busy = _union([(a, b) for _, a, b in dev])
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], s0
    for a, b in busy + [(s1, s1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    # the outermost host op across each gap's middle
    host.sort(key=lambda h: (h[1], -h[2]))
    outer, end = [], -1
    for h in host:
        if h[1] >= end:
            outer.append(h)
            end = h[2]
    labelled: Dict[str, float] = defaultdict(float)
    starts = [h[1] for h in outer]
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = outer[i][0] if i >= 0 and outer[i][2] >= mid else "host"
        labelled[label] += (b - a) / 1e9
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:top_gaps]
    return Slice(window_s=(s1 - s0) / 1e9, busy_s=busy_ns / 1e9,
                 kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
                 copies={k: (int(v[0]), v[1]) for k, v in copies.items()},
                 idle_gaps=idle, result=result)
