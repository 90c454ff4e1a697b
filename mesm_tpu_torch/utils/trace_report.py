"""Read a torch.profiler trace into per-kernel and per-module time tables.

Counterpart of mesm_tpu/utils/trace_report.py, which reads the TPU plane's
"XLA Ops" line of a jax.profiler trace. Here the device's compute is the
trace's CUDA kernel events; the copies and fills (`gpu_memcpy`,
`gpu_memset`) are left out by default, as the JAX report leaves out its
"Async XLA Ops" line. A trace with no kernel events (a run on the CPU)
reads the host's top-level ops on each thread in their place.

A kernel event carries no module path (the JAX report reads XLA's `tf_op`).
It is attributed through the trace's correlation id to the runtime call
that launched it (or, where the tracer saw no such call, through its
external id to the op or range open at the launch), and that to the
innermost module range around it on its thread: the ranges utils/profiling.maybe_trace(model=...) opens for each
module's forward. Kernels launched by the autograd engine outside any
module range are "<backward>", any others "<unattributed>".

The spans maybe_trace writes beside a trace (`*.spans.json`, on the same
clock) read as each span name's self time (its time less its child spans')
and, where the trace holds the card's kernels, as the card's idle time by
the span innermost on the host when it was idle.

    python -m mesm_tpu_torch.utils.trace_report <trace_dir> [--top 30]
        [--by-module [--depth 3]] [--memory] [--spans]

reads the newest `*.pt.trace.json` under <trace_dir>.
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .profiling import (MODULE_RANGE_PREFIX, SETTLE_RANGE, SPANS_SUFFIX, TRACE_SUFFIX,
                        SpanRecord)

KERNEL_CATS = ("kernel",)
MEMORY_CATS = ("gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the runtime and driver calls that launch exactly one kernel
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                   "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel")
BACKWARD_PREFIX = "autograd::engine::evaluate_function"


def _newest_trace(trace_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    return paths[-1]


def _read_trace(trace_dir: str) -> Tuple[list, int]:
    """The newest trace's complete events (settle_device_trace's left out)
    and the time.time_ns() its `ts` (microseconds) count from."""
    with open(_newest_trace(trace_dir)) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    return _without_settle(events), int(trace.get("baseTimeNanoseconds", 0))


def _load_trace(trace_dir: str) -> list:
    return _read_trace(trace_dir)[0]


def _without_settle(events: list) -> list:
    """The events without profiling.settle_device_trace's range, the calls
    made inside it and their device records."""
    settles = [e for e in events if e.get("name") == SETTLE_RANGE]
    if not settles:
        return events

    def inside(e):
        return any(r["pid"] == e["pid"] and r["tid"] == e["tid"]
                   and r["ts"] <= e["ts"] <= r["ts"] + r["dur"] for r in settles)

    host = [e for e in events if e.get("cat") in LAUNCH_CATS + ("cpu_op",) and inside(e)]
    ids = {e["args"]["correlation"] for e in host if "correlation" in e.get("args", {})}
    skip = {id(e) for e in settles + host}
    return [e for e in events if id(e) not in skip
            and not (e.get("cat") in KERNEL_CATS + MEMORY_CATS
                     and e.get("args", {}).get("correlation") in ids)]


def _top_level(ops: list) -> list:
    """The ops of `ops` that no other op of the same thread encloses."""
    out = []
    by_thread = defaultdict(list)
    for e in ops:
        by_thread[(e["pid"], e["tid"])].append(e)
    for evs in by_thread.values():
        end = -1.0
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def _device_events(events: list, memory: bool) -> Tuple[list, str]:
    cats = KERNEL_CATS + (MEMORY_CATS if memory else ())
    dev = [e for e in events if e.get("cat") in cats]
    if any(e.get("cat") in KERNEL_CATS for e in events):
        return dev, "GPU kernels" + ("" if memory else " (memcpy / memset excluded)")
    return _top_level([e for e in events if e.get("cat") == "cpu_op"]), "CPU ops (top level)"


def device_op_totals(trace_dir: str, memory: bool = False
                     ) -> Tuple[Dict[str, float], Dict[str, int], float, str]:
    """Per-name durations (ms) of the device's compute: (name -> total_ms,
    name -> count, total_ms, what was read)."""
    evs, what = _device_events(_load_trace(trace_dir), memory)
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for e in evs:
        totals[e["name"]] += e["dur"] / 1e3
        counts[e["name"]] += 1
    return dict(totals), dict(counts), sum(totals.values()), what


def dropped_launches(trace_dir: str) -> int:
    """The kernel launches in the trace whose kernel has no record of its
    own (joined by correlation id): kernels the tracer dropped (see
    profiling.settle_device_trace). 0 for a trace with no launches."""
    events = _load_trace(trace_dir)
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in KERNEL_CATS}
    return sum(1 for e in events if e.get("cat") in LAUNCH_CATS and e["name"] in KERNEL_LAUNCHES
               and e.get("args", {}).get("correlation") not in recorded)


def report(trace_dir: str, top: int = 30, memory: bool = False) -> str:
    totals, counts, total_ms, what = device_op_totals(trace_dir, memory)
    lines = [
        f"device: {what}",
        f"busy {total_ms:.3f} ms over {sum(counts.values())} launches",
        f"{'op':58s} {'ms':>9s} {'%':>6s} {'n':>6s}",
    ]
    for name, ms in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(
            f"{name[:58]:58s} {ms:9.3f} {100 * ms / max(total_ms, 1e-9):6.2f} {counts[name]:6d}"
        )
    return "\n".join(lines)


def _label(stack: list, depth: int) -> str:
    for name in reversed(stack):
        if name.startswith(MODULE_RANGE_PREFIX):
            parts = name[len(MODULE_RANGE_PREFIX):].split("/")
            return "/".join(parts[:depth])
    if any(name.startswith(BACKWARD_PREFIX) for name in stack):
        return "<backward>"
    return "<unattributed>"


def _labels_at(ranges: list, points: list, depth: int) -> Dict[int, str]:
    """For each (ts, key) of `points`, the label of the ranges around it
    (one thread's ranges, properly nested)."""
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    stack: List[Tuple[float, str]] = []
    out, i = {}, 0
    for ts, key in sorted(points):
        while i < len(ranges) and ranges[i]["ts"] <= ts:
            r = ranges[i]
            while stack and stack[-1][0] < r["ts"]:
                stack.pop()
            stack.append((r["ts"] + r["dur"], r["name"]))
            i += 1
        while stack and stack[-1][0] < ts:
            stack.pop()
        out[key] = _label([name for _, name in stack], depth)
    return out


def _attributed(trace_dir: str, depth: int, memory: bool) -> List[Tuple[dict, str]]:
    """Each device event with the module path (or "<backward>",
    "<unattributed>") of the ranges around the call that launched it."""
    events = _load_trace(trace_dir)
    dev, _ = _device_events(events, memory)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ranges = defaultdict(list)
    by_external = {}
    for e in events:
        if e.get("cat") in ("user_annotation", "cpu_op"):
            ranges[(e["pid"], e["tid"])].append(e)
            by_external.setdefault(e.get("args", {}).get("External id"), e)
    points = defaultdict(list)  # thread -> [(ts, index of the device event)]
    for idx, e in enumerate(dev):
        args = e.get("args", {})
        # the launching call, else (a runtime the tracer did not see) the op
        # or range that was open at the launch
        src: Optional[dict] = e if e.get("cat") == "cpu_op" else (
            launches.get(args.get("correlation")) or by_external.get(args.get("External id")))
        if src is not None:
            points[(src["pid"], src["tid"])].append((src["ts"], idx))
    labels: Dict[int, str] = {}
    for thread, pts in points.items():
        labels.update(_labels_at(ranges[thread], pts, depth))
    return [(e, labels.get(idx, "<unattributed>")) for idx, e in enumerate(dev)]


def module_totals(trace_dir: str, depth: int = 3, memory: bool = False
                  ) -> Tuple[Dict[str, float], float]:
    """Device time by module path, truncated to `depth` segments (e.g.
    "MESM/transformer/encoder"): (path -> total_ms, total_ms)."""
    totals: Dict[str, float] = defaultdict(float)
    for e, label in _attributed(trace_dir, depth, memory):
        totals[label] += e["dur"] / 1e3
    return dict(totals), sum(totals.values())


def kernel_modules(trace_dir: str, depth: int = 3, memory: bool = False
                   ) -> Dict[str, Dict[str, int]]:
    """For each device op name, its launches by module path."""
    out: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for e, label in _attributed(trace_dir, depth, memory):
        out[e["name"]][label] += 1
    return {name: dict(mods) for name, mods in out.items()}


def module_report(trace_dir: str, depth: int = 3, memory: bool = False) -> str:
    totals, total = module_totals(trace_dir, depth, memory)
    lines = [
        f"busy {total:.3f} ms by module path (depth {depth})",
        f"{'module':58s} {'ms':>9s} {'%':>6s}",
    ]
    for name, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        if ms < total * 0.002:
            continue
        lines.append(f"{name[:58]:58s} {ms:9.3f} {100 * ms / max(total, 1e-9):6.2f}")
    return "\n".join(lines)


# -- spans ----------------------------------------------------------------------


def load_spans(trace_dir: str) -> List[SpanRecord]:
    """The spans written beside the newest trace under `trace_dir`."""
    path = _newest_trace(trace_dir)[:-len(TRACE_SUFFIX)] + SPANS_SUFFIX
    with open(path) as f:
        return [SpanRecord.from_dict(d) for d in json.load(f)["spans"]]


def innermost_pieces(records, thread: int) -> List[Tuple[int, int, str]]:
    """One thread's timeline cut at its closed spans' edges: (start_ns,
    end_ns, name of the innermost span open over it), in order; time under
    no span has no piece. A thread's spans nest, so each piece is a part of
    one span's self time."""
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # the open spans: (end_ns, name)
    cur = 0
    for r in sorted((r for r in records if r.thread == thread and r.end_ns),
                    key=lambda r: (r.start_ns, -r.end_ns)):
        while stack and stack[-1][0] <= r.start_ns:
            end, name = stack.pop()
            pieces.append((cur, end, name))
            cur = end
        if stack:
            pieces.append((cur, r.start_ns, stack[-1][1]))
        cur = r.start_ns
        stack.append((r.end_ns, r.name))
    while stack:
        end, name = stack.pop()
        pieces.append((cur, end, name))
        cur = end
    return [p for p in pieces if p[1] > p[0]]


def span_self_times(records) -> Dict[str, Tuple[int, float]]:
    """Each span name's closed spans: (count, self seconds), a span's self
    time being its duration less the part its child spans cover."""
    counts: Dict[str, int] = defaultdict(int)
    secs: Dict[str, float] = defaultdict(float)
    for r in records:
        if r.end_ns:
            counts[r.name] += 1
    for thread in {r.thread for r in records}:
        for a, b, name in innermost_pieces(records, thread):
            secs[name] += (b - a) / 1e9
    return {name: (n, secs[name]) for name, n in counts.items()}


def idle_by_span(records, busy: List[Tuple[int, int]], start_ns: int, end_ns: int,
                 thread: int) -> Dict[str, float]:
    """The device's idle seconds in [start_ns, end_ns] (the window less the
    union of the `busy` intervals, in ns) by the span innermost on `thread`
    across them; "none" for idle time under no span."""
    pieces = innermost_pieces(records, thread)
    out: Dict[str, float] = defaultdict(float)
    i, prev = 0, start_ns
    for a, b in _union(busy) + [(end_ns, end_ns)]:
        lo, hi = prev, min(a, end_ns)
        prev = max(prev, b)
        if hi <= lo:
            continue
        while i < len(pieces) and pieces[i][1] <= lo:
            i += 1
        covered, j = 0, i
        while j < len(pieces) and pieces[j][0] < hi:
            part = min(hi, pieces[j][1]) - max(lo, pieces[j][0])
            if part > 0:
                out[pieces[j][2]] += part / 1e9
                covered += part
            j += 1
        if hi - lo > covered:
            out["none"] += (hi - lo - covered) / 1e9
    return dict(out)


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_busy(trace_dir: str) -> List[Tuple[int, int]]:
    """The union of the newest trace's kernel, copy and fill intervals, in
    time.time_ns() (the spans' clock); empty for a trace without them."""
    events, base = _read_trace(trace_dir)
    return _union((base + round(e["ts"] * 1000), base + round((e["ts"] + e["dur"]) * 1000))
                  for e in events if e.get("cat") in KERNEL_CATS + MEMORY_CATS)


def span_report(trace_dir: str) -> str:
    """Self time by span name, and where the trace holds the card's work,
    its idle time by the innermost span of the thread that opened the first
    span, over that thread's first span start to last span end."""
    records = [r for r in load_spans(trace_dir) if r.end_ns]
    if not records:
        return "spans: none recorded"
    lines = [f"{'span':30s} {'n':>6s} {'self ms':>10s} {'ms each':>9s}"]
    for name, (n, s) in sorted(span_self_times(records).items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name[:30]:30s} {n:6d} {1e3 * s:10.3f} {1e3 * s / n:9.3f}")
    busy = device_busy(trace_dir)
    if busy:
        thread = records[0].thread
        mine = [r for r in records if r.thread == thread]
        s0, s1 = min(r.start_ns for r in mine), max(r.end_ns for r in mine)
        idle = idle_by_span(records, busy, s0, s1, thread)
        window = (s1 - s0) / 1e9
        lines += [f"device idle {1e3 * sum(idle.values()):.3f} ms of {1e3 * window:.3f} ms "
                  f"by innermost span", f"{'span':30s} {'idle ms':>10s} {'% of window':>12s}"]
        for name, s in sorted(idle.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name[:30]:30s} {1e3 * s:10.3f} {100 * s / window:12.2f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--by-module", action="store_true")
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--memory", action="store_true",
                    help="count the card's copies and fills beside its kernels")
    ap.add_argument("--spans", action="store_true",
                    help="self time by span, and the card's idle time by innermost span")
    args = ap.parse_args(argv)
    if args.spans:
        print(span_report(args.trace_dir))
    elif args.by_module:
        print(module_report(args.trace_dir, args.depth, args.memory))
    else:
        print(report(args.trace_dir, args.top, args.memory))


if __name__ == "__main__":
    main()
