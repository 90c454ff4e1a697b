"""Profiling: torch.profiler traces, spans and named annotations.

Counterpart of mesm_tpu/utils/profiling.py. The reference's only
instrumentation is four wall-clock AverageMeters (utils/meters.py, kept);
this adds traces of the host's ops and the card's kernels, written as
`<dir>/<host>_<pid>.<n>.pt.trace.json` (viewable in chrome://tracing or
Perfetto) and read by utils/trace_report.py.

Spans are named host time ranges at the boundaries of the eval and train
layers (one call, group, pass or step each: `eval.pass`, `data.stage_batch`,
`train.backward`, ...), recorded in memory while `recording()` is on and
otherwise one flag check each. They are stamped with time.time_ns(), the
clock torch.profiler dates host events by, so they can be laid over a
trace's device intervals; they are not profiler ranges, so a trace's host
ops are the same with spans on or off. maybe_trace records the spans of its
block and writes them beside the trace, as `<dir>/<host>_<pid>.<n>.spans.json`.

Enable with MESM_TPU_PROFILE_DIR=/path or profile_dir= in maybe_trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_ENV = "MESM_TPU_PROFILE_DIR"
# the prefix of the ranges that carry a module path (trace_report reads it)
MODULE_RANGE_PREFIX = "nn.Module: "
# The tracer drops the first kernel of a trace in some processes; and a
# kernel's record carries the card's clock, which the tracer maps onto the
# host's: where the two disagree (kernels dated up to 4.2 ms before their
# launch on an H100), a kernel launched in the first milliseconds of a
# trace is dated before the trace began, and dropped too.
# settle_device_trace opens a trace with a kernel of its own, inside a range
# of this name (trace_report leaves both out), then waits this long.
SETTLE_RANGE = "settle_device_trace"
DEVICE_CLOCK_GUARD_S = 0.05
TRACE_SUFFIX = ".pt.trace.json"
SPANS_SUFFIX = ".spans.json"


# -- spans --------------------------------------------------------------------

class SpanRecord:
    """One span: its name; start_ns and end_ns from time.time_ns() (end_ns
    0 while it is open); parent, the index in the records of the innermost
    span open on the same thread when it opened (-1 for none); thread, the
    opening thread's id; unit, the index of the span that opened its pass
    or step (-1 for none)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "unit")

    def __init__(self, name: str, start_ns: int, end_ns: int, parent: int, thread: int,
                 unit: int):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.thread, self.unit = parent, thread, unit

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    @classmethod
    def from_dict(cls, d: dict) -> "SpanRecord":
        return cls(*(d[k] for k in cls.__slots__))


_recording = False
_records: List[SpanRecord] = []
_generation = 0  # counts recordings: a stack entry left from an older one is no parent
_lock = threading.Lock()
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "unit", "record")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit

    def __enter__(self) -> SpanRecord:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = unit = -1
        if stack and stack[-1][0] == _generation:
            _, parent, unit = stack[-1]
        rec = self.record = SpanRecord(self.name, 0, 0, parent, threading.get_ident(), unit)
        with _lock:
            index = len(_records)
            _records.append(rec)
        if self.unit:
            rec.unit = index
        stack.append((_generation, index, rec.unit))
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        self.record.end_ns = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str, unit: bool = False):
    """A context manager around one call, group, pass or step of the host
    path. While recording() is on it appends a SpanRecord, closed on an
    exception too; `unit` opens a pass or step, whose spans inside carry its
    index. Off, it returns one shared object that does nothing."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, unit)


@contextlib.contextmanager
def recording():
    """Record the spans of the block (of every thread); yields the list of
    SpanRecords, in the order the spans opened. Recording inside a
    recording raises."""
    global _recording, _records, _generation
    with _lock:
        if _recording:
            raise RuntimeError("spans are already being recorded")
        _records = []
        _generation += 1
        _recording = True
        records = _records
    try:
        yield records
    finally:
        _recording = False


def _writer(profile_dir: str, records: List[SpanRecord]):
    """The trace's on_trace_ready: the trace, and the block's spans beside
    it under the same name."""

    def write(prof) -> None:
        os.makedirs(profile_dir, exist_ok=True)
        stem = os.path.join(profile_dir, f"{socket.gethostname()}_{os.getpid()}."
                                         f"{time.time_ns() // 1_000_000}")
        prof.export_chrome_trace(stem + TRACE_SUFFIX)
        with open(stem + SPANS_SUFFIX, "w") as f:
            json.dump({"clock": "time.time_ns", "spans": [r.as_dict() for r in records]}, f)

    return write


def settle_device_trace() -> None:
    """Call just after a torch.profiler trace starts, before what it is to
    record: one small kernel takes the trace's first record, the card
    drains, and the host waits DEVICE_CLOCK_GUARD_S, so that no kernel
    launched afterwards is dated before the trace's start. Nothing without
    CUDA."""
    if torch.cuda.is_available():
        with record_function(SETTLE_RANGE):
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        time.sleep(DEVICE_CLOCK_GUARD_S)


def _module_ranges(model: torch.nn.Module) -> list:
    """Forward pre/post hooks that open and close one record_function range
    per module call, named by the module's path from `model`
    ("MESM/transformer/encoder/layers/0"). Returns the hook handles."""
    root = type(model).__name__
    handles = []
    for name, module in model.named_modules():
        path = MODULE_RANGE_PREFIX + "/".join([root] + (name.split(".") if name else []))
        open_ranges: list = []

        def enter(mod, args, path=path, open_ranges=open_ranges):
            rf = record_function(path)
            rf.__enter__()
            open_ranges.append(rf)

        def leave(mod, args, out, open_ranges=open_ranges):
            if open_ranges:
                open_ranges.pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave, always_call=True))
    return handles


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str] = None, model: Optional[torch.nn.Module] = None):
    """Trace the enclosed block with torch.profiler when enabled: the host's
    ops, and the card's kernels and copies when CUDA is available. With
    `model`, each of its modules' forward calls is a range named by its
    path while the trace runs (the hooks are removed after it), so
    trace_report.module_totals can attribute each kernel to its module.
    The block's spans are recorded and written beside the trace
    (SPANS_SUFFIX). The block starts after settle_device_trace. Without a
    directory nothing is traced, recorded or installed."""
    profile_dir = profile_dir or os.environ.get(_ENV)
    if not profile_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handles = _module_ranges(model) if model is not None else []
    try:
        with recording() as records, profile(activities=activities,
                                             on_trace_ready=_writer(profile_dir, records)):
            settle_device_trace()
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()


def step_annotation(name: str):
    """A named range around one step on the trace's timeline."""
    return record_function(name)

