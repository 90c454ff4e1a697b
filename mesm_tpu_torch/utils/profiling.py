"""Profiling: torch.profiler traces and named annotations.

Counterpart of mesm_tpu/utils/profiling.py. The reference's only
instrumentation is four wall-clock AverageMeters (utils/meters.py, kept);
this adds traces of the host's ops and the card's kernels, written as
`<dir>/<host>_<pid>.<n>.pt.trace.json` (viewable in chrome://tracing or
Perfetto) and read by utils/trace_report.py.

Enable with MESM_TPU_PROFILE_DIR=/path or profile_dir= in maybe_trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

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
    The block starts after settle_device_trace. Without a directory nothing
    is traced and nothing is installed."""
    profile_dir = profile_dir or os.environ.get(_ENV)
    if not profile_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handles = _module_ranges(model) if model is not None else []
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
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


def annotate(name: str):
    return record_function(name)
