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
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

_ENV = "MESM_TPU_PROFILE_DIR"
# the prefix of the ranges that carry a module path (trace_report reads it)
MODULE_RANGE_PREFIX = "nn.Module: "


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
    Without a directory nothing is traced and nothing is installed."""
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
