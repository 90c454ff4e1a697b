"""The eval driver: whole passes of the program's test-split evaluation,
`mesm_tpu_torch.evaluate.compute_mr_results` over the coalesced eval step,
as `python -m mesm_tpu_torch.evaluate` runs it with `--eval_coalesce -1`
and the text features cached.

Set-up: the data set from the mix and the seed, batched and collated by
the program's batcher and collate as its loader does (length-sorted where
it buckets), held in host memory; the model with the seed's weights; one
CUDA graph captured per length bucket (`warm_eval_step`, one shape at a
time, so the kernel counters give each shape's launches a replay); one
pass to warm the host path. The window: passes until the first pass end
after `seconds`; `eval_rows_per_s` is the rows returned as ranked,
post-processed windows over the window's time.

Each pass keeps one batch's device outputs (a clone made on the device
right after its call) and its rows of the submission (as one JSON string): drawn from the seed,
and in the first pass a batch of the longest bucket with the most rows.
After the window, the reference runs those batches from the same host
batches and weights and judges each kept batch: the foreground scores,
the spans and the saliency against the reference's, and the submission
rows against the reference's decode of those outputs.
"""
from __future__ import annotations

import gc
import json
import time

import numpy as np
import torch

from .. import checks, harness

# the kernel wrappers' launch counters the readers hold a trace against
COUNTERS = (("mesm_tpu_torch.ops.ln_dense", "launches"),
            ("mesm_tpu_torch.ops.attention_batched", "launches"))


def counters() -> dict:
    import importlib

    return {f"{m}:{a}": getattr(importlib.import_module(m), a) for m, a in COUNTERS}


def plan_calls(batches, K: int):
    """The batches of each call of the coalesced step, in order: runs of
    one shape, K at a time (the program pads a short group itself)."""
    calls, cur, sig = [], [], None
    for i, (b, _) in enumerate(batches):
        s = harness.host_signature(b)
        if cur and s != sig:
            calls.append(cur)
            cur = []
        cur.append(i)
        sig = s
        if len(cur) == K:
            calls.append(cur)
            cur = []
    if cur:
        calls.append(cur)
    return calls


class Tap:
    """The eval step as the pass sees it, keeping on the device a clone of
    one batch's outputs a pass. `fault` breaks the step's outputs for the
    check's own test: "stale" gives each call the outputs of the previous call
    of its shape (a step whose state never moves), "drop_half" gives each batch's second
    half of rows the first half's outputs (half of the batch left out),
    "alter_answer" moves every seventh score."""

    def __init__(self, step):
        self.step = step
        self.coalesce = getattr(step, "coalesce", 1)
        if hasattr(step, "static_inputs"):
            self.static_inputs = step.static_inputs
        self.target = None  # (call index, slot) of this pass
        self.kept = []
        self.n = 0
        self.fault = None
        self._prev = {}

    def start_pass(self, target):
        self.target, self.n = target, 0

    def _broken(self, out):
        if self.fault == "stale":  # the previous call of this shape's outputs
            key = tuple(tuple(v.shape) for v in out.values())
            prev = self._prev.get(key)
            self._prev[key] = {k: v.clone() for k, v in out.items()}
            return prev if prev is not None else out
        out = {k: v.clone() for k, v in out.items()}
        if self.fault == "drop_half":
            for v in out.values():
                half = v.shape[1 if self.coalesce > 1 else 0] // 2
                if self.coalesce > 1:
                    v[:, half: 2 * half] = v[:, :half]
                else:
                    v[half: 2 * half] = v[:half]
        elif self.fault == "alter_answer":
            out["scores"].view(-1)[::7] += 0.05
        return out

    def __call__(self, arg, *a, **kw):
        out = self.step(arg, *a, **kw)
        if self.fault is not None:
            out = self._broken(out)
        if self.target is not None and self.n == self.target[0]:
            j = self.target[1]
            self.kept.append({k: (v[j] if self.coalesce > 1 else v).clone() for k, v in out.items()})
        self.n += 1
        return out


def run(h: harness.Run) -> dict:
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.evaluate import compute_mr_results, warm_eval_step
    from mesm_tpu_torch.parallel.step import make_eval_step

    h.lap("imports")
    opt = h.options()
    device = torch.device(h.device)
    batches = harness.plan_eval(h, opt)
    h.lap("data")
    model = h.model(opt)
    dtype = R.compute_dtype_from_opt(opt)
    K = R.eval_coalesce_from_opt(opt, len(batches), device)
    step = make_eval_step(model, harness.encode_cached, dtype, coalesce=K)
    calls = plan_calls(batches, K)
    call_of = {b: (c, j) for c, idx in enumerate(calls) for j, b in enumerate(idx)}
    h.lap("model")
    per_shape = {}
    for i, (b, _) in enumerate(batches):
        sig = harness.host_signature(b)
        if sig in per_shape:
            continue
        before = counters()
        warm_eval_step(step, [batches[i]], opt, device)
        # a capture runs the step twice: once to warm, once recorded
        runs = 2 if device.type == "cuda" and K > 1 else 1
        per_shape[sig] = {k: (v - before[k]) / runs for k, v in counters().items()}
    tap = Tap(step)
    compute_mr_results(tap, batches, opt, device)  # the host path, warm
    if device.type == "cuda":
        torch.cuda.synchronize()
    h.lap("capture")
    setup_s = time.perf_counter() - h.t_start

    picks = harness.kept_batches(batches, h.seed)
    n_rows = [m["n_rows"] for _, m in batches]
    offsets = np.concatenate([[0], np.cumsum(n_rows)])
    tap.fault = h.fault
    kept_rows, kept_batch, pass_s = [], [], []
    rows_done, rows_missing, passes = 0, 0, 0

    def one_pass():
        nonlocal rows_done, rows_missing, passes
        tp = time.perf_counter()
        b = next(picks)
        tap.start_pass(call_of[b])
        sub = compute_mr_results(tap, batches, opt, device)
        rows_done += len(sub)
        rows_missing += int(offsets[-1]) - len(sub)
        # as one string: rows kept as objects would grow the heap the
        # program's garbage collections traverse, pass after pass
        kept_rows.append(json.dumps(sub[offsets[b]: offsets[b] + n_rows[b]]))
        kept_batch.append(b)
        passes += 1
        pass_s.append(time.perf_counter() - tp)

    slice_ = None
    t0 = time.perf_counter()
    if h.trace:
        one_pass()  # a steady slice: whole passes after the first
        from ..trace import traced

        def passes_for(seconds):
            p0 = passes
            ts = time.perf_counter()
            while passes == p0 or time.perf_counter() - ts < seconds:
                one_pass()
            return passes - p0

        slice_ = traced(lambda: passes_for(h.cell.get("trace_seconds", 2.0)))
    while passes == 0 or time.perf_counter() - t0 < h.seconds:
        one_pass()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    per_layer = {}
    if slice_ is not None:
        n_slice = slice_.result
        done = list(range(len(batches))) * n_slice
        replays = {}
        for idx in calls:
            sig = harness.host_signature(batches[idx[0]][0])
            replays[sig] = replays.get(sig, 0) + n_slice
        expected = {}
        for sig, n in replays.items():
            for k, v in per_shape[sig].items():
                expected[k] = expected.get(k, 0) + v * n
        ctx = checks.Context(cfg=h.cfg, slice=slice_, batches=[batches[i][0] for i in done],
                             expected_launches=expected,
                             peaks=harness.load("counts", "peaks"), dtype=str(dtype).split(".")[-1])
        per_layer = h.read_per_layer(ctx)

    kept = [{k: v.float().cpu().numpy() for k, v in o.items()} for o in tap.kept]
    del tap, step, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judged = checks.judge_eval(h, batches, kept_batch, kept, kept_rows, rows_missing, opt,
                               np.random.default_rng([h.seed, 4]))
    check_s = time.perf_counter() - t_check
    result = {"correct": judged.correct, "attempted": rows_done,
              "failed": rows_missing + judged.failed}
    if h.trace:
        result["metrics"] = per_layer
    else:
        result["metrics"] = {"eval_rows_per_s": {"value": rows_done / window_s, "unit": "rows/s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    result["extra"] = {"passes": passes, "window_s": window_s, "batches": len(batches), "K": K,
                       "calls": len(calls), "setup_split": h.setup_split,
                       "pass_s": [round(x, 4) for x in pass_s], "check_s": check_s}
    if slice_ is not None:
        result["device_trace"] = slice_
    result["memory_peak_bytes"] = peak
    return result, judged.checks
