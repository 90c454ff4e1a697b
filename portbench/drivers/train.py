"""The train driver: the program's training epoch loop,
`mesm_tpu_torch.train.train_epoch`, over the step of
`parallel/step.make_train_step` (forward with the negatives, matcher,
every loss term, backward, the clip, AdamW), as the train entry point runs
it: each host batch staged, the step run, its metrics read back.

Set-up: the data set from the mix and the seed; the first `batches`
batches of the program's group-aware batcher (shuffled by the seed) at the
mix's row capacity, collated and held in host memory; the model with the
seed's weights, AdamW and the step. Set-up drives that one step object
through steps 1-3 on batches 1-3 (which warms every shape), keeping the
weights before, AdamW's first moment after step 1 and the weights after
step 3. The window hands the same object on: steps over the batches in
turn until the first step end after `seconds`; `train_step_ms` is the
window's time over the steps it completed. After the window the same
object takes three more steps on the next batches from the state the
window left (its weights and AdamW's moments kept before them), so that a
step that changes after warm-up is compared too.

Then the reference takes steps 1-3 from the seed's weights, and the three
steps after the window from the program's state at the window's end, with
the same batches and draws, and the check compares both (checks.py).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import checks, harness

# the kernel wrappers' launch counters the readers hold a trace against
COUNTERS = (("mesm_tpu_torch.ops.attention_batched", "launches"),
            ("mesm_tpu_torch.ops.attention_backward", "backward_launches"))
CHECK_STEPS = 3


def counters() -> dict:
    import importlib

    return {f"{m}:{a}": getattr(importlib.import_module(m), a) for m, a in COUNTERS}


class Recorder:
    """The step as train_epoch calls it, keeping each of the first steps'
    total loss and, after the first, AdamW's first moment. `fault` breaks
    the step for the check's own test: "stale" skips the update (the state
    stays as it was), "late_stale" does so only after the set-up's steps (a
    step that changes after warm-up), "drop_half" trains on the first half
    of the rows alone."""

    def __init__(self, step, optimizer, fault=None):
        self.step, self.optimizer, self.fault = step, optimizer, fault
        self.losses, self.first_moment = [], None
        self.end_losses = None  # a list while the steps after the window run

    def __call__(self, jb, step, *a, **kw):
        if self.fault == "drop_half":
            jb = dict(jb)
            rm = jb["row_mask"].clone()
            rm[rm.shape[0] // 2:] = False
            jb["row_mask"] = rm
        stale = self.fault == "stale" or (self.fault == "late_stale"
                                          and len(self.losses) >= CHECK_STEPS)
        if stale:
            saved = [p.detach().clone() for g in self.optimizer.param_groups for p in g["params"]]
        metrics = self.step(jb, step, *a, **kw)
        if stale:
            with torch.no_grad():
                for p, s in zip((p for g in self.optimizer.param_groups for p in g["params"]), saved):
                    p.copy_(s)
        if self.end_losses is not None:
            self.end_losses.append(metrics["loss_overall"].detach().clone())
        elif len(self.losses) < CHECK_STEPS:
            self.losses.append(metrics["loss_overall"].detach().clone())
            if len(self.losses) == 1:
                self.first_moment = {id(p): self.optimizer.state[p]["exp_avg"].clone()
                                     for g in self.optimizer.param_groups for p in g["params"]}
        return metrics


class WindowFeed:
    """The host batches in turn until the first step end after `seconds`:
    train_epoch asks for the next batch only once the step before has read
    its metrics back."""

    def __init__(self, batches, seconds, first):
        self.batches, self.seconds, self.first = batches, seconds, first
        self.steps, self.t0, self.t1, self.marks = 0, None, None, []

    def __iter__(self):
        self.t0 = time.perf_counter()
        i = self.first
        while self.steps == 0 or time.perf_counter() - self.t0 < self.seconds:
            yield self.batches[i % len(self.batches)]
            self.steps += 1
            self.marks.append(time.perf_counter())
            i += 1
        self.t1 = time.perf_counter()


def run(h: harness.Run):
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.parallel.step import make_train_step
    from mesm_tpu_torch.train import train_epoch

    h.lap("imports")
    opt = h.options()
    device = torch.device(h.device)
    batches = harness.plan_train(h, opt, int(h.mix["batches"]))
    h.lap("data")
    model = h.model(opt)
    optimizer = R.build_optimizer(opt, model)
    step = make_train_step(model, R.build_criterion_config(opt), harness.encode_cached, optimizer,
                           opt.grad_clip, seed=h.seed,
                           compute_dtype=R.compute_dtype_from_opt(opt))
    names = {id(p): n for n, p in model.named_parameters()}
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    rec = Recorder(step, optimizer, h.fault)
    h.lap("model")
    n_step, _ = train_epoch(rec, batches[:CHECK_STEPS], opt, 0, 0, device)
    p3 = {n: p.detach().clone() for n, p in model.named_parameters()}
    h.lap("first_steps")
    setup_s = time.perf_counter() - h.t_start

    feed = WindowFeed(batches, h.seconds, CHECK_STEPS)
    slice_, per_layer = None, {}
    if h.trace:
        from ..trace import traced

        slice_feed = WindowFeed(batches, h.cell.get("trace_seconds", 2.0), CHECK_STEPS)
        before = counters()
        slice_ = traced(lambda: train_epoch(rec, slice_feed, opt, 1, n_step, device)[0])
        n_step = slice_.result
        expected = {k: v - before[k] for k, v in counters().items()}
        ctx = checks.Context(cfg=h.cfg, slice=slice_,
                             batches=[batches[(CHECK_STEPS + i) % len(batches)][0]
                                      for i in range(slice_feed.steps)],
                             steps=slice_feed.steps, expected_launches=expected,
                             peaks=harness.load("counts", "peaks"), dtype="float32")
        per_layer = h.read_per_layer(ctx)
    n_step, _ = train_epoch(rec, feed, opt, 2, n_step, device)
    window_s = feed.t1 - feed.t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the end: three more steps from the state the window left
    end_state = adam_snapshot(model, optimizer)
    end_first = n_step
    end_batches = [batches[(CHECK_STEPS + feed.steps + i) % len(batches)]
                   for i in range(CHECK_STEPS)]
    rec.end_losses = []
    n_step, _ = train_epoch(rec, end_batches, opt, 3, n_step, device)
    end_after = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(v) for v in rec.losses]
    end_losses = [float(v) for v in rec.end_losses]
    g1 = {names[i]: m / 0.1 for i, m in rec.first_moment.items()}  # (1 - beta1) g
    del rec, step, optimizer, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    values, failed, look = reference_gaps(h, opt, batches, losses, g1, p0, p3)
    end_values, end_failed, end_look = end_gaps(h, opt, end_batches, end_first, end_state,
                                                end_losses, end_after)
    values.update(end_values)
    look.update(end_look)
    failed += end_failed
    look["check_s"] = time.perf_counter() - t_check
    judged = checks.judge_train(h, values, failed)
    result = {"correct": judged.correct, "attempted": feed.steps + 2 * CHECK_STEPS,
              "failed": failed}
    if h.trace:
        result["metrics"] = per_layer
    else:
        result["metrics"] = {"train_step_ms": {"value": 1000.0 * window_s / feed.steps,
                                               "unit": "ms/step"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    ms = 1000 * np.diff([feed.t0] + feed.marks)
    result["extra"] = {"steps": feed.steps, "window_s": window_s, "losses": losses,
                       "end_losses": end_losses,
                       "step_ms_quartiles": np.percentile(ms, [0, 25, 50, 75, 100]).round(2).tolist(),
                       "setup_split": h.setup_split, "check_look": look,
                       "rows": [int(np.asarray(b["row_mask"]).sum()) for b, _ in batches]}
    if slice_ is not None:
        result["device_trace"] = slice_
    result["memory_peak_bytes"] = peak
    return result, judged.checks


def reference_gaps(h, opt, batches, losses, g1, p0, p3, tf32: bool = False):
    """The reference's first three steps against the program's readings:
    ({loss1_gap, grad1_gap, change3_gap}, steps with a non-finite loss,
    what the look at them needs: every step's loss gap, the worst leaves,
    the worst leaf's change gap)."""
    from ..reference.train import train_steps

    checks.reference_precision(tf32)
    ref = h.reference_model()
    staged = [checks._stage(b, h.device) for b, _ in batches[:CHECK_STEPS]]
    ref_losses, ref_g1 = train_steps(ref, staged, h.cfg, h.seed, opt.lr,
                                     opt.weight_decay, opt.grad_clip)
    ref_p3 = {n: p.detach() for n, p in ref.named_parameters()}
    checks.reference_precision(False)
    med = float(np.median([float(g.double().norm()) for g in ref_g1.values()]))
    keep = [n for n, g in ref_g1.items() if float(g.double().norm()) >= 1e-3 * med]
    change_p = {n: p3[n] - p0[n] for n in keep}
    change_r = {n: ref_p3[n] - p0[n] for n in keep}
    failed = sum(1 for v in losses if not np.isfinite(v))
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad1 = checks.leaf_gaps(g1, ref_g1, keep)
    change3 = checks.leaf_gaps(change_p, change_r, keep)
    worst_g, worst_c = max(grad1, key=grad1.get), max(change3, key=change3.get)
    values = {"loss1_gap": step_gaps[0], "grad1_gap": grad1[worst_g],
              "change3_gap": float(np.median(list(change3.values())))}
    look = {"loss_gap_steps": step_gaps, "leaves_left_out": len(ref_g1) - len(keep),
            "worst_grad1_leaf": worst_g, "worst_change3_leaf": worst_c,
            "worst_change3_gap": change3[worst_c]}
    return values, failed, look


def adam_snapshot(model, optimizer):
    """(weights, AdamW's first and second moments, its count of updates):
    the program's state, by parameter name."""
    state = {}
    for n, p in model.named_parameters():
        st = optimizer.state[p]  # empty for a parameter that never had a gradient
        state[n] = (p.detach().clone(), st.get("exp_avg", torch.zeros_like(p)).clone(),
                    st.get("exp_avg_sq", torch.zeros_like(p)).clone())
    counts = {int(st["step"]) for st in optimizer.state.values() if "step" in st}
    assert len(counts) == 1, counts
    return state, counts.pop()


def end_gaps(h, opt, batches, first_step: int, snapshot, losses, after, tf32: bool = False):
    """The reference's steps after the window, from the program's state at
    the window's end (`snapshot`), against the program's: ({loss_end_gap,
    change_end_gap}, steps with a non-finite loss, the look). The numbers
    are those of steps 1-3: the first step's relative loss gap and the
    median leaf's gap of the change over the steps."""
    from ..reference.train import train_steps

    weights, count = snapshot
    checks.reference_precision(tf32)
    ref = h.reference_model()
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(weights[n][0])
    moments = {n: (m.clone(), v.clone()) for n, (_, m, v) in weights.items()}
    staged = [checks._stage(b, h.device) for b, _ in batches]
    ref_losses, ref_g = train_steps(ref, staged, h.cfg, h.seed, opt.lr, opt.weight_decay,
                                    opt.grad_clip, first_step=first_step, state=moments,
                                    adam_steps=count)
    checks.reference_precision(False)
    med = float(np.median([float(g.double().norm()) for g in ref_g.values()]))
    keep = [n for n, g in ref_g.items() if float(g.double().norm()) >= 1e-3 * med]
    ref_after = dict(ref.named_parameters())
    change_p = {n: after[n] - weights[n][0] for n in keep}
    change_r = {n: ref_after[n].detach() - weights[n][0] for n in keep}
    change = checks.leaf_gaps(change_p, change_r, keep)
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    worst = max(change, key=change.get)
    values = {"loss_end_gap": step_gaps[0], "change_end_gap": float(np.median(list(change.values())))}
    look = {"end_first_step": first_step, "end_loss_gap_steps": step_gaps,
            "end_leaves_left_out": len(ref_g) - len(keep), "worst_change_end_leaf": worst,
            "worst_change_end_gap": change[worst]}
    return values, sum(1 for v in losses if not np.isfinite(v)), look
