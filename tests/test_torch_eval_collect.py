"""The eval pass's hold on the garbage collector
(`evaluate._collections_at_pass_end`): the submission rows are the same with
it and without it on charades and TACoS synthetic data, the collector is on
again after a pass and after one that raises (and stays off where it was
off), no automatic collection runs inside a pass, and the one collection of
the youngest generation at its end is counted (`pass_collections`) and
spanned (`eval.collect`)."""
from __future__ import annotations

import contextlib
import copy
import gc

import pytest
import torch

from mesm_tpu_torch import evaluate
from mesm_tpu_torch.evaluate import compute_mr_results
from mesm_tpu_torch.parallel.step import make_eval_step
from mesm_tpu_torch.utils.profiling import recording
from portbench import harness
from portbench.tests import tiny

OPTIONS = {"charades-eval": {"eval_coalesce": 2, "eval_batch_size": 3, "eval_len_buckets": 2},
           "tacos-eval": {"eval_coalesce": 2, "eval_len_buckets": 1}}


def _pass_inputs(cell: str, seed: int = 3000000007):
    ov = copy.deepcopy(tiny.OVERRIDES[cell])
    ov["config"] = dict(tiny.TINY_CONFIG)
    ov["traffic"]["options"] = OPTIONS[cell]
    h = harness.Run(cell, seed, 1.0, False, device="cpu", overrides=ov)
    opt = h.options()
    batches = harness.plan_eval(h, opt)
    step = make_eval_step(h.model(opt), harness.encode_cached, torch.float32,
                          coalesce=OPTIONS[cell]["eval_coalesce"])
    return step, batches, opt


@pytest.fixture(autouse=True)
def collector_on():
    was = gc.isenabled()
    gc.enable()
    yield
    (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("cell", ["charades-eval", "tacos-eval"])
def test_rows_equal_without_the_hold(cell, monkeypatch):
    step, batches, opt = _pass_inputs(cell)
    with torch.no_grad():
        held = compute_mr_results(step, batches, opt, "cpu")
        monkeypatch.setattr(evaluate, "_collections_at_pass_end", contextlib.nullcontext)
        plain = compute_mr_results(step, batches, opt, "cpu")
    assert len(held) == sum(m["n_rows"] for _, m in batches)
    assert held == plain


class _Watch:
    """The step, noting whether the collector was on at each call; raises at
    call `fail_at`."""

    def __init__(self, step, fail_at=None):
        self.step, self.coalesce, self.fail_at = step, step.coalesce, fail_at
        self.static_inputs = getattr(step, "static_inputs", None)
        self.seen = []

    def __call__(self, staged):
        self.seen.append(gc.isenabled())
        if len(self.seen) == self.fail_at:
            raise RuntimeError("step failed")
        return self.step(staged)


@pytest.mark.parametrize("on_entry", [True, False])
@pytest.mark.parametrize("fail_at", [None, 2])
def test_collector_state_restored(on_entry, fail_at):
    step, batches, opt = _pass_inputs("charades-eval")
    watch = _Watch(step, fail_at)
    threshold = gc.get_threshold()
    before = evaluate.pass_collections
    (gc.enable if on_entry else gc.disable)()
    with torch.no_grad(), (pytest.raises(RuntimeError, match="step failed") if fail_at
                           else contextlib.nullcontext()):
        compute_mr_results(watch, batches, opt, "cpu")
    assert gc.isenabled() == on_entry
    assert gc.get_threshold() == threshold
    assert watch.seen and not any(watch.seen)
    # the collection runs only at a pass's normal end, and only where the collector was on
    assert evaluate.pass_collections - before == (1 if on_entry and not fail_at else 0)


def test_one_young_collection_a_pass_counted_and_spanned():
    step, batches, opt = _pass_inputs("tacos-eval")
    events = []

    def note(phase, info):
        if phase == "start":
            events.append(info["generation"])

    before = evaluate.pass_collections
    gc.callbacks.append(note)
    try:
        with torch.no_grad(), recording() as recs:
            for _ in range(3):
                compute_mr_results(step, batches, opt, "cpu")
    finally:
        gc.callbacks.remove(note)
    assert evaluate.pass_collections - before == 3
    passes = [i for i, r in enumerate(recs) if r.name == "eval.pass"]
    collects = [r for r in recs if r.name == "eval.collect"]
    assert len(passes) == len(collects) == 3
    assert [r.parent for r in collects] == passes
    assert all(r.end_ns >= r.start_ns > 0 for r in collects)
    # between the passes the collector may run on its own; inside them only
    # the pass-end collection of generation 0
    inside = []

    def note_inside(phase, info):
        if phase == "start":
            inside.append((gc.isenabled(), info["generation"]))

    gc.callbacks.append(note_inside)
    try:
        with torch.no_grad():
            compute_mr_results(step, batches, opt, "cpu")
    finally:
        gc.callbacks.remove(note_inside)
    assert (False, 0) in inside
    assert all(gen == 0 for on, gen in inside if not on)
