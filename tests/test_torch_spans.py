"""The port's spans (mesm_tpu_torch/utils/profiling.py: span, recording;
utils/trace_report.py: self time and the card's idle time by span) and the
spans placed in its eval and train loops, on the CPU: nothing recorded with
recording off, parents, threads, units and self time under nesting, the
clock against torch.profiler's, the spans of a coalesced and a per-batch
compute_mr_results and of a train_epoch, the file maybe_trace writes beside
its trace and `trace_report --spans` on it and on a card's trace written out
by hand."""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from mesm_tpu_torch.config import BaseOptions
from mesm_tpu_torch.evaluate import compute_mr_results
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.models.mesm import MESM, MESMConfig
from mesm_tpu_torch.parallel.step import build_optimizer, make_eval_step, make_train_step
from mesm_tpu_torch.train import train_epoch
from mesm_tpu_torch.utils import profiling, trace_report
from mesm_tpu_torch.utils.profiling import SpanRecord, recording, span

from test_torch_harness import TRAIN, train_batch

EVAL_OPT = types.SimpleNamespace(sort_results=True, clip_len=1, max_ts_val=100,
                                 compute_dtype="float32")
CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=4.0,
                 recfw_coef=0.1, recss_coef=0.1, cost_class=4.0, rank_coef=12.0)


@pytest.fixture(autouse=True)
def grad_mode_on():
    """train_epoch takes gradients; another module of the suite turns grad
    mode off for its whole process when it is imported."""
    with torch.enable_grad():
        yield


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def _model():
    torch.manual_seed(0)
    return MESM(MESMConfig(**TRAIN))


def _names(records):
    return [r.name for r in records]


def _count(records, name):
    return sum(1 for r in records if r.name == name)


def test_off_records_nothing_and_returns_one_object():
    before = profiling._records
    n = len(before)
    s = span("eval.pass", unit=True)
    assert s is span("data.stage_batch") is profiling._NO_SPAN
    with s as got:
        with span("eval.decode"):
            pass
    assert got is None
    assert profiling._records is before and len(before) == n


def test_nesting_threads_units_and_an_exception():
    with recording() as recs:
        with span("pass", unit=True):
            with span("stage"):
                pass
            with pytest.raises(ValueError):
                with span("step"):
                    with span("inner"):
                        raise ValueError("closes both")
            with span("decode"):
                t = threading.Thread(target=_in_thread)
                t.start()
                t.join()
        with span("after"):
            pass
    by = {r.name: (i, r) for i, r in enumerate(recs)}
    assert _names(recs) == ["pass", "stage", "step", "inner", "decode", "thread_outer",
                            "thread_inner", "after"]
    main = threading.get_ident()
    assert [r.parent for r in recs] == [-1, 0, 0, 2, 0, -1, 5, -1]
    assert [r.unit for r in recs] == [0, 0, 0, 0, 0, -1, -1, -1]
    assert {r.thread for r in recs if not r.name.startswith("thread")} == {main}
    assert by["thread_outer"][1].thread == by["thread_inner"][1].thread != main
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)  # every span closed
    p, inner = by["step"][1], by["inner"][1]
    assert p.start_ns <= inner.start_ns <= inner.end_ns <= p.end_ns
    # self time: the pass less its children on its own thread (not the
    # other thread's spans, which nest under nothing of it)
    selft = trace_report.span_self_times(recs)
    kids = sum(r.end_ns - r.start_ns for r in recs if r.parent == 0)
    want = (recs[0].end_ns - recs[0].start_ns - kids) / 1e9
    assert selft["pass"][0] == 1 and selft["pass"][1] == pytest.approx(want, abs=1e-12)
    assert selft["step"][1] == pytest.approx(
        (p.end_ns - p.start_ns - (inner.end_ns - inner.start_ns)) / 1e9, abs=1e-12)
    assert not profiling._recording


def _in_thread():
    with span("thread_outer"):
        with span("thread_inner"):
            pass


def test_threads_keep_their_own_parents_under_contention():
    """More threads than cores, each opening nested spans with the
    interpreter switching threads every microsecond: every record kept,
    each inner span's parent the outer span of its own thread."""
    n_threads, n_spans = len(os.sched_getaffinity(0)) + 2, 200

    def work():
        for _ in range(n_spans):
            with span("outer", unit=True):
                with span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as recs:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(recs) == 2 * n_threads * n_spans
    for i, r in enumerate(recs):
        if r.name == "outer":
            assert r.parent == -1 and r.unit == i
        else:
            outer = recs[r.parent]
            assert outer.name == "outer" and outer.thread == r.thread and r.unit == r.parent
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns


def test_a_nested_recording_raises():
    with recording() as recs:
        with pytest.raises(RuntimeError):
            with recording():
                pass
        with span("still_on"):
            pass
    assert _names(recs) == ["still_on"]
    assert not profiling._recording
    with recording() as again:  # a fresh list; the old one is left as it was
        with span("next"):
            pass
    assert _names(again) == ["next"] and _names(recs) == ["still_on"]


def test_spans_are_on_the_profilers_clock():
    """A record_function range opened inside a span is dated by the
    profiler inside the span's [start_ns, end_ns]."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with recording() as recs, profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with span(f"s{i}"):
                with record_function(f"r{i}"):
                    torch.ones(64).add_(1)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("r")}
    for i, r in enumerate(recs):
        e = ranges[f"r{i}"]
        assert r.start_ns <= e.start_ns() <= e.end_ns() <= r.end_ns


def _meta(tag, n):
    return dict(n_rows=n, duration=[10.0 + i for i in range(n)],
                qid=[f"{tag}-q{i}" for i in range(n)], sentence=[f"{tag}-s{i}" for i in range(n)],
                video_id=[f"{tag}-v{i}" for i in range(n)])


def _eval_batch(seed):
    batch = train_batch(seed)
    batch.pop("video_feat")  # the eval collate's unique videos alone
    return batch, _meta(f"b{seed}", 8)


@pytest.mark.parametrize("coalesce", [3, 1])
def test_eval_pass_spans(coalesce):
    """Four batches of one shape: at K = 3 two calls of the coalesced step
    (the second padded), each staged once, its outputs copied out, each
    group decoded once; at K = 1 each batch staged, read back and decoded.
    One pass, one post-processing, then one collection, every span closed
    and of the pass."""
    model = _model().eval()
    step = make_eval_step(model, _encode, torch.float32, coalesce=coalesce)
    loader = [_eval_batch(s) for s in range(4)]
    with recording() as recs:
        rows = compute_mr_results(step, loader, EVAL_OPT, "cpu")
    assert len(rows) == 32
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)
    assert recs[0].name == "eval.pass" and _count(recs, "eval.pass") == 1
    assert all(r.unit == 0 for r in recs)
    assert _count(recs, "eval.postprocess") == _count(recs, "eval.collect") == 1
    assert [r.name for r in recs[-2:]] == ["eval.postprocess", "eval.collect"]
    assert recs[-2].parent == recs[-1].parent == 0
    parent = {i: recs[r.parent].name for i, r in enumerate(recs) if r.parent >= 0}
    if coalesce > 1:
        calls = 2
        want = {"eval.call": calls, "data.stage_superbatch": calls, "eval.step": calls,
                "eval.copy_out": calls, "eval.decode": calls, "eval.wait": 0,
                "data.stage_batch": 0}
        for i, r in enumerate(recs):
            if r.name in ("data.stage_superbatch", "eval.step", "eval.copy_out"):
                assert parent[i] == "eval.call"
        # the first group is decoded inside the second call, the last after it
        decodes = [parent[i] for i, r in enumerate(recs) if r.name == "eval.decode"]
        assert decodes == ["eval.call", "eval.pass"]
    else:
        want = {"data.stage_batch": 4, "eval.wait": 4, "eval.decode": 4, "eval.call": 0,
                "eval.step": 0, "data.stage_superbatch": 0}
    assert {k: _count(recs, k) for k in want} == want


def _train_opt(tmp_path):
    o = BaseOptions()
    o.initialize()
    opt = o.parser.parse_args([])
    opt.train_log_filepath = str(tmp_path / "train.log.txt")
    opt.grad_accum = 1
    return opt


def test_train_epoch_spans_and_meters(tmp_path, caplog):
    """Two steps: each loads, stages, steps (forward, loss, backward, the
    update, the readback inside `train.step`), plus the load that finds the
    loader's end; the epoch's log line and its three time meters as
    before."""
    model = _model()
    optimizer = build_optimizer(model, 1e-4)
    step = make_train_step(model, CriterionConfig(**CRITERION), _encode, optimizer,
                           grad_clip=0.1, seed=3)
    loader = [(train_batch(s), None) for s in range(2)]
    opt = _train_opt(tmp_path)
    with caplog.at_level(logging.INFO), recording() as recs:
        n, losses = train_epoch(step, loader, opt, 0, 0, "cpu")
    assert n == 2 and np.isfinite(losses["loss_overall"].avg)
    once = ("data.stage_batch", "train.step", "train.forward", "train.loss", "train.backward",
            "train.update", "train.readback")
    assert {k: _count(recs, k) for k in once} == {k: 2 for k in once}
    assert _count(recs, "train.load") == 3
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)
    steps = [i for i, r in enumerate(recs) if r.name == "train.step"]
    for i, r in enumerate(recs):
        if r.name in ("train.load", "data.stage_batch"):
            assert r.parent == -1 and r.unit == -1
        elif r.name != "train.step":
            assert recs[r.parent].name == "train.step" and r.unit in steps
            assert r.unit == r.parent
    # the meters, logged at the epoch's end, and the log in the reference's format
    for meter in ("dataloading_time", "prepare_inputs_time", "train_step_time"):
        assert any(m.startswith(f"{meter} ==> ") for m in caplog.messages)
    line = open(opt.train_log_filepath).read()
    assert " [Epoch] 001 [Loss] " in line and "loss_overall" in line


def test_maybe_trace_writes_the_spans_and_the_report_reads_them(tmp_path, capsys):
    from mesm_tpu_torch.scripts import profile_train

    profile_train.main(["--device", "cpu", "--B", "4", "--iters", "1",
                        "--trace-dir", str(tmp_path)])
    traces = list(tmp_path.glob("*" + profiling.TRACE_SUFFIX))
    spans = list(tmp_path.glob("*" + profiling.SPANS_SUFFIX))
    assert len(traces) == len(spans) == 1
    assert spans[0].name[:-len(profiling.SPANS_SUFFIX)] == \
        traces[0].name[:-len(profiling.TRACE_SUFFIX)]
    recs = trace_report.load_spans(str(tmp_path))
    assert {"train.forward", "train.loss", "train.backward", "train.update"} <= set(_names(recs))
    trace_report.main([str(tmp_path), "--spans"])
    out = capsys.readouterr().out
    assert "train.backward" in out and "device idle" not in out  # no kernels on the CPU
    assert not profiling._recording


def _rec(name, a_us, b_us, parent=-1, thread=1, unit=-1, base=0):
    return SpanRecord(name, base + a_us * 1000, base + b_us * 1000, parent, thread, unit)


# one pass on thread 1, in microseconds: stage [10, 30], step [30, 50] and
# decode [60, 90] inside pass [0, 100]; a span of thread 2 over it all
BASE = 1_700_000_000_000_000_000


def _pass_records(base=0):
    inside = [_rec(name, a, b, 0, unit=0, base=base)
              for name, a, b in (("stage", 10, 30), ("step", 30, 50), ("decode", 60, 90))]
    return ([_rec("pass", 0, 100, unit=0, base=base)] + inside
            + [_rec("other", 0, 100, thread=2, base=base), _rec("open", 95, 0, 0)])


def test_self_time_and_idle_by_span_at_the_edges():
    recs = _pass_records()
    recs[-1].end_ns = 0  # a span still open counts nowhere
    assert trace_report.innermost_pieces(recs, 1) == [
        (0, 10_000, "pass"), (10_000, 30_000, "stage"), (30_000, 50_000, "step"),
        (50_000, 60_000, "pass"), (60_000, 90_000, "decode"), (90_000, 100_000, "pass")]
    got = {k: (n, round(s * 1e6, 6)) for k, (n, s) in trace_report.span_self_times(recs).items()}
    assert got == {"pass": (1, 30.0), "stage": (1, 20.0), "step": (1, 20.0),
                   "decode": (1, 30.0), "other": (1, 100.0)}
    # busy: a kernel [20, 40] (from inside stage into step), a copy [45, 55]
    # (from step across step's end), a kernel [85, 95] and one before the window
    busy = [(20_000, 40_000), (45_000, 55_000), (85_000, 95_000), (-30_000, -20_000)]
    idle = trace_report.idle_by_span(recs, busy, -10_000, 100_000, 1)
    idle = {k: round(v * 1e6, 6) for k, v in idle.items()}
    assert idle == {"none": 10.0, "pass": 20.0, "stage": 10.0, "step": 5.0, "decode": 25.0}
    # idle is the window less the busy time, whatever the spans
    assert sum(idle.values()) == pytest.approx(110 - 40)
    assert trace_report.idle_by_span(recs, busy, 0, 100_000, 2) == pytest.approx(
        {"other": 60e-6})


def test_report_on_a_card_trace_written_out_by_hand(tmp_path, capsys):
    """A card's trace (ts in microseconds from baseTimeNanoseconds) with its
    spans file: self time by name, and the idle time by the innermost span
    of the first span's thread."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
                "args": {}}

    events = [x("kernel", "gemm", 20, 20), x("gpu_memcpy", "Memcpy HtoD", 45, 10),
              x("kernel", "ln_stats_kernel", 85, 10), x("cpu_op", "aten::mm", 21, 5)]
    (tmp_path / ("host_1.1" + profiling.TRACE_SUFFIX)).write_text(
        json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    (tmp_path / ("host_1.1" + profiling.SPANS_SUFFIX)).write_text(json.dumps(
        {"spans": [r.as_dict() for r in _pass_records(BASE)[:-1]]}))
    busy = trace_report.device_busy(str(tmp_path))
    assert busy == [(BASE + 20_000, BASE + 40_000), (BASE + 45_000, BASE + 55_000),
                    (BASE + 85_000, BASE + 95_000)]
    trace_report.main([str(tmp_path), "--spans"])
    out = capsys.readouterr().out
    assert "device idle 0.060 ms of 0.100 ms by innermost span" in out
    idle = {line.split()[0]: float(line.split()[1]) for line in out.splitlines()
            if line.split()[0] in ("pass", "stage", "step", "decode", "none")
            and len(line.split()) == 3}
    assert idle == {"pass": 0.020, "stage": 0.010, "step": 0.005, "decode": 0.025}
