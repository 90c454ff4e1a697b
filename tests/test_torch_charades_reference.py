"""Charades-STA C+SF_C (`portbench/configs/charades-c-sf-c.json`, the default
configuration of both entry points) through the port's coalesced eval
(`evaluate.compute_mr_results` over `make_eval_step(coalesce=K)`, K > 1,
batches of several length buckets) against the benchmark's plain PyTorch
reference (`portbench/reference/`, which imports neither JAX nor the port),
on the CPU at a small size, weights from a seed: every batch's scores, spans
and saliency within the `charades-eval` cell's limits, and the submission
rows equal to the reference's decode of the port's outputs."""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from mesm_tpu_torch import runner as R
from mesm_tpu_torch.evaluate import compute_mr_results
from mesm_tpu_torch.parallel.step import make_eval_step
from portbench import checks, harness
from portbench.drivers.eval import plan_calls
from portbench.reference.decode import decode_rows
from portbench.tests import tiny

CELL = "charades-eval"


def _run(seed: int, buckets: int, K: int, batch_videos: int):
    ov = copy.deepcopy(tiny.OVERRIDES[CELL])
    ov["config"] = dict(tiny.TINY_CONFIG)
    ov["traffic"].update(videos=24, sentences=120)
    ov["traffic"]["options"] = {"eval_coalesce": K, "eval_batch_size": batch_videos,
                                "eval_len_buckets": buckets}
    return harness.Run(CELL, seed, 1.0, False, device="cpu", overrides=ov)


class _Recorder:
    """The coalesced step, keeping every call's outputs."""

    def __init__(self, step):
        self.step, self.coalesce, self.outs = step, step.coalesce, []

    def __call__(self, staged):
        out = self.step(staged)
        self.outs.append({k: v.clone() for k, v in out.items()})
        return out


@pytest.mark.parametrize("seed,buckets,K,batch_videos", [
    (3000000001, 2, 3, 3),
    (98765432109, 4, 2, 2),
])
def test_coalesced_eval_matches_reference(seed, buckets, K, batch_videos):
    h = _run(seed, buckets, K, batch_videos)
    opt = h.options()
    batches = harness.plan_eval(h, opt)
    assert R.eval_coalesce_from_opt(opt, len(batches), torch.device("cpu")) == K
    widths = {b["video_mask"].shape[1] for b, _ in batches}
    assert len(widths) >= 2, widths
    calls = plan_calls(batches, K)
    assert any(len(c) > 1 for c in calls)
    step = _Recorder(make_eval_step(h.model(opt), harness.encode_cached, torch.float32,
                                    coalesce=K))
    with torch.no_grad():
        sub = compute_mr_results(step, batches, opt, "cpu")
    assert len(step.outs) == len(calls)
    assert len(sub) == sum(m["n_rows"] for _, m in batches)
    got = {r["qid"]: r for r in json.loads(json.dumps(sub))}

    checks.reference_precision(False)
    ref = h.reference_model()
    limits = h.cell["limits"]
    rows_seen = 0
    for call, idx in zip(step.outs, calls):
        for j, b in enumerate(idx):
            batch, meta = batches[b]
            n = meta["n_rows"]
            prog = {k: v[j].float().numpy() for k, v in call.items()}
            gaps = checks.eval_gaps(prog, checks.reference_eval_outputs(ref, batch, "cpu"),
                                    batch, n)
            for name, gap in gaps.items():
                assert gap <= limits[name], (b, name, gap)
            want = decode_rows(prog["scores"][:n], prog["pred_spans"][:n],
                               prog["saliency_scores"][:n],
                               np.asarray(batch["video_mask"])[:n].sum(1), meta, opt.clip_len,
                               opt.max_ts_val, opt.sort_results)
            assert [got[w["qid"]] for w in want] == want
            rows_seen += n
    assert rows_seen == len(sub)
