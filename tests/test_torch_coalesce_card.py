"""The coalesced eval step's CUDA graphs, on the card (skipped on a host
without one). No JAX import, so the card's machine runs this file.

A narrow charades-style model (the input projection wide enough for the
fused LayerNorm -> Dense kernel under "auto"), fp32, superbatches of K = 3
batches from scripts/synthetic.make_eval_batch: the graph replay against 3
eager per-batch calls (1e-5 in units of max(1, |per-batch|): the same
kernels at the same shapes, the hoisted projection over more rows), the
graph's kernel nodes against the wrappers' counts at capture
(chip_smoke.GraphCensus), a
second superbatch staged into the graph's static inputs and replayed, an
in-place parameter update that drops the graph and captures a new one
whose values follow the new weights, and a body that syncs with the host,
which must raise rather than run eagerly.
"""
from __future__ import annotations

import pytest
import torch

from chip_smoke import GraphCensus
from mesm_tpu_torch.data.pipeline import stage_batch, stage_superbatch, staged_signature
from mesm_tpu_torch.models.mesm import MESM
from mesm_tpu_torch.parallel import step as tstep
from mesm_tpu_torch.parallel.step import make_eval_step
from mesm_tpu_torch.scripts import synthetic

K, TOL = 3, 1e-5
SHAPE = dict(B=16, NG=7, Lv=24, Dv=1030, Lw=8, Dt=32, G=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the coalesced step captures CUDA graphs")
    return torch.device("cuda")


def _hosts(seed0: int):
    s = SHAPE
    return [{k: v.numpy() for k, v in synthetic.make_eval_batch(
        seed0 + j, s["B"], s["NG"], s["Lv"], s["Dv"], s["Lw"], s["Dt"], device="cpu",
        G=s["G"]).items()} for j in range(K)]


def _err(got, want) -> float:
    return float(((got.float() - want.float()).abs() / want.float().abs().max().clamp(min=1)).max())


@pytest.mark.cuda
def test_graph_replay_equals_per_batch_and_follows_the_weights(cuda):
    torch.manual_seed(0)
    model = MESM(synthetic.charades_config(hidden_dim=32, nheads=4, dim_feedforward=64,
                                           v_feat_dim=SHAPE["Dv"], t_feat_dim=SHAPE["Dt"],
                                           max_video_l=SHAPE["Lv"])).to(cuda).eval()
    one = make_eval_step(model, synthetic.encode_cached, torch.float32)
    step = make_eval_step(model, synthetic.encode_cached, torch.float32, coalesce=K)
    captured = tstep.graphs_captured

    def check(hosts):
        sb = stage_superbatch(hosts, False, cuda, into=step.static_inputs)
        preds = step(sb)
        for j, h in enumerate(hosts):
            for key, want in one(stage_batch(h, False, cuda)).items():
                assert _err(preds[key][j], want) <= TOL, (key, j)
        return sb

    with GraphCensus() as census:
        check(_hosts(0))
    assert tstep.graphs_captured == captured + 1
    # every counted launch at capture is one kernel node of its kernel, the
    # hoisted projection's once a graph
    assert census.ok() and census.records[0]["nodes"]["ln_dense"] == 1
    assert census.device_launches(census.records[0]["captured"])["ln_dense"] == 1
    sb = check(_hosts(10))  # staged into the static inputs, replayed
    assert tstep.graphs_captured == captured + 1
    assert all(sb[k] is t for k, t in step.static_inputs(staged_signature(sb)).items())
    with torch.no_grad():
        model.input_vid_proj[0].net[1].weight.mul_(1.5)  # the hoisted kernel's derived weight
    check(_hosts(10))
    assert tstep.graphs_captured == captured + 2


@pytest.mark.cuda
def test_a_capture_that_syncs_with_the_host_raises(cuda):
    torch.manual_seed(0)
    model = MESM(synthetic.charades_config(hidden_dim=32, nheads=4, dim_feedforward=64,
                                           v_feat_dim=SHAPE["Dv"], t_feat_dim=SHAPE["Dt"],
                                           max_video_l=SHAPE["Lv"])).to(cuda).eval()

    def syncing(b):
        float(b["cached_sentence_feat"].sum())  # a device-to-host copy
        return synthetic.encode_cached(b)

    step = make_eval_step(model, syncing, torch.float32, coalesce=K)
    captured = tstep.graphs_captured
    with pytest.raises(RuntimeError):
        step(stage_superbatch(_hosts(0), False, cuda))
    assert tstep.graphs_captured == captured and not step._graphs
