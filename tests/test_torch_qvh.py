"""The QVHighlights (multi-clip) slice of the port against the JAX package,
on the CPU.

A small config of the harness (tests/test_torch_harness.py) with a
QVHighlights-style batch: up to 5 target windows per row (`tgt_mask`),
3-annotator saliency labels, and each row's SS-MESM video the concatenated
clips of its group (`ss_video_feat_groups` expanded by `ss_group_slot` when
the batch is staged). JAX at matmul precision "highest", torch without TF32.

Tolerances: fp32 forward outputs 1e-4 abs; multi-clip loss terms, the
total and every gradient 1e-4 in units of max(1, max |JAX|) (fp32 sums in
another order through a dozen layers); bf16 forward 0.05 abs (bf16 keeps 8
mantissa bits, the outputs are O(1), and the two sides round at some other
points: LayerNorm, bias adds, sums in another order); assignments exactly
equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from mesm_tpu.data.pipeline import stage_batch as jax_stage_batch
from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.losses import compute_losses as jax_compute_losses
from mesm_tpu.models.mesm import MESM as JaxMESM
from mesm_tpu.ops.lsap import solve_lsap_batch as jax_solve_lsap_batch
from mesm_tpu.ops.matcher import hungarian_match as jax_hungarian_match
from mesm_tpu_torch import kernels as tkernels
from mesm_tpu_torch.convert import state_dict_from_jax_params
from mesm_tpu_torch.data.pipeline import stage_batch
from mesm_tpu_torch.losses import CriterionConfig, compute_losses
from mesm_tpu_torch.ops.lsap import solve_lsap, solve_lsap_batch
from mesm_tpu_torch.ops.matcher import hungarian_match
from mesm_tpu_torch.parallel.step import make_eval_step, make_micro_grads

from synth import make_batch, sample_neg_rows
from test_torch_harness import SMALL, TRAIN, build_pair, jax_kernels

B, LV, LSS, T = 8, 64, 96, 5
# the QVHighlights criterion (config/QVHighlights/C+SF_C.json)
QVH_CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=1.0,
                     recfw_coef=0.5, recss_coef=0.1, cost_span=10.0, cost_giou=1.0,
                     cost_class=4.0, rank_coef=12.0, use_triplet=True, multi_clip=True)
TOL = 1e-4


@pytest.fixture(autouse=True)
def grad_mode_on():
    """Some tests take gradients; another module of the suite turns grad
    mode off for its whole process when it is imported
    (tests/test_transformer_oracle.py)."""
    with torch.enable_grad():
        yield


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def qvh_batch(seed: int = 0) -> dict:
    """A collated QVHighlights-style host batch: per-row video (no dedup),
    up to T windows per row, the last row padding, and the SS video stored
    once per group (NG, LSS, Dv) with the rows' group slots."""
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, B=B, Lv=LV, Dv=SMALL["v_feat_dim"], Lw=SMALL["max_words_l"],
                       Dt=SMALL["t_feat_dim"], G=3, T=T, vocab_classes=SMALL["num_classes"])
    for key in ("video_feat_g", "video_mask_g", "video_slot"):
        del batch[key]
    NG = int(batch["group_id"].max()) + 1
    ss_len = rng.integers(LSS // 2, LSS + 1, NG)
    ss_mask = np.arange(LSS)[None] < ss_len[:, None]
    batch["ss_video_feat_groups"] = (
        rng.normal(size=(NG, LSS, SMALL["v_feat_dim"])).astype(np.float32) * ss_mask[..., None]
    )
    batch["ss_video_mask_groups"] = ss_mask
    batch["ss_group_slot"] = batch["group_id"].copy()
    batch["row_mask"] = np.arange(B) < B - 1
    return batch


def _jax_staged(batch, bf16=False):
    return jax_stage_batch(batch, bf16)


def _torch_staged(batch, bf16=False):
    return stage_batch(batch, bf16, "cpu")


def jax_qvh_forward(jcfg, params, jb, training: bool, neg=None, mask_key: int = 2):
    """The JAX package's forward on a staged QVHighlights batch: inference
    (no negatives) or the training forward with negatives `neg` and MLM
    masks drawn from PRNGKey(mask_key)."""
    kw = dict(
        ss_sent_idx=jb["ss_sent_idx"], ss_sent_mask=jb["ss_sent_mask"],
        ss_own_pos=jb["ss_own_pos"], ss_video_feat=jb["ss_video_feat"],
        ss_video_mask=jb["ss_video_mask"],
    )
    args = (jb["video_feat"], jb["video_mask"], jb["words_feat"], jb["words_mask"],
            jb["sentence_feat"])
    if not training:
        return JaxMESM(jcfg).apply({"params": params}, *args, jnp.zeros((B,), jnp.int32),
                                   is_training=False, deterministic=True, compute_neg=False, **kw)
    return JaxMESM(jcfg).apply(
        {"params": params}, *args, jnp.asarray(neg), is_training=True, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(1), "mask_words": jax.random.PRNGKey(mask_key)},
        clip_mask=jb["clip_mask"], words_weight=jb["words_weight"],
        unknown_mask=jb["unknown_mask"], **kw,
    )


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


# ---------------------------------------------------------------------------
# staging and the forward
# ---------------------------------------------------------------------------


def test_stage_batch_expands_the_group_video_by_slot():
    batch = qvh_batch()
    got, want = _torch_staged(batch), _jax_staged(batch)
    assert set(got) == set(want)
    assert "ss_video_feat_groups" not in got and "ss_group_slot" not in got
    for key in ("ss_video_feat", "ss_video_mask"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(
        got["ss_video_feat"].numpy(), batch["ss_video_feat_groups"][batch["group_id"]]
    )


@pytest.fixture(scope="module")
def pair():
    with jax.default_matmul_precision("highest"):
        yield build_pair()


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qvh_forward_matches_jax(pair, dtype, mode):
    """The multi-clip inference forward through the port's eval step against
    the JAX package's forward. Under "on" in bf16 the T2V / enhance sites
    (64 queries, 8 and 9 keys, pair masks) run the packed short-key kernel
    on both sides (JAX: in interpret mode; the port: its plain version) and
    the DETR encoder the packed kernel."""
    jcfg, params, tmodel, _ = pair
    batch = qvh_batch()
    bf16 = dtype == "bfloat16"
    with jax.default_matmul_precision("highest"), jax_kernels(mode), tkernels.pallas_scope(mode):
        jc = dataclasses.replace(jcfg, dtype=jnp.bfloat16) if bf16 else jcfg
        want = jax_qvh_forward(jc, params, _jax_staged(batch, bf16), training=False)
        step = make_eval_step(tmodel, _encode, torch.bfloat16 if bf16 else torch.float32)
        got = step(_torch_staged(batch, bf16))
    prob = np.asarray(jax.nn.softmax(want["pred_logits"].astype(jnp.float32), axis=-1))[..., 0]
    pairs = {"scores": prob, "pred_spans": want["pred_spans"],
             "saliency_scores": want["saliency_scores"]}
    for key, w in pairs.items():
        g = got[key].float().numpy()
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert g.shape == w.shape, key
        assert np.isfinite(g).all(), key
        np.testing.assert_allclose(g, w, atol=0.05 if bf16 else TOL, rtol=0, err_msg=key)


def test_qvh_ss_video_changes_the_forward(pair):
    """The SS-MESM branch reads the group video: another group video moves
    the predictions (the single-video route would not see it)."""
    _, _, tmodel, _ = pair
    batch = qvh_batch()
    step = make_eval_step(tmodel, _encode, torch.float32)
    a = step(_torch_staged(batch))
    batch["ss_video_feat_groups"] = batch["ss_video_feat_groups"][::-1].copy()
    b = step(_torch_staged(batch))
    assert float((a["pred_spans"] - b["pred_spans"]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the Hungarian solver and the matcher
# ---------------------------------------------------------------------------


def _total(cost, col4row):
    return sum(cost[i, int(c)] for i, c in enumerate(col4row))


@pytest.mark.parametrize("n,m,seed", [(1, 10, 0), (3, 10, 1), (5, 10, 2), (5, 5, 3), (8, 16, 4)])
def test_solve_lsap_matches_scipy_optimal_cost(n, m, seed):
    """As tests/test_lsap.py holds the JAX solver: a matching whose cost is
    scipy's optimum, and the JAX solver's very assignment."""
    rng = np.random.default_rng(seed)
    costs = rng.normal(size=(20, n, m)).astype(np.float32) * 10
    ours = solve_lsap_batch(torch.from_numpy(costs)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_solve_lsap_batch(jnp.asarray(costs))))
    for cost, col4row in zip(costs, ours):
        rows, cols = linear_sum_assignment(cost)
        assert len(set(col4row.tolist())) == n, "assignment must be a matching"
        np.testing.assert_allclose(_total(cost, col4row), cost[rows, cols].sum(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(solve_lsap(torch.from_numpy(costs[0])).numpy(), ours[0])


def test_solve_lsap_row_mask_padding_is_inert():
    rng = np.random.default_rng(7)
    cost = np.zeros((40, 5, 10), np.float32)
    mask = np.zeros((40, 5), bool)
    for t in range(40):
        nv = int(rng.integers(1, 6))
        cost[t, :nv] = rng.normal(size=(nv, 10)) * 5
        mask[t, :nv] = True
    ours = solve_lsap_batch(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_solve_lsap_batch(jnp.asarray(cost), jnp.asarray(mask)))
    for t in range(40):
        nv = int(mask[t].sum())
        np.testing.assert_array_equal(ours[t, :nv], want[t, :nv])
        rows, cols = linear_sum_assignment(cost[t, :nv])
        assert len(set(ours[t, :nv].tolist())) == nv
        np.testing.assert_allclose(_total(cost[t, :nv], ours[t, :nv]), cost[t, :nv][rows, cols].sum(),
                                   rtol=1e-5, atol=1e-4)


def test_solve_lsap_ties_take_the_first_column():
    """Equal costs everywhere: the JAX solver's argmin tie-breaking."""
    cost = np.ones((3, 4, 10), np.float32)
    cost[1, :, 3] = 0.0
    ours = solve_lsap_batch(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_solve_lsap_batch(jnp.asarray(cost))))


@pytest.mark.parametrize("cost_class", [4.0, 6.0])
def test_hungarian_match_matches_jax(cost_class):
    rng = np.random.default_rng(0)
    Bm, nq = 16, 10
    logits = rng.normal(size=(Bm, nq, 2)).astype(np.float32)
    spans = np.stack([rng.uniform(0.1, 0.9, (Bm, nq)), rng.uniform(0.05, 0.5, (Bm, nq))], -1)
    spans = spans.astype(np.float32)
    n_tgt = rng.integers(1, T + 1, Bm)
    tgt_mask = np.arange(T)[None] < n_tgt[:, None]
    ctr, wid = rng.uniform(0.2, 0.8, (Bm, T)), rng.uniform(0.05, 0.3, (Bm, T))
    tspan = (np.stack([ctr, wid], -1) * tgt_mask[..., None]).astype(np.float32)
    tmom = (np.stack([ctr - wid / 2, ctr + wid / 2], -1) * tgt_mask[..., None]).astype(np.float32)
    args = (logits, spans, tspan, tmom, tgt_mask)
    want = np.asarray(jax_hungarian_match(*(jnp.asarray(a) for a in args), 10.0, 1.0, cost_class))
    got = hungarian_match(*(torch.from_numpy(a) for a in args), 10.0, 1.0, cost_class).numpy()
    np.testing.assert_array_equal(np.where(tgt_mask, got, -1), np.where(tgt_mask, want, -1))


# ---------------------------------------------------------------------------
# the multi-clip losses and the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_family():
    """(jax config, params, torch model, host batch, negatives, JAX training
    outputs) of the dropout-free config on a QVHighlights batch."""
    with jax.default_matmul_precision("highest"):
        jcfg, params, tmodel, _ = build_pair(**TRAIN)
        batch = qvh_batch(1)
        neg = sample_neg_rows(np.random.default_rng(1), batch["group_id"])
        jout = jax.tree.map(np.asarray, jax_qvh_forward(jcfg, params, _jax_staged(batch), True, neg))
    return jcfg, params, tmodel, batch, neg, jout


def test_multi_clip_losses_match_jax(train_family):
    """Every multi-clip loss term (Hungarian-matched span / gIoU / label and
    their aux copies, saliency with the triplet term, rec_ss over merged
    windows, rec_fw) on the JAX training forward's outputs."""
    _, _, _, batch, _, jout = train_family
    jb = _jax_staged(batch)
    want, want_total = jax_compute_losses({k: jnp.asarray(v) for k, v in jout.items()}, jb,
                                          JaxCriterionConfig(**QVH_CRITERION), is_training=True)
    got, got_total = compute_losses({k: torch.from_numpy(np.asarray(v)) for k, v in jout.items()},
                                    _torch_staged(batch), CriterionConfig(**QVH_CRITERION),
                                    is_training=True)
    assert set(got) == set(want)
    assert {"loss_span_0", "loss_rec_ss", "loss_rec_fw", "loss_saliency"} <= set(got)
    for key in want:
        assert _err(_np(got[key]), want[key]) <= TOL, key
    assert _err(_np(got_total), want_total) <= TOL


def test_qvh_train_step_loss_and_grads_match_jax(train_family):
    """One micro-batch from the shared converted init, with the JAX side's
    negatives and MLM masks injected: the loss, every term, every gradient."""
    jcfg, params, tmodel, batch, neg, jout = train_family
    jb = _jax_staged(batch)
    ccfg = JaxCriterionConfig(**QVH_CRITERION)

    def loss_fn(p):
        out = jax_qvh_forward(jcfg, p, jb, True, neg)
        losses, total = jax_compute_losses(out, jb, ccfg, is_training=True)
        return total, losses

    with jax.default_matmul_precision("highest"):
        (want_total, want_losses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = type(tmodel)(tmodel.cfg)
    model.load_state_dict(tmodel.state_dict())
    micro = make_micro_grads(model, CriterionConfig(**QVH_CRITERION), _encode)
    total, losses = micro(_torch_staged(batch), neg_idx_rows=torch.from_numpy(neg),
                          masked_words_loc=torch.from_numpy(jout["masked_words_loc"]))
    assert _err(_np(total), want_total) <= TOL
    for key, want in want_losses.items():
        assert _err(_np(losses[key]), want) <= TOL, key
    want_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), model.cfg)
    params_t = dict(model.named_parameters())
    assert set(want_grads) == set(params_t)
    for key, want in want_grads.items():
        grad = params_t[key].grad
        grad = torch.zeros_like(params_t[key]) if grad is None else grad
        assert _err(_np(grad), want.numpy()) <= TOL, key
