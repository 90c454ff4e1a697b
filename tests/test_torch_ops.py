"""Module parity of the port against the JAX package on the CPU: span and
mask helpers, LinearBlock / InputProj, positions, the attention core and
ProjAttention, T2V with scrambled pair masks, the DETR encoder / decoder.

Inputs come from numpy seeds; the modules' weights from one JAX init of a
small charades config, carried across with state_dict_from_jax_params and
loaded strictly (tests/test_torch_harness.py). fp32 throughout, with JAX at
matmul precision "highest"; every output within 1e-4 abs (the two sides
differ only in summation order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.models import attention as jatt
from mesm_tpu.models import detr as jdetr
from mesm_tpu.models import layers as jlayers
from mesm_tpu.models import position as jpos
from mesm_tpu.models import t2v as jt2v
from mesm_tpu.ops import masking as jmask
from mesm_tpu.ops import span as jspan
from mesm_tpu_torch import kernels as tkernels
from mesm_tpu_torch.models import attention as tatt
from mesm_tpu_torch.models import position as tpos
from mesm_tpu_torch.models import t2v as tt2v
from mesm_tpu_torch.ops import masking as tmask
from mesm_tpu_torch.ops import span as tspan

from test_torch_harness import SMALL, build_pair, jax_kernels

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("name", [
    "span_xx_to_cxw", "span_cxw_to_xx", "temporal_iou", "generalized_temporal_iou",
    "pairwise_temporal_iou", "pairwise_generalized_temporal_iou",
])
def test_span_ops(name):
    rng = np.random.default_rng(0)
    st = rng.uniform(0, 0.6, (3, 5))
    a = np.stack([st, st + rng.uniform(0.05, 0.4, (3, 5))], -1).astype(np.float32)
    st = rng.uniform(0, 0.6, (3, 5))
    b = np.stack([st, st + rng.uniform(0.05, 0.4, (3, 5))], -1).astype(np.float32)
    jf, tf = getattr(jspan, name), getattr(tspan, name)
    args = (a,) if name.startswith("span_") else (a, b)
    want = jf(*(jnp.asarray(x) for x in args))
    got = tf(*(_t(x) for x in args))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, 1e-6)
    else:
        _close(got, want, 1e-6)


def test_masking_ops():
    rng = np.random.default_rng(1)
    lengths = np.array([3, 7, 1, 5])
    _close(tmask.lengths_to_mask(_t(lengths), 8), jmask.lengths_to_mask(jnp.asarray(lengths), 8))
    x = rng.normal(size=(4, 8, 6)).astype(np.float32)
    m = np.arange(8)[None] < lengths[:, None]
    _close(tmask.masked_mean(_t(x), _t(m)), jmask.masked_mean(jnp.asarray(x), jnp.asarray(m)), 1e-6)
    _close(tmask.l2_normalize(_t(x), eps=1e-5), jmask.l2_normalize(jnp.asarray(x), eps=1e-5), 1e-6)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_input_proj_and_linear_block(pair, mode):
    """InputProj (two LinearBlocks, LayerNorm on the raw input, ReLU flags);
    under "on" both sides take the fused LayerNorm -> Dense path. The port
    runs as its eval step does, under no_grad: the kernel wrapper refuses
    parameters that need a gradient in grad mode."""
    jcfg, params, tmodel, _ = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 11, SMALL["v_feat_dim"])).astype(np.float32) * 3 + 1
    with jax_kernels(mode), tkernels.pallas_scope(mode), torch.no_grad():
        want = jlayers.InputProj(SMALL["hidden_dim"], 2, 0.5).apply(
            {"params": params["input_vid_proj"]}, jnp.asarray(x), deterministic=True
        )
        got = tmodel.input_vid_proj(_t(x))
        want0 = jlayers.LinearBlock(SMALL["hidden_dim"], relu=True).apply(
            {"params": params["input_vid_proj"]["block0"]}, jnp.asarray(x), deterministic=True
        )
        got0 = tmodel.input_vid_proj[0](_t(x))
    _close(got, want)
    _close(got0, want0)


def test_positions():
    rng = np.random.default_rng(3)
    mask = np.arange(20)[None] < rng.integers(5, 21, (4,))[:, None]
    _close(tpos.sine_position_embedding(_t(mask), 32),
           jpos.sine_position_embedding(jnp.asarray(mask), 32), 1e-5)
    x = rng.normal(size=(4, 9, 16)).astype(np.float32)
    table = rng.normal(size=(12, 16)).astype(np.float32)
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    want = jpos.TrainablePositionEmbedding(12, 16).apply(
        {"params": {"embedding": table, "norm": {"scale": g, "bias": b}}}, jnp.asarray(x)
    )
    mod = tpos.TrainablePositionEmbedding(12, 16).eval()
    mod.load_state_dict({"position_embeddings.weight": _t(table), "LayerNorm.weight": _t(g),
                         "LayerNorm.bias": _t(b)}, strict=True)
    with torch.no_grad():
        _close(mod(_t(x)), want)


@pytest.mark.parametrize("variant", ["mask", "pair", "split"])
def test_attention_core(variant):
    rng = np.random.default_rng(4)
    B, Lq, Lk, E, H = 5, 12, 9, 16, 4
    q = rng.normal(size=(B, Lq, E)).astype(np.float32)
    k = rng.normal(size=(B, Lk, E)).astype(np.float32)
    v = rng.normal(size=(B, Lk, E)).astype(np.float32)
    kmask = np.arange(Lk)[None] < rng.integers(1, Lk + 1, (B,))[:, None]
    kw_j, kw_t = {"key_valid_mask": jnp.asarray(kmask)}, {"key_valid_mask": _t(kmask)}
    if variant == "pair":
        qmask = np.arange(Lq)[None] < rng.integers(1, Lq + 1, (B,))[:, None]
        fj = jt2v.scrambled_pair_factors(jnp.asarray(qmask), jnp.asarray(kmask), H)
        ft = tt2v.scrambled_pair_factors(_t(qmask), _t(kmask), H)
        np.testing.assert_array_equal(ft[0].numpy(), np.asarray(fj[0]))
        np.testing.assert_array_equal(ft[1].numpy(), np.asarray(fj[1]))
        kw_j["pair_factors"], kw_t["pair_factors"] = fj, ft
    if variant == "split":
        q2 = rng.normal(size=(B, Lq, E)).astype(np.float32)
        k2 = rng.normal(size=(B, Lk, E)).astype(np.float32)
        kw_j["split_qk"] = (jnp.asarray(q2), jnp.asarray(k2))
        kw_t["split_qk"] = (_t(q2), _t(k2))
    want = jatt.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, **kw_j)
    _close(tatt.attention_core(_t(q), _t(k), _t(v), H, **kw_t), want)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_proj_attention(pair, mode):
    """The DETR encoder's self-attention at L = 65 (global token + 64): under
    "on" the JAX side runs its fp32 Pallas attention in interpret mode."""
    _, params, tmodel, _ = pair
    rng = np.random.default_rng(5)
    B, L, d = 8, 65, SMALL["hidden_dim"]
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    mask = np.arange(L)[None] < rng.integers(10, L + 1, (B,))[:, None]
    mask[:, 0] = False
    p = params["transformer"]["encoder"]["layer0"]["self_attn"]
    with jax_kernels(mode), tkernels.pallas_scope(mode):
        want = jatt.ProjAttention(SMALL["nheads"]).apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
            key_valid_mask=jnp.asarray(mask),
        )
        with torch.no_grad():
            got = tmodel.transformer.encoder.layers[0].self_attn(_t(x), _t(x), _t(x), _t(mask))
    _close(got, want)


def test_t2v_encoder_scrambled_pairs(pair):
    _, params, tmodel, _ = pair
    rng = np.random.default_rng(6)
    B, Lv, Lt, d = 8, 20, 7, SMALL["hidden_dim"]
    vid = rng.normal(size=(B, Lv, d)).astype(np.float32)
    txt = rng.normal(size=(B, Lt, d)).astype(np.float32)
    pos = rng.normal(size=(B, Lv, d)).astype(np.float32)
    vmask = np.arange(Lv)[None] < rng.integers(3, Lv + 1, (B,))[:, None]
    tmask_ = np.arange(Lt)[None] < rng.integers(1, Lt + 1, (B,))[:, None]
    enc = jt2v.T2VEncoder(d, SMALL["nheads"], SMALL["t2v_layers"], SMALL["dim_feedforward"])
    want = enc.apply(
        {"params": params["t2v_encoder"]}, jnp.asarray(txt), jnp.asarray(vid),
        jnp.asarray(tmask_), None, jnp.asarray(pos), jnp.asarray(vmask),
    )
    with torch.no_grad():
        got = tmodel.t2v_encoder(_t(txt), _t(vid), _t(tmask_), None, _t(pos), _t(vmask))
    _close(got, want)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_detr_transformer(pair, mode):
    """Global-token encoder and DAB decoder with aux outputs."""
    jcfg, params, tmodel, _ = pair
    rng = np.random.default_rng(7)
    B, L, d = 8, 64, SMALL["hidden_dim"]
    src = rng.normal(size=(B, L, d)).astype(np.float32)
    pos = rng.normal(size=(B, L, d)).astype(np.float32)
    mask = np.arange(L)[None] < rng.integers(8, L + 1, (B,))[:, None]
    gt = np.broadcast_to(params["global_rep_token"], (B, 1, d)).astype(np.float32)
    gp = np.broadcast_to(params["global_rep_pos"], (B, 1, d)).astype(np.float32)
    ref = params["query_embed"]
    tr = jdetr.Transformer(d, SMALL["nheads"], SMALL["enc_layers"], SMALL["dec_layers"],
                           SMALL["dim_feedforward"])
    with jax_kernels(mode), tkernels.pallas_scope(mode):
        want = tr.apply({"params": params["transformer"]}, jnp.asarray(src), jnp.asarray(mask),
                        jnp.asarray(ref), jnp.asarray(pos), jnp.asarray(gt), jnp.asarray(gp))
        with torch.no_grad():
            got = tmodel.transformer(_t(src), _t(mask), _t(ref), _t(pos), _t(gt), _t(gp))
    for g, w in zip(got, want):  # hs, references, memory_local, memory_global
        _close(g, w)
