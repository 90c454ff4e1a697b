"""The fused stream layer and the layout anchor (mesm_tpu_torch.ops.stream_layer,
mesm_tpu_torch.ops.anchor) against the JAX package.

- The plain version against mesm_tpu.ops.layer_pallas.fused_stream_layer in
  interpret mode, on the flax layers' parameters (tests/test_layer_kernel.py
  map_params) carried into the port's layers by
  convert.layer_state_dict_from_jax_params: both flavours, with and without
  the pair mask, padded keys, and a sample whose keys are all masked (by the
  key mask, or by the pair mask). fp32 within 2e-5 (the JAX tests' own
  bound: f32 sums in another order); bf16 within 0.05 in units of max(1,
  |ref|), since XLA keeps the interpret-mode kernel's chain in f32 between
  some of the rounding points the plain version takes.
- The plain version against the port's own TransformerEncoderLayer /
  T2VLayer in eval, fp32, within 2e-5 (their LayerNorm takes the two-pass
  variance, their softmax torch's).
- The bench entry point on the CPU, and layout_anchor's no-op cases.

flax and mesm_tpu.models are imported inside the tests: the GPU machine,
where the tests marked `cuda` run (they skip here), has no flax.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops import anchor as janchor
from mesm_tpu.ops.layer_pallas import fused_stream_layer as jax_stream_layer
from mesm_tpu_torch import kernels
from mesm_tpu_torch.convert import layer_state_dict_from_jax_params
from mesm_tpu_torch.models.detr import TransformerEncoderLayer
from mesm_tpu_torch.models.t2v import T2VLayer, scrambled_pair_factors
from mesm_tpu_torch.ops import anchor
from mesm_tpu_torch.ops import stream_layer as sl
from mesm_tpu_torch.scripts import bench_layer_kernel

D, H, F = 64, 4, 128
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
FP32_TOL, BF16_TOL = 2e-5, 0.05


def _case(flavor: str, pair: bool, seed: int):
    """numpy inputs of one flavour: the encoder at B 4, L 48 (sample 3 with
    every key masked); T2V at Lv 40 against Lt 9. Pair factors (B, H, Lq),
    (B, H, Lk): random for the encoder, the model's scrambled factors for
    T2V, each with one sample whose every pair is masked."""
    rng = np.random.default_rng(seed)
    B = 4
    Lq, Lk = (48, 48) if flavor == "encoder" else (40, 9)
    c = {"x": rng.normal(size=(B, Lq, D)), "pos": rng.normal(size=(B, Lq, D))}
    if flavor == "encoder":
        c["mask"] = np.arange(Lk)[None] < rng.integers(Lk // 2, Lk + 1, B)[:, None]
        c["mask"][3] = False
    else:
        c["txt"], c["pos_t"] = rng.normal(size=(B, Lk, D)), rng.normal(size=(B, Lk, D))
        c["mask"] = np.arange(Lk)[None] < rng.integers(3, Lk + 1, B)[:, None]
        c["vmask"] = np.arange(Lq)[None] < rng.integers(Lq // 2, Lq + 1, B)[:, None]
    c = {k: (v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in c.items()}
    if pair:
        if flavor == "encoder":
            qf, kf = rng.random((B, H, Lq)) < 0.3, rng.random((B, H, Lk)) < 0.3
        else:
            qf, kf = (f.numpy().copy() for f in scrambled_pair_factors(
                torch.from_numpy(c["vmask"]), torch.from_numpy(c["mask"]), H))
        qf[1], kf[1] = True, True
        c["qf"], c["kf"] = qf, kf
    return c


def _perturbed(params, seed: int):
    """The flax parameters plus N(0, 0.1) noise on every leaf, so that the
    biases, LayerNorm parameters and the PReLU slope are not their inits."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)),
        params)


def _jax_layer(flavor: str, c: dict, seed: int):
    """(flax parameters, perturbed) of a fresh flax layer of the flavour."""
    from mesm_tpu.models.detr import TransformerEncoderLayer as JaxEncoderLayer
    from mesm_tpu.models.t2v import T2VLayer as JaxT2VLayer

    key = jax.random.PRNGKey(seed)
    if flavor == "encoder":
        layer = JaxEncoderLayer(D, H, F, dropout=0.0)
        params = layer.init(key, c["x"], c["mask"], c["pos"])["params"]
    else:
        layer = JaxT2VLayer(D, H, F, dropout=0.0)
        params = layer.init(key, c["txt"], c["x"], c["mask"], c["pos_t"], c["pos"],
                            c["vmask"])["params"]
    return _perturbed(params, seed + 100)


def _torch_inputs(flavor: str, c: dict, dtype: str):
    """(x, pos, k_in, v_in, mask, pair factors) for the port's functions."""
    dt = TORCH_DT[dtype]
    t = lambda k: torch.from_numpy(c[k]).to(dt)  # noqa: E731
    k_in = v_in = None
    if flavor == "t2v":
        v_in = t("txt")
        k_in = v_in + t("pos_t")
    pf = (torch.from_numpy(c["qf"]), torch.from_numpy(c["kf"])) if "qf" in c else None
    return t("x"), t("pos"), k_in, v_in, torch.from_numpy(c["mask"]), pf


def _port_layer(flavor: str, state=None):
    layer = (TransformerEncoderLayer(D, H, F, dropout=0.0) if flavor == "encoder"
             else T2VLayer(D, H, F, dropout=0.0)).eval()
    if state is not None:
        layer.load_state_dict(state, strict=True)
    return layer


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pair", [False, True], ids=["nopair", "pair"])
@pytest.mark.parametrize("flavor", ["encoder", "t2v"])
def test_plain_version_matches_pallas_kernel(flavor, pair, dtype):
    from test_layer_kernel import map_params

    c = _case(flavor, pair, seed=3 + pair)
    params = _jax_layer(flavor, c, seed=5)
    jdt = JAX_DT[dtype]
    j = lambda k: jnp.asarray(c[k], jdt)  # noqa: E731
    qf = kf = None
    if pair:  # the TPU kernel takes the factors head-major, as floats
        qf = jnp.asarray(c["qf"], jnp.float32).transpose(1, 0, 2)
        kf = jnp.asarray(c["kf"], jnp.float32).transpose(1, 0, 2)
    self_attn = flavor == "encoder"
    with jax.default_matmul_precision("highest"):  # f32 products in full f32, as torch's
        want = jax_stream_layer(
            j("x"), j("pos"), None if self_attn else j("txt") + j("pos_t"),
            None if self_attn else j("txt"), jnp.asarray(c["mask"], jnp.float32), qf, kf,
            map_params(params, "self_attn" if self_attn else "cross_attn"),
            heads=H, self_attn=self_attn, interpret=True,
        )
        want = np.asarray(want.astype(jnp.float32))

    layer = _port_layer(flavor, layer_state_dict_from_jax_params(params, flavor))
    with torch.no_grad():
        got = sl.stream_layer_reference(*_torch_inputs(flavor, c, dtype),
                                        sl.stream_layer_params(layer), H, self_attn)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == want.shape
    got = got.float().numpy()
    err = _rel_err(got, want)
    print(f"{flavor} pair={pair} {dtype}: max err {np.abs(got - want).max():.3e}, "
          f"in units of max(1, |ref|) {err:.3e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    else:
        assert err <= BF16_TOL


def _perturb_port(layer, seed: int):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return layer


@pytest.mark.parametrize("flavor,pair", [("encoder", False), ("t2v", False), ("t2v", True)],
                         ids=["encoder", "t2v-nopair", "t2v-pair"])
def test_plain_version_matches_port_layers(flavor, pair):
    """The port's eval layers, fp32. The T2V layer takes the model's scrambled
    factors of its video mask (pair) or none (no video mask given)."""
    torch.manual_seed(11)
    layer = _perturb_port(_port_layer(flavor), 12)
    c = _case(flavor, False, seed=13)
    x, pos, k_in, v_in, mask, _ = _torch_inputs(flavor, c, "float32")
    with torch.no_grad():
        if flavor == "encoder":
            want = layer(x, mask, pos)
            pf = None
        else:
            vmask = torch.from_numpy(c["vmask"]) if pair else None
            pos_t = torch.from_numpy(c["pos_t"])
            want = layer(v_in, x, mask, pos_t, pos, vmask)
            pf = scrambled_pair_factors(vmask, mask, H) if pair else None
        got = sl.stream_layer_reference(x, pos, k_in, v_in, mask, pf, sl.stream_layer_params(layer),
                                        H, flavor == "encoder")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FP32_TOL, rtol=0)


def test_stream_layer_params_refuses_other_ffns():
    with pytest.raises(ValueError, match="PReLU"):
        sl.stream_layer_params(TransformerEncoderLayer(D, H, F, activation="relu"))
    two = T2VLayer(D, H, F, two_mlp=True)
    sl.stream_layer_params(two)  # the main FFN and norms
    with pytest.raises(ValueError, match="is_mlm"):
        sl.stream_layer_params(two, is_mlm=True)


@pytest.mark.parametrize("flavor", ["encoder", "t2v"])
def test_bench_entry_point_on_cpu(flavor, capsys):
    """`python -m mesm_tpu_torch.scripts.bench_layer_kernel <flavor> 3 24 2
    --device cpu`: the plain version runs in the kernel's place (no launch)
    and agrees with the module chain."""
    res = bench_layer_kernel.main([flavor, "3", "24", "2", "--dtype", "float32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "module chain" in out and "fused kernel" in out and "maxdiff" in out
    assert (res["B"], res["L"], res["N"]) == (3, 24, 2)
    assert res["kernel_launches_per_chain"] == 0 and res["finite"]
    assert res["module_ms_per_layer"] > 0 and res["kernel_ms_per_layer"] > 0
    assert res["max_err_rel_to_max1"] <= 1e-4


def test_layout_anchor_is_the_identity_where_the_jax_one_is():
    """On the CPU both anchors return x itself, for a strided view too;
    for 2-D input and under "off" the port's does on any device (meta
    tensors stand in for CUDA ones: the checks read only shape and mode);
    a 3-D meta tensor in "auto" reaches the device check and raises."""
    x = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    jx = jnp.asarray(x)
    assert janchor.layout_anchor(jx) is jx
    tx = torch.from_numpy(x)
    view = torch.from_numpy(x.transpose(0, 2, 1).copy()).transpose(1, 2)
    before = anchor.launches
    assert anchor.layout_anchor(tx) is tx
    assert anchor.layout_anchor(view) is view
    meta2, meta3 = torch.empty(5, 3, device="meta"), torch.empty(2, 5, 3, device="meta")
    assert anchor.layout_anchor(meta2) is meta2
    with kernels.pallas_scope("off"):
        assert anchor.layout_anchor(meta3) is meta3
    with pytest.raises(ValueError, match="unsupported device"):
        anchor.layout_anchor(meta3)
    assert anchor.launches == before
    ref = anchor.layout_anchor_reference(view)
    assert ref.is_contiguous() and torch.equal(ref, tx)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _card_case(flavor: str, dtype: str, B: int, Lq: int, Lk: int, d: int, heads: int, f: int,
               device, pair: bool):
    """Inputs and weights on the card: padded keys, sample 1 with every key
    masked; with `pair`, pair factors and sample 2 with every pair masked."""
    g = torch.Generator(device=device).manual_seed(7)
    dt = TORCH_DT[dtype]
    rn = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    x, pos = rn(B, Lq, d).to(dt), rn(B, Lq, d).to(dt)
    k_in = v_in = pf = None
    if flavor == "t2v":
        v_in = rn(B, Lk, d).to(dt)
        k_in = (v_in.float() + rn(B, Lk, d)).to(dt)
    if pair:
        qf, kf = rn(B, heads, Lq) > 0.5, rn(B, heads, Lk) > 0.5
        qf[2], kf[2] = True, True
        pf = (qf, kf)
    mask = torch.arange(Lk, device=device)[None] < torch.randint(1, Lk + 1, (B,), generator=g,
                                                                  device=device)[:, None]
    mask[1] = False
    params = {}
    for name in sl.WEIGHT_NAMES:
        shape = {"w1": (f, d), "b1": (f,), "w2": (d, f), "alpha": (1,)}.get(
            name, (d, d) if name in ("wq", "wk", "wv", "wo") else (d,))
        fan_in = shape[1] if len(shape) == 2 else 1
        params[name] = rn(*shape) / fan_in**0.5 + (1.0 if name in ("ln1s", "ln2s") else 0.0)
    return x, pos, k_in, v_in, mask, pf, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("flavor,shape,pair", [
    ("encoder", (16, 195, 195, 256, 8, 1024), False), ("t2v", (16, 194, 17, 256, 8, 1024), True),
    ("t2v", (3, 37, 5, 96, 3, 160), True), ("encoder", (4, 70, 70, 64, 2, 96), True),
], ids=["encoder", "t2v", "t2v-ragged", "encoder-pair"])
def test_stream_layer_kernel_matches_plain(cuda, flavor, shape, pair, dtype):
    """The charades widths (16 samples), a ragged T2V shape (tails in every
    product) and the encoder under a pair mask: fp32 within 1e-4 (1024-term
    sums in another order, through two LayerNorms), bf16 within 0.05 (one
    flipped bf16 step of the hidden propagates through LN2), in units of
    max(1, |plain|)."""
    B, Lq, Lk, d, heads, f = shape
    x, pos, k_in, v_in, mask, pf, params = _card_case(flavor, dtype, B, Lq, Lk, d, heads, f, cuda,
                                                      pair)
    self_attn = flavor == "encoder"
    before = sl.launches
    got = sl.fused_stream_layer(x, pos, k_in, v_in, mask, pf, params, heads, self_attn)
    want = sl.stream_layer_reference(x, pos, k_in, v_in, mask, pf, params, heads, self_attn)
    torch.cuda.synchronize()
    assert sl.launches == before + 1
    assert got.dtype == x.dtype and torch.isfinite(got).all()
    err = _rel_err(got.float().cpu(), want.float().cpu())
    print(f"max err in units of max(1, |plain|): {err:.3e}")
    assert err <= (1e-4 if dtype == "float32" else 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layout_anchor_kernel_is_bit_equal(cuda, dtype):
    """A contiguous input and a (B, D, L) tensor viewed as (B, L, D): a
    fresh row-major tensor with the same bits, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(0)
    base = torch.randn(8, 64, 37, generator=g, device=cuda).to(TORCH_DT[dtype])
    for x in (base.transpose(1, 2).contiguous(), base.transpose(1, 2)):
        before = anchor.launches
        got = anchor.layout_anchor(x)
        torch.cuda.synchronize()
        assert anchor.launches == before + 1
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
        assert torch.equal(got, anchor.layout_anchor_reference(x))
