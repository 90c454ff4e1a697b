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
  The same at D 48 (head_dim 12) and F 80, widths the kernel pads.
- The plain version against the port's own TransformerEncoderLayer /
  T2VLayer in eval, fp32, within 2e-5 (their LayerNorm takes the two-pass
  variance, their softmax torch's).
- The bench entry point on the CPU, and layout_anchor's no-op cases.
- The kernel's weight layout (stream_layer.layout_weights) read back
  through the kernel's own addressing, written out here, and its cache
  (kernel_weights): one layout per weight version, dtype and head count.

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


def _case(flavor: str, pair: bool, seed: int, d: int = D):
    """numpy inputs of one flavour, width d: the encoder at B 4, L 48
    (sample 3 with every key masked); T2V at Lv 40 against Lt 9. Pair
    factors (B, H, Lq), (B, H, Lk): random for the encoder, the model's
    scrambled factors for T2V, each with one sample whose every pair is
    masked."""
    rng = np.random.default_rng(seed)
    B = 4
    Lq, Lk = (48, 48) if flavor == "encoder" else (40, 9)
    c = {"x": rng.normal(size=(B, Lq, d)), "pos": rng.normal(size=(B, Lq, d))}
    if flavor == "encoder":
        c["mask"] = np.arange(Lk)[None] < rng.integers(Lk // 2, Lk + 1, B)[:, None]
        c["mask"][3] = False
    else:
        c["txt"], c["pos_t"] = rng.normal(size=(B, Lk, d)), rng.normal(size=(B, Lk, d))
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


def _jax_layer(flavor: str, c: dict, seed: int, d: int = D, f: int = F):
    """(flax parameters, perturbed) of a fresh flax layer of the flavour."""
    from mesm_tpu.models.detr import TransformerEncoderLayer as JaxEncoderLayer
    from mesm_tpu.models.t2v import T2VLayer as JaxT2VLayer

    key = jax.random.PRNGKey(seed)
    if flavor == "encoder":
        layer = JaxEncoderLayer(d, H, f, dropout=0.0)
        params = layer.init(key, c["x"], c["mask"], c["pos"])["params"]
    else:
        layer = JaxT2VLayer(d, H, f, dropout=0.0)
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


def _port_layer(flavor: str, state=None, d: int = D, f: int = F):
    layer = (TransformerEncoderLayer(d, H, f, dropout=0.0) if flavor == "encoder"
             else T2VLayer(d, H, f, dropout=0.0)).eval()
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
    _check_against_pallas(flavor, pair, dtype, D, F, seed=3 + pair)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flavor", ["encoder", "t2v"])
def test_plain_version_matches_pallas_kernel_at_odd_widths(flavor, dtype):
    """D 48 (head_dim 12: the CUDA kernel pads each head to 16) and F 80,
    neither a multiple of 32, with the pair mask: the plain version, which
    the kernel is held to on the card, is the Pallas function there too."""
    _check_against_pallas(flavor, True, dtype, 48, 80, seed=21)


def _check_against_pallas(flavor: str, pair: bool, dtype: str, d: int, f: int, seed: int):
    from test_layer_kernel import map_params

    c = _case(flavor, pair, seed=seed, d=d)
    params = _jax_layer(flavor, c, seed=5, d=d, f=f)
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

    layer = _port_layer(flavor, layer_state_dict_from_jax_params(params, flavor), d=d, f=f)
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


def test_padded_head_dim_is_the_next_instance():
    """Every head_dim up to 128 runs on the smallest instance at least its
    width (16, 32, 64, 128); wider heads have none."""
    for hd in range(1, 130):
        want = next((p for p in (16, 32, 64, 128) if p >= hd), None)
        assert sl.padded_head_dim(hd) == want


def _params(d: int, f: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"w1": (f, d), "b1": (f,), "w2": (d, f), "alpha": (1,)}
    return {n: torch.randn(*shapes.get(n, (d, d) if n in ("wq", "wk", "wv", "wo") else (d,)),
                           generator=g) for n in sl.WEIGHT_NAMES}


def _tile(flat: torch.Tensor, index: int, rows: int, bf16: bool):
    """Tile `index` of a flat tile array as the kernel addresses it
    (stream_layer.cu): bf16 (rows x 64), element (n, k) at n * 64 +
    ((k >> 3) ^ (n & 7)) * 8 + (k & 7); fp32 (hi, lo), each (rows x 32) at
    a row stride of 36, lo after rows x 36 floats of hi."""
    n = torch.arange(rows)[:, None]
    if bf16:
        t = flat[index * rows * 64:(index + 1) * rows * 64]
        k = torch.arange(64)[None, :]
        return t[n * 64 + (((k >> 3) ^ (n & 7)) << 3) + (k & 7)]
    t = flat[index * rows * 72:(index + 1) * rows * 72]
    k = torch.arange(32)[None, :]
    return t[n * 36 + k], t[rows * 36 + n * 36 + k]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d,heads,f,group", [(48, 4, 80, 1), (96, 3, 160, 2), (256, 8, 1024, 4),
                                             (256, 8, 1024, 1)])
def test_layout_weights_put_each_weight_where_the_kernel_reads_it(d, heads, f, group, bf16):
    """layout_weights read back through the kernel's addressing: phase 1's
    tile (head group, k / v / q, depth tile) holds the group's heads' rows
    of wk, wv, wq (hd rows padded to hdp, D to Dq, the heads to a multiple
    of the group, with zeros); phase 2's stream, tile by tile
    in the order the kernel takes them, Wo with head h's columns at h * hdp,
    then per 64 hidden columns W1's rows and W2's columns; the biases
    padded alike. bf16 tiles hold the weights rounded to bf16, fp32 tiles
    hi = tf32(w) and lo = tf32(w - hi)."""
    p = _params(d, f)
    w = sl.layout_weights(p, heads, bf16, group)
    hd = d // heads
    hdp = sl.padded_head_dim(hd)
    Hp = -(-heads // group) * group
    Dq, Ka, Fp = -(-d // 64) * 64, -(-(heads * hdp) // 64) * 64, -(-f // 64) * 64
    depth = 64 if bf16 else 32
    nk = Dq // depth

    def check(tile, want):
        if bf16:
            assert torch.equal(tile.float(), want.to(torch.bfloat16).float())
        else:
            hi, lo = tile
            assert torch.equal(hi, sl._tf32(want)) and torch.equal(lo, sl._tf32(want - hi))
            assert ((hi + lo - want).abs() <= 2.0**-20 * want.abs()).all()

    for which, name in enumerate(("wk", "wv", "wq")):
        wp = torch.zeros(Hp, hdp, Dq)
        wp[:heads, :hd, :d] = p[name].reshape(heads, hd, d)
        for grp in range(Hp // group):
            for kc in range(nk):
                check(_tile(w["w1s"], (grp * 3 + which) * nk + kc, group * hdp, bf16),
                      wp[grp * group:(grp + 1) * group, :, kc * depth:(kc + 1) * depth]
                      .reshape(group * hdp, depth))
    bqkv = w["bqkv"].reshape(3, Hp, hdp)
    for which, name in enumerate(("bk", "bv", "bq")):
        assert torch.equal(bqkv[which, :heads, :hd], p[name].reshape(heads, hd))
        assert not bqkv[which, :, hd:].any() and not bqkv[which, heads:].any()
    wo = torch.zeros(Dq, Ka)
    wo[:d, :heads * hdp].reshape(d, heads, hdp)[:, :, :hd] = p["wo"].reshape(d, heads, hd)
    w1 = torch.zeros(Fp, Dq)
    w1[:f, :d] = p["w1"]
    w2 = torch.zeros(Dq, Fp)
    w2[:d, :f] = p["w2"]
    expect = [wo[nb * 64:nb * 64 + 64, kc * depth:kc * depth + depth]
              for nb in range(Dq // 64) for kc in range(Ka // depth)]
    for j in range(Fp // 64):
        expect += [w1[j * 64:j * 64 + 64, kc * depth:kc * depth + depth] for kc in range(nk)]
        expect += [w2[nb * 64:nb * 64 + 64, j * 64 + kc * depth:j * 64 + kc * depth + depth]
                   for nb in range(Dq // 64) for kc in range(64 // depth)]
    assert w["w2s"].numel() == len(expect) * 64 * (64 if bf16 else 72)
    for i, want in enumerate(expect):
        check(_tile(w["w2s"], i, 64, bf16), want)
    for name, width in (("bo", Dq), ("b1", Fp), ("b2", Dq)):
        n = p[name].numel()
        assert w[name].shape == (width,) and torch.equal(w[name][:n], p[name])
        assert not w[name][n:].any()
    for name in ("ln1s", "ln1b", "ln2s", "ln2b", "alpha"):
        assert torch.equal(w[name], p[name]) and w[name].data_ptr() != p[name].data_ptr()


def test_kernel_weights_are_laid_out_once_per_weight_version():
    """kernel_weights keeps one layout per version of the 17 parameters,
    dtype, head count and head group (ops/_weight_cache.derived): unchanged parameters
    reuse it, an in-place update lays them out again, and a freed set of
    parameters leaves no entry."""
    import gc
    import weakref

    p = _params(48, 80, seed=1)
    before = sl.weight_layouts
    a = sl.kernel_weights(p, 4, torch.bfloat16)
    assert sl.kernel_weights(p, 4, torch.bfloat16) is a and sl.weight_layouts == before + 1
    sl.kernel_weights(p, 4, torch.float32)
    sl.kernel_weights(p, 2, torch.bfloat16)
    sl.kernel_weights(p, 4, torch.bfloat16, 2)
    assert sl.weight_layouts == before + 4
    with torch.no_grad():
        p["w2"].add_(1.0)
    b = sl.kernel_weights(p, 4, torch.bfloat16)
    assert b is not a and sl.weight_layouts == before + 5
    assert torch.equal(b["w2s"], sl.layout_weights(p, 4, True)["w2s"])
    assert not torch.equal(a["w2s"], b["w2s"])
    key, alive = id(p["wq"]), weakref.ref(b["w2s"])
    assert key in sl._weight_cache
    del p, a, b
    gc.collect()
    assert key not in sl._weight_cache and alive() is None


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
    """Inputs and weights on the card: padded keys, sample 1 (where B > 1)
    with every key masked; with `pair`, pair factors and sample 2 (where B
    > 2) with every pair masked."""
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
        if B > 2:
            qf[2], kf[2] = True, True
        pf = (qf, kf)
    mask = torch.arange(Lk, device=device)[None] < torch.randint(1, Lk + 1, (B,), generator=g,
                                                                  device=device)[:, None]
    if B > 1:
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
    ("encoder", (3, 70, 70, 48, 4, 80), True), ("t2v", (3, 70, 1, 48, 4, 80), True),
    ("t2v", (3, 70, 17, 48, 4, 80), False), ("encoder", (1, 33, 33, 256, 8, 1024), True),
    ("encoder", (2, 70, 70, 256, 2, 96), True), ("encoder", (2, 601, 601, 256, 8, 64), False),
], ids=["encoder", "t2v", "t2v-ragged", "encoder-pair", "encoder-d48", "t2v-d48-lk1",
        "t2v-d48-lk17", "encoder-b1", "encoder-hd128", "encoder-601-keys"])
def test_stream_layer_kernel_matches_plain(cuda, flavor, shape, pair, dtype):
    """The charades widths (16 samples), a ragged T2V shape (tails in every
    product), the encoder under a pair mask, D 48 (head_dim 12, padded to
    16) with F 80 at one and 17 keys, one sample, head_dim 128, and 601 keys
    (fp32 takes them in chunks): fp32 within 1e-4 (1024-term sums in another
    order, through two LayerNorms), bf16 within 0.05 (one flipped bf16 step
    of the hidden propagates through LN2), in units of max(1, |plain|)."""
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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "uint8", "float64"])
def test_layout_anchor_kernel_is_bit_equal(cuda, dtype):
    """A contiguous input, a (B, D, L) tensor viewed as (B, L, D) (L 37 and
    40: columns off and on 16-byte boundaries), the [:, 1:] slice of a
    stream, and a view with no unit stride: a fresh row-major tensor with
    the same bits, one launch each, for 2, 4, 1 and 8-byte elements."""
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    base = torch.randint(-100, 100, (8, 64, 41), generator=g, device=cuda).to(dt)
    views = (base.transpose(1, 2).contiguous(), base[..., :37].contiguous().transpose(1, 2),
             base[..., :40].contiguous().transpose(1, 2), base.transpose(1, 2).contiguous()[:, 1:],
             base[:, ::2].transpose(1, 2))
    for x in views:
        before = anchor.launches
        got = anchor.layout_anchor(x)
        torch.cuda.synchronize()
        assert anchor.launches == before + 1
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
        assert torch.equal(got.view(torch.uint8), anchor.layout_anchor_reference(x).view(torch.uint8))
