"""The fused int8 FFN: the port's plain version against the JAX package's
Pallas kernel in interpret mode and its XLA oracle, the int8 gate against
the JAX gate, and the int8 model forward against the JAX model's.

Tolerances. The quantized weights are equal. The plain version takes the
kernel's stages with every bf16 op rounded, as torch rounds; XLA may keep
the jitted kernel's bf16 chain in f32, and one rounding step of h can flip
an element of hq by one, so against the interpret-mode kernel the bound is
the JAX tests' own (atol 5e-2, tests/test_ffn_int8.py:27), with the share
of bit-equal outputs printed; the eager XLA oracle rounds as torch does and
is held to the same bound. The model forward in fp32 with the int8 FFN on
both sides: 5e-2 in units of max(1, max |reference|) per output. Tests
marked `cuda` hold the CUDA kernel against the plain version on the card
and skip here.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu import kernels as jkernels
from mesm_tpu.ops import ffn_pallas
from mesm_tpu_torch import kernels
from mesm_tpu_torch.models import layers
from mesm_tpu_torch.ops import ffn_int8 as fi

from chip_smoke import FFN_EDGE_N

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MODEL_TOL = 5e-2


def _mk(seed, N, K, N1):
    """x, and w1 (K, N1), b1, alpha, w2 (N1, K), b2 in the JAX package's
    (in, out) layout, as tests/test_ffn_int8.py makes them at K = 32, N1 =
    64 (weights 0.1 N(0, 1)); wider weights shrink with the square root of
    their fan-in, so the outputs keep that scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, K)).astype(np.float32)
    w1 = (rng.normal(size=(K, N1)) * 0.1 * (32 / K) ** 0.5).astype(np.float32)
    b1 = (rng.normal(size=(N1,)) * 0.1).astype(np.float32)
    alpha = np.array([0.25], np.float32)
    w2 = (rng.normal(size=(N1, K)) * 0.1 * (64 / N1) ** 0.5).astype(np.float32)
    b2 = (rng.normal(size=(K,)) * 0.1).astype(np.float32)
    return x, w1, b1, alpha, w2, b2


def _torch_args(x, w1, b1, alpha, w2, b2, dtype):
    """The same arguments in torch Linear layout: weights (out, in)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(x).to(TORCH_DT[dtype]), t(w1.T), t(b1), t(alpha), t(w2.T), t(b2)


@pytest.mark.parametrize("K,N1", [(32, 64), (64, 128), (256, 1024)])
def test_quantized_weights_equal_jax(K, N1):
    """w1q / w2q and their scales equal the JAX package's
    (ffn_pallas.py:107-112), the weights in the other layout."""
    _, w1, _, _, w2, _ = _mk(0, 1, K, N1)
    w1[0, :3] = 0.0  # a few exact zeros and a column's amax on a tie
    for w in (w1, w2):
        wf = jnp.asarray(w)
        s = jnp.maximum(jnp.max(jnp.abs(wf), axis=0, keepdims=True), 1e-8) / 127.0
        want_q = np.asarray(jnp.round(wf / s).astype(jnp.int8))
        got_q, got_s = fi.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
        np.testing.assert_array_equal(got_q.numpy().T, want_q)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(s)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N1", [(32, 64), (64, 128), (256, 1024)])
def test_plain_version_matches_pallas_and_oracle(K, N1, dtype):
    """Ragged rows (3 x 17 = 51, not a multiple of the kernel's row tile),
    bf16 and fp32 x."""
    x, w1, b1, alpha, w2, b2 = _mk(1, 51, K, N1)
    x3 = x.reshape(3, 17, K)
    jx = jnp.asarray(x3, JAX_DT[dtype])
    kern = np.asarray(ffn_pallas.ffn_int8(jx, w1, b1, alpha, w2, b2, interpret=True)
                      .astype(jnp.float32))
    oracle = np.asarray(ffn_pallas.ffn_int8_reference(jx, w1, b1, alpha, w2, b2)
                        .astype(jnp.float32))
    got = fi.ffn_int8(*_torch_args(x3, w1, b1, alpha, w2, b2, dtype))
    assert got.dtype == TORCH_DT[dtype] and got.shape == (3, 17, K)
    got = got.float().numpy()
    print(f"bit-equal share: vs the interpret-mode kernel {np.mean(got == kern):.4f}, "
          f"vs the XLA oracle {np.mean(got == oracle):.4f}")
    np.testing.assert_allclose(got, kern, atol=5e-2, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=5e-2, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_at_widths_off_the_tiles(dtype):
    """K 48 / N1 80 / K2 48, no multiple of 32 (the kernel pads them in its
    staged weights), against the Pallas kernel in interpret mode and the
    XLA oracle, as above."""
    x, w1, b1, alpha, w2, b2 = _mk(7, 51, 48, 80)
    jx = jnp.asarray(x, JAX_DT[dtype])
    kern = np.asarray(ffn_pallas.ffn_int8(jx, w1, b1, alpha, w2, b2, interpret=True)
                      .astype(jnp.float32))
    oracle = np.asarray(ffn_pallas.ffn_int8_reference(jx, w1, b1, alpha, w2, b2)
                        .astype(jnp.float32))
    got = fi.ffn_int8(*_torch_args(x, w1, b1, alpha, w2, b2, dtype)).float().numpy()
    print(f"bit-equal share: vs the interpret-mode kernel {np.mean(got == kern):.4f}")
    np.testing.assert_allclose(got, kern, atol=5e-2, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=5e-2, rtol=0)


def _big_sums(seed: int, N: int, K: int, N1: int):
    """Inputs whose linear2 sums pass 2**24: positive x, and weights near a
    positive constant, so that every h is positive and near the row's amax
    (hq ~ 127) and every w2q near 127: sums ~ 127 * 127 * N1."""
    rng = np.random.default_rng(seed)
    x = (1.0 + rng.random((N, K))).astype(np.float32)
    w1 = (1.0 + 0.05 * rng.random((K, N1))).astype(np.float32) / K
    b1 = (0.01 * rng.random(N1)).astype(np.float32)
    w2 = (1.0 + 0.05 * rng.random((N1, K))).astype(np.float32) / N1
    b2 = (0.01 * rng.random(K)).astype(np.float32)
    return x, w1, b1, np.array([0.25], np.float32), w2, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_sums_exactly_past_2_24(dtype):
    """N1 2048 (the model's --dim_feedforward 2048) on inputs whose integer
    sums pass 2**24, where f32 sums are no longer exact: the plain version
    (f64 sums, int -> f32 -> bf16 as XLA converts s32 to bf16) against the
    Pallas kernel in interpret mode and the XLA oracle within the bound
    above, bit for bit against the oracle (its int32 sums are exact and it
    rounds as torch does; the jitted kernel keeps its bf16 chain in f32),
    and those sums do pass 2**24."""
    x, w1, b1, alpha, w2, b2 = _big_sums(8, 40, 256, 2048)
    jx = jnp.asarray(x, JAX_DT[dtype])
    kern = np.asarray(ffn_pallas.ffn_int8(jx, w1, b1, alpha, w2, b2, interpret=True)
                      .astype(jnp.float32))
    oracle = np.asarray(ffn_pallas.ffn_int8_reference(jx, w1, b1, alpha, w2, b2)
                        .astype(jnp.float32))
    args = _torch_args(x, w1, b1, alpha, w2, b2, dtype)
    got = fi.ffn_int8(*args).float().numpy()
    print(f"bit-equal share: vs the interpret-mode kernel {np.mean(got == kern):.4f}")
    np.testing.assert_allclose(got, kern, atol=5e-2, rtol=0)
    np.testing.assert_array_equal(got, oracle)
    # the largest of linear2's integer sums, from the plain version's stages
    bf = torch.bfloat16
    xt, w1t, b1t, at, w2t, _ = args
    w1q, s1 = fi.quantize_weight(w1t)
    w2q, _ = fi.quantize_weight(w2t)
    xs = fi._row_scale(xt.float().abs().amax(-1, keepdim=True))
    xq = fi._to_i8(xt.to(bf) * fi._div(1.0, xs).to(bf))
    h = (torch.matmul(xq.double(), w1q.double().t()).float().to(bf) * s1.to(bf) * xs.to(bf)
         + b1t.to(bf))
    hr = fi._div(127.0, torch.clamp(h.float().abs().amax(-1, keepdim=True), min=1e-8)).to(bf)
    acc2 = torch.matmul(fi._to_i8(h * hr).double(), w2q.double().t())
    assert float(acc2.abs().max()) > 2**24


def test_quantization_error_vs_exact():
    """The int8 FFN stays within 2 % (mean relative) of the exact FFN."""
    x, w1, b1, alpha, w2, b2 = _mk(2, 256, 64, 128)
    got = fi.ffn_int8(*_torch_args(x, w1, b1, alpha, w2, b2, "float32")).numpy()
    h = x @ w1 + b1
    exact = (np.maximum(h, 0) + 0.25 * np.minimum(h, 0)) @ w2 + b2
    assert np.abs(got - exact).mean() / np.abs(exact).mean() < 0.02


def test_round_saturates_like_xla():
    """A product that rounds to 128 takes 127, as XLA's f32 -> int8."""
    v = torch.tensor([127.5, 128.0, -128.5, -300.0, 2.5, -2.5])
    want = np.asarray(jnp.round(jnp.asarray(v.numpy())).astype(jnp.int8))
    np.testing.assert_array_equal(fi._to_i8(v).numpy().astype(np.int8), want)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


class _Called(Exception):
    pass


def _jax_takes_int8(rows: int, d: int, activation: str, training: bool) -> bool:
    """Whether the JAX FFN module reaches ffn_int8 (its call is stubbed to
    raise)."""
    from mesm_tpu.models.layers import FFN  # flax: imported where it is used

    x = jnp.zeros((rows, d), jnp.float32)
    ffn = FFN(dim_feedforward=2 * d, d_model=d, dropout=0.0, activation=activation)
    params = ffn.init(jax.random.PRNGKey(0), x[:1], deterministic=True)["params"]
    try:
        ffn.apply({"params": params}, x, deterministic=not training,
                  rngs={"dropout": jax.random.PRNGKey(1)})
    except _Called:
        return True
    return False


def _port_takes_int8(rows: int, d: int, activation: str, training: bool) -> bool:
    x = torch.zeros(rows, d)
    act = layers.make_activation(activation)
    try:
        layers.ffn(x, layers.Linear(d, 2 * d), act, layers.Linear(2 * d, d), torch.nn.Identity(),
                   training)
    except _Called:
        return True
    return False


def _raise(*args, **kwargs):
    raise _Called


@pytest.mark.parametrize("on_card", [True, False])
def test_int8_gate_matches_jax(monkeypatch, on_card):
    """Over mode x INT8_FFN x training x activation x rows either side of
    INT8_FFN_MIN_ROWS, the port's FFN takes the int8 kernel exactly where the
    JAX FFN module does; "on the card" is the CUDA device for the port and
    the TPU backend for JAX, and off it neither takes it, even under "on"."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu" if on_card else "cpu")
    monkeypatch.setattr(kernels, "_on_cuda", lambda device: on_card)
    monkeypatch.setattr(ffn_pallas, "ffn_int8", _raise)
    monkeypatch.setattr(layers, "ffn_int8", _raise)
    assert kernels.INT8_FFN_MIN_ROWS == 4096
    cases = []
    for mode, flag, training, act, rows in itertools.product(
            ["auto", "on", "off"], [False, True], [False, True], ["prelu", "relu"], [4095, 4096]):
        monkeypatch.setattr(jkernels, "INT8_FFN", flag)
        kernels.set_int8_ffn(flag)
        try:
            with jkernels.pallas_scope(mode):
                want = _jax_takes_int8(rows, 8, act, training)
            with kernels.pallas_scope(mode):
                got = _port_takes_int8(rows, 8, act, training)
                assert kernels.use_int8_ffn("cuda") == (flag and on_card and mode != "off")
        finally:
            kernels.set_int8_ffn(False)
        cases.append(want)
        assert got == want, (mode, flag, training, act, rows)
    assert any(cases) == on_card


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# one layer per stack, narrow widths; 32 rows of 128 clips give the
# enhance, T2V and DETR encoder FFNs >= 4096 rows each (the decoder's 32 x 5
# and SS-recon's stay plain)
MODEL = dict(
    hidden_dim=32, v_feat_dim=70, t_feat_dim=20, nheads=4, dim_feedforward=64,
    num_recfw_layers=1, t2v_layers=1, enc_layers=1, dec_layers=2, num_recss_layers=1,
    num_queries=5, max_words_l=8, max_video_l=128, num_classes=30,
)
MB, MLV, MG = 32, 128, 3


def test_int8_model_forward_matches_jax(monkeypatch):
    """The port's MESM eval forward with the int8 FFN against mesm_tpu's (its
    Pallas kernel in interpret mode), fp32 activations: the same int8 sites
    on both sides, predictions within MODEL_TOL."""
    from mesm_tpu.models.mesm import MESM as JaxMESM
    from mesm_tpu.models.mesm import MESMConfig as JaxConfig
    from mesm_tpu_torch.convert import state_dict_from_jax_params
    from mesm_tpu_torch.models.mesm import MESM as TorchMESM
    from mesm_tpu_torch.models.mesm import MESMConfig as TorchConfig

    from synth import make_batch
    from test_torch_harness import jax_init

    batch = make_batch(np.random.default_rng(0), B=MB, Lv=MLV, Dv=MODEL["v_feat_dim"],
                       Lw=MODEL["max_words_l"], Dt=MODEL["t_feat_dim"], G=MG)
    jcfg = JaxConfig(**MODEL)
    params = jax_init(jcfg, batch)
    tmodel = TorchMESM(TorchConfig(**MODEL))
    tmodel.load_state_dict(state_dict_from_jax_params(params, tmodel.cfg), strict=True)
    tmodel.eval()

    sites = {"jax": [], "torch": []}
    jorig, torig = ffn_pallas.ffn_int8, layers.ffn_int8

    def jcount(x, *a, **kw):
        sites["jax"].append(int(np.prod(x.shape[:-1])))
        return jorig(x, *a, **kw)

    def tcount(x, *a, **kw):
        sites["torch"].append(x.numel() // x.shape[-1])
        return torig(x, *a, **kw)

    monkeypatch.setattr(ffn_pallas, "ffn_int8", jcount)
    monkeypatch.setattr(layers, "ffn_int8", tcount)
    monkeypatch.setattr(jkernels, "use_int8_ffn", lambda: True)
    monkeypatch.setattr(kernels, "use_int8_ffn", lambda device: True)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = JaxMESM(jcfg).apply(
        {"params": params}, None, jb["video_mask"], jb["words_feat"], jb["words_mask"],
        jb["sentence_feat"], jnp.zeros((MB,), jnp.int32),
        is_training=False, deterministic=True, compute_neg=False,
        video_feat_g=jb["video_feat_g"], video_mask_g=jb["video_mask_g"],
        video_slot=jb["video_slot"], ss_sent_idx=jb["ss_sent_idx"],
        ss_sent_mask=jb["ss_sent_mask"], ss_own_pos=jb["ss_own_pos"],
    )
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        tout = tmodel(
            t["video_mask"], t["words_feat"], t["words_mask"], t["sentence_feat"],
            video_feat_g=t["video_feat_g"], video_mask_g=t["video_mask_g"],
            video_slot=t["video_slot"], ss_sent_idx=t["ss_sent_idx"],
            ss_sent_mask=t["ss_sent_mask"], ss_own_pos=t["ss_own_pos"],
        )
    assert sites["torch"] == sites["jax"] and len(sites["torch"]) == 3, sites
    assert min(sites["torch"]) >= kernels.INT8_FFN_MIN_ROWS
    for k, v in tout.items():
        want = np.asarray(jout[k], np.float32)
        got = v.float().numpy()
        assert got.shape == want.shape, k
        err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
        print(f"{k}: {err:.3e}")
        assert err <= MODEL_TOL, (k, err)


# ---------------------------------------------------------------------------
# the quantized weights' cache and the kernel's staging order
# ---------------------------------------------------------------------------


def _ffn_module(seed=0, K=64, N1=128):
    """A module holding the five FFN parameters, as a model layer does."""
    torch.manual_seed(seed)
    m = torch.nn.Module()
    m.lin1 = torch.nn.Linear(K, N1)
    m.lin2 = torch.nn.Linear(N1, K)
    m.alpha = torch.nn.Parameter(torch.full((1,), 0.25))
    return m


def _params(m):
    return m.lin1.weight, m.lin1.bias, m.alpha, m.lin2.weight, m.lin2.bias


def _expected_values(w1, b1, alpha, w2, b2):
    bf = torch.bfloat16
    w1q, s1 = fi.quantize_weight(w1.detach())
    w2q, s2 = fi.quantize_weight(w2.detach())
    return (w1q, s1.to(bf), b1.detach().to(bf), alpha.detach().to(bf).reshape(1), w2q,
            s2.to(bf), b2.detach().to(bf))


def _assert_bit_equal(values, want):
    assert len(values) == len(want)
    for got, ref in zip(values, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref)


def test_weight_cache_reuses_the_entry_of_unchanged_parameters():
    """The same five tensors, unchanged, give the very same cached tensors
    and quantize once; the values are quantize_weight's, bit for bit, and
    share no memory with a parameter."""
    m = _ffn_module()
    before = fi.weight_quantizations
    first = fi.quantized_weights(*_params(m))
    second = fi.quantized_weights(*_params(m))
    assert first is second
    assert fi.weight_quantizations == before + 1
    _assert_bit_equal(first, _expected_values(*_params(m)))
    ptrs = {t.data_ptr() for t in _params(m)}
    assert not any(t.data_ptr() in ptrs for t in first)


@pytest.mark.parametrize("update", ["add_", "load_state_dict", "copy_", "bias"])
def test_weight_cache_refreshes_after_an_in_place_update(update):
    """An in-place update of a parameter (an optimizer-like add_ under
    no_grad, load_state_dict, copy_, or a bias) bumps its version: the next
    call quantizes again, bit-equal to quantize_weight of the new values."""
    m = _ffn_module()
    old = fi.quantized_weights(*_params(m))
    before = fi.weight_quantizations
    with torch.no_grad():
        if update == "add_":
            m.lin1.weight.add_(0.5 * torch.randn_like(m.lin1.weight))
        elif update == "load_state_dict":
            m.load_state_dict(_ffn_module(seed=1).state_dict())
        elif update == "copy_":
            m.lin2.weight.copy_(_ffn_module(seed=2).lin2.weight)
        else:
            m.lin2.bias.add_(1.0)
    new = fi.quantized_weights(*_params(m))
    assert new is not old
    assert fi.weight_quantizations == before + 1
    _assert_bit_equal(new, _expected_values(*_params(m)))
    assert fi.quantized_weights(*_params(m)) is new


def test_weight_cache_keeps_nothing_of_a_freed_module():
    """The cache holds the parameters by weak reference only: deleting the
    module frees its entry, and with it the quantized weights."""
    import gc
    import weakref

    m = _ffn_module()
    values = fi.quantized_weights(*_params(m))
    fi.staged_weights(*_params(m), 32)
    key = id(m.lin1.weight)
    assert key in fi._weight_cache
    alive = weakref.ref(values[0])
    del m, values
    gc.collect()
    assert key not in fi._weight_cache
    assert alive() is None


def _canonical(r, k, cols):
    """Byte offset of (row r, byte k) of a (rows x cols) piece in wgmma's
    K-major layout without swizzle."""
    return (r // 8) * (cols // 16) * 128 + (k // 16) * 128 + (r % 8) * 16 + k % 16


@pytest.mark.parametrize("N1,K,K2,nc", [(96, 64, 288, 64), (1024, 256, 256, 64), (32, 32, 32, 32),
                                        (64, 1024, 256, 32), (80, 48, 48, 64), (2048, 256, 256, 64),
                                        (70, 33, 45, 32)])
def test_stage_weights_puts_each_byte_where_the_kernel_reads_it(N1, K, K2, nc):
    """stage_weights against the kernel's addressing written out, for Kp = K
    rounded up to 32: w1 chunk j at j * nc * Kp, byte (n, k) of it at the
    canonical offset; w2 block (ob, j) at (ob * J + j) * 256 * nc; zeros
    past K, N1 and K2."""
    g = torch.Generator().manual_seed(N1 + K)
    w1q = torch.randint(-127, 128, (N1, K), generator=g, dtype=torch.int8)
    w2q = torch.randint(-127, 128, (K2, N1), generator=g, dtype=torch.int8)
    w1s, w2s = fi.stage_weights(w1q, w2q, nc)
    J = -(-N1 // nc)
    nob = -(-K2 // fi.KO)
    Kp = -(-K // 32) * 32
    assert w1s.numel() == J * nc * Kp and w2s.numel() == nob * J * fi.KO * nc
    n = torch.arange(J * nc)[:, None]
    k = torch.arange(Kp)[None, :]
    idx = (n // nc) * nc * Kp + _canonical(n % nc, k, Kp)
    want = torch.zeros(J * nc, Kp, dtype=torch.int8)
    want[:N1, :K] = w1q
    assert torch.equal(w1s[idx], want)
    o = torch.arange(nob * fi.KO)[:, None]
    h = torch.arange(J * nc)[None, :]
    idx = ((o // fi.KO) * J + h // nc) * fi.KO * nc + _canonical(o % fi.KO, h % nc, nc)
    want = torch.zeros(nob * fi.KO, J * nc, dtype=torch.int8)
    want[:K2, :N1] = w2q
    assert torch.equal(w2s[idx], want)


def test_stage_vectors_pad_with_zeros():
    """The bf16 scales and biases as the kernel reads them: linear1's to a
    multiple of 64 hidden columns, linear2's to one of 256 outputs, zeros
    beyond; and staged_weights keeps them with the int8 weights, per weight
    version and chunk width."""
    bf = torch.bfloat16
    s1, b1, s2, b2 = (torch.arange(1, n + 1, dtype=bf) for n in (70, 70, 45, 45))
    ps1, pb1, ps2, pb2 = fi.stage_vectors(s1, b1, s2, b2)
    for got, v, width in ((ps1, s1, 128), (pb1, b1, 128), (ps2, s2, 256), (pb2, b2, 256)):
        assert got.dtype == bf and got.shape == (width,)
        assert torch.equal(got[:v.numel()], v) and not got[v.numel():].any()
    m = _ffn_module(K=48, N1=80)
    staged = fi.staged_weights(*_params(m), 64)
    assert fi.staged_weights(*_params(m), 64) is staged and len(staged) == 6
    _, s1q, b1q, _, _, s2q, b2q = fi.quantized_weights(*_params(m))
    for got, want in zip(staged[2:], fi.stage_vectors(s1q, b1q, s2q, b2q)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,N,K,N1", [
    ("bfloat16", 24960, 256, 1024), ("float32", 9616, 256, 1024), ("bfloat16", 51, 256, 1024),
] + [(dtype, N, K, N1)  # the tile edges, at the model's widths and the smallest
     for dtype, N, (K, N1) in itertools.product(("bfloat16", "float32"), FFN_EDGE_N,
                                                ((1024, 1024), (32, 32)))
] + [(dtype, N, K, N1)  # widths off the tiles, and the model's FFN 2048
     for dtype, N, (K, N1) in itertools.product(("bfloat16", "float32"), (1, 129, 4096),
                                                ((48, 80), (33, 70), (256, 2048), (1248, 100)))])
def test_ffn_int8_kernel_matches_plain(cuda, dtype, N, K, N1):
    """The charades site (bf16) and the TACoS site (fp32) at width 256 and
    FFN 1024, a ragged tail, and rows around the kernel's 64- and 128-row
    tiles at K = N1 = 1024 and 32, widths that are no multiple of 32 (K 48,
    N1 80; K 33, N1 70), FFN 2048, and the widest K the 64-row tile holds
    (1,248), with a row of zeros (the 1e-8 floor) and
    a row of +-1000 (every element at +-127): the integer sums are exact and
    the rounding points the plain version's, so within one bf16 step of the
    output."""
    x, w1, b1, alpha, w2, b2 = _mk(3, N, K, N1)
    x[0] = 0.0
    if N > 1:
        x[1] = 1000.0 * (1 - 2 * (np.arange(K) % 2))
    args = [a.to(cuda) for a in _torch_args(x, w1, b1, alpha, w2, b2, dtype)]
    before = fi.launches
    got = fi.ffn_int8(*args)
    want = fi.ffn_int8_reference(*args)
    torch.cuda.synchronize()
    assert fi.launches == before + 1
    assert torch.isfinite(got).all() and got.dtype == args[0].dtype
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1))
    print(f"max err {err:.3e}, bit-equal share {float((got == want).float().mean()):.6f}")
    assert err <= 2.0**-7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ffn_int8_kernel_sums_exactly_past_2_24(cuda, dtype):
    """N1 2048 on inputs whose integer sums pass 2**24 (and K2 45, odd: the
    outputs stored column by column): the kernel's int32 sums and the plain
    version's f64 sums are exact, both round int -> f32 -> bf16, so the two
    agree within one bf16 step."""
    x, w1, b1, alpha, w2, b2 = _big_sums(9, 300, 256, 2048)
    args = [a.to(cuda) for a in _torch_args(x, w1, b1, alpha, w2, b2, dtype)]
    for w2c, b2c in ((args[4], args[5]), (args[4][:45].contiguous(), args[5][:45].contiguous())):
        a = args[:4] + [w2c, b2c]
        got, want = fi.ffn_int8(*a), fi.ffn_int8_reference(*a)
        torch.cuda.synchronize()
        err = float(((got.float() - want.float()).abs() / want.float().abs().clamp(min=1)).max())
        print(f"max err {err:.3e}, bit-equal share {float((got == want).float().mean()):.6f}")
        assert torch.isfinite(got).all() and err <= 2.0**-7


@pytest.mark.cuda
def test_ffn_int8_quantizes_once_per_weight_version(cuda):
    """Calls on unchanged weights reuse the cached quantized weights; an
    in-place update of w1 makes the next call quantize again, and the kernel
    then matches the plain version on the new weights."""
    x, w1, b1, alpha, w2, b2 = _mk(4, 300, 256, 1024)
    args = [a.to(cuda) for a in _torch_args(x, w1, b1, alpha, w2, b2, "bfloat16")]
    before = fi.weight_quantizations
    for _ in range(3):
        fi.ffn_int8(*args)
    assert fi.weight_quantizations == before + 1
    with torch.no_grad():
        args[1].mul_(1.5)
    got = fi.ffn_int8(*args)
    want = fi.ffn_int8_reference(*args)
    torch.cuda.synchronize()
    assert fi.weight_quantizations == before + 2
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1))
    assert err <= 2.0**-7
