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
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,N", [("bfloat16", 24960), ("float32", 9616), ("bfloat16", 51)])
def test_ffn_int8_kernel_matches_plain(cuda, dtype, N):
    """The charades site (bf16) and the TACoS site (fp32) at width 256 and
    FFN 1024, and a ragged tail: the integer sums are exact and the rounding
    points the plain version's, so within one bf16 step of the output."""
    x, w1, b1, alpha, w2, b2 = _mk(3, N, 256, 1024)
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
