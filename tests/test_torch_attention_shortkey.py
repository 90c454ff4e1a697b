"""The short-key and pair-masked attention kernels' plain versions against
the JAX package's Pallas kernels, and the port's attention routing against
the JAX package's.

On the CPU the wrappers run their plain versions:
`attention_packed_pair` (kernel 3) meets `_fused_attention_impl(...,
variant="packed", qf, kf)` with 64 keys or more, `attention_shortkey`
(kernel 4) the same call with fewer than 64 keys, with and without pair
factors, and `attention_shortkey_onematmul` (kernel 5) meets
`fused_attention_shortkey`, all in interpret mode. Inputs come from a numpy
seed and cover padded keys, samples whose keys are all masked, (b, h, q)
rows that the pair mask masks fully and, for kernel 5, segments whose sums
underflow while other heads of the row stay finite. Tolerances: fp32 1e-5
in units of max(1, max |reference|) (summation order only); bf16 3e-2 abs
(bf16 keeps 8 mantissa bits; one probability or output rounding can move by
a step). Tests marked `cuda` hold each CUDA kernel against its plain version
on the card and skip here.
"""
from __future__ import annotations

import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu import kernels as jkernels
from mesm_tpu.ops import attention_pallas
from mesm_tpu.ops.attention_pallas import _fused_attention_impl, fused_attention_shortkey
from mesm_tpu_torch import kernels
from mesm_tpu_torch.models.attention import dispatch_attention_core
from mesm_tpu_torch.ops import attention_packed as ap
from mesm_tpu_torch.ops import attention_shortkey as sk

from chip_smoke import HEADS_EDGE_SHAPES, SHORTKEY_EDGE_LK, SHORTKEY_EDGE_LQ

REPO = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _case(seed, B, Lq, Lk, E, H):
    """q, k, v, a key mask with padded keys and one sample with every key
    masked, and pair factors with fully masked (b, h, q) rows: sample 2,
    head 1 flags every key, and half its queries."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, E)).astype(np.float32) for L in (Lq, Lk, Lk))
    lengths = rng.integers(Lk // 2, Lk + 1, B)
    mask = np.arange(Lk)[None] < lengths[:, None]
    mask[1] = False
    qf = rng.random((B, H, Lq)) < 0.4
    kf = rng.random((B, H, Lk)) < 0.4
    kf[2, 1] = True
    qf[2, 1, ::2] = True
    return q, k, v, mask, (qf, kf)


def _jax_packed(q, k, v, mask, pair, H, dtype):
    jdt = JAX_DT[dtype]
    qf = kf = None
    if pair is not None:  # head-major floats, as fused_attention passes them
        qf, kf = (jnp.asarray(f, jnp.float32).transpose(1, 0, 2) for f in pair)
    with jax.default_matmul_precision("highest"):
        out = _fused_attention_impl(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(mask, jnp.float32), H, True, "packed", qf, kf,
        )
    return np.asarray(out.astype(jnp.float32))


def _torch_args(q, k, v, mask, pair, dtype):
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)]
    tp = None if pair is None else tuple(torch.from_numpy(f) for f in pair)
    return t + [torch.from_numpy(mask), tp]


def _check_dead_rows(got, v, mask, pair, H, dtype) -> int:
    """Every (b, h, q) row whose keys are all masked holds the mean of v over
    all Lk keys (padded keys included) in head h's columns. Returns how many
    such rows there are."""
    B, Lq, E = got.shape
    Lk = mask.shape[1]
    hd = E // H
    dead = ~mask[:, None, None, :]
    if pair is not None:
        qf, kf = pair
        dead = dead | (qf[..., :, None] & kf[..., None, :])
    rows = np.argwhere(np.broadcast_to(dead, (B, H, Lq, Lk)).all(-1))
    vt = torch.from_numpy(v).to(TORCH_DT[dtype]).float().numpy()
    for b, h, qi in rows:
        cols = slice(h * hd, (h + 1) * hd)
        np.testing.assert_allclose(got[b, qi, cols], vt[b, :, cols].mean(0), atol=TOL[dtype])
    return len(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk", [(64, 64), (70, 81)])
def test_attention_packed_pair_reference_matches_pallas(lq, lk, dtype):
    """Kernel 3: the packed pair kernel, 64 keys or more."""
    B, E, H = 4, 64, 2
    q, k, v, mask, pair = _case(0, B, lq, lk, E, H)
    want = _jax_packed(q, k, v, mask, pair, H, dtype)
    tq, tk, tv, tm, tp = _torch_args(q, k, v, mask, pair, dtype)
    got = ap.attention_packed_pair(tq, tk, tv, H, tm, tp)
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert _check_dead_rows(got, v, mask, pair, H, dtype) > H * lq  # sample 1, and (2, 1)'s flagged rows
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_pair", [False, True])
@pytest.mark.parametrize("lk", [8, 17, 33, 63])
def test_attention_shortkey_reference_matches_pallas(lk, with_pair, dtype):
    """Kernel 4: the packed family's short-key kernel (keys 8..63)."""
    B, Lq, E, H = 4, 66, 64, 2
    q, k, v, mask, pair = _case(1, B, Lq, lk, E, H)
    pair = pair if with_pair else None
    want = _jax_packed(q, k, v, mask, pair, H, dtype)
    tq, tk, tv, tm, tp = _torch_args(q, k, v, mask, pair, dtype)
    got = sk.attention_shortkey(tq, tk, tv, H, tm, tp)
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert _check_dead_rows(got, v, mask, pair, H, dtype) >= H * Lq
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_pair", [False, True])
@pytest.mark.parametrize("lk", [9, 17, 33, 64])
def test_attention_shortkey_onematmul_reference_matches_pallas(lk, with_pair, dtype, hd):
    """Kernel 5: the one-matmul segment softmax, at head_dim 32 and 64 (the
    two the bf16 kernel takes). Sample 3's head 1 logits sit ~180 (hd 32) or
    ~250 (hd 64) above its head 0 logits (0), so head 0's segment underflows
    to a sum of 0 and takes the 1/Lk fallback. In fp32 a logit of ~250
    carries an ulp of 1.5e-5, which its exp turns into a relative error of
    the same size, so the fp32 tolerance here is 1e-4."""
    B, Lq, H = 4, 64, 2
    E = H * hd
    q, k, v, mask, pair = _case(2, B, Lq, lk, E, H)
    sign = np.sign(np.random.default_rng(9).normal(size=hd)).astype(np.float32)
    q[3, :, hd:] = 40.0 * sign
    k[3, :, hd:] = np.abs(k[3, :, hd:]) * sign
    k[3, :, :hd] = 0.0
    pair = pair if with_pair else None
    jdt = JAX_DT[dtype]
    with jax.default_matmul_precision("highest"):
        want = fused_attention_shortkey(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), H,
            jnp.asarray(mask), None if pair is None else tuple(jnp.asarray(f) for f in pair),
            interpret=True,
        )
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv, tm, tp = _torch_args(q, k, v, mask, pair, dtype)
    got = sk.attention_shortkey_onematmul(tq, tk, tv, H, tm, tp)
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert _check_dead_rows(got, v, mask, pair, H, dtype) >= H * Lq
    # sample 3, head 0: the underflowed segment is uniform over all Lk keys
    # wherever head 1 keeps a key
    vt = tv.float().numpy()
    live1 = mask[3] & ~(pair[0][3, 1][:, None] & pair[1][3, 1][None, :]) if pair else mask[3][None]
    rows = np.flatnonzero(np.broadcast_to(live1, (Lq, lk)).any(1))
    assert len(rows) > 0
    np.testing.assert_allclose(got[3, rows, :hd], np.broadcast_to(vt[3, :, :hd].mean(0), (len(rows), hd)),
                               atol=TOL[dtype])
    assert _err(got, want) <= (1e-4 if dtype == "float32" else TOL[dtype])


def test_onematmul_segment_fallback_is_uniform():
    """An underflowed segment takes 1/Lk per key (padded keys included),
    where the packed short-key kernel normalises the head on its own."""
    H, Lk, E = 2, 5, 64
    q = torch.zeros(1, 1, E)
    q[0, 0, 32:] = 1.0
    k = torch.zeros(1, Lk, E)
    k[0, :, 32:] = 500.0  # head 1 logits ~ 2800: head 0's exp(0 - 2800) underflows
    k[0, 0, :32] = 1.0
    v = torch.randn(1, Lk, E, generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([[True, True, True, False, False]])
    out = sk.attention_shortkey_onematmul(q, k, v, H, mask)
    torch.testing.assert_close(out[0, 0, :32], v[0, :, :32].mean(0), rtol=0, atol=1e-6)
    per_head = sk.attention_shortkey(q, k, v, H, mask)
    torch.testing.assert_close(per_head[0, 0, :32], v[0, :3, :32].mean(0), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# routing: the port's decisions against the JAX package's
# ---------------------------------------------------------------------------


class _Recorder:
    """Stands in for the JAX package's attention functions and records which
    one its dispatch reached, by the port's route names."""

    def __init__(self):
        self.route = "unset"

    def zeros(self, q, v):
        return jnp.zeros(q.shape[:2] + (v.shape[-1],), v.dtype)

    def fused_impl(self, q, k, v, mask, num_heads, interpret, variant="per_head", qf=None, kf=None):
        if variant == "packed":
            if k.shape[1] < attention_pallas.MIN_FUSED_LK:
                self.route = "shortkey"
            else:
                self.route = "packed_pair" if qf is not None else "packed"
        else:
            self.route = variant
        return self.zeros(q, v)

    def core(self, q, k, v, **kwargs):
        self.route = None
        return self.zeros(q, v)

    def onematmul(self, q, k, v, **kwargs):
        self.route = "shortkey_onematmul"
        return self.zeros(q, v)


@pytest.fixture
def jax_recorder(monkeypatch):
    """The JAX dispatch with "on the TPU" stubbed true and every kernel and
    core replaced by a recorder (no compute)."""
    from mesm_tpu.models import attention as jattention  # flax: imported where it is used

    rec = _Recorder()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(attention_pallas, "_fused_attention_impl", rec.fused_impl)
    monkeypatch.setattr(attention_pallas, "fused_attention_shortkey", rec.onematmul)
    for name in ("attention_core", "attention_core_shortkey", "attention_core_shortquery",
                 "_attention_core_remat"):
        monkeypatch.setattr(jattention, name, rec.core)
    orig = attention_pallas.fused_attention

    def fused_attention(q, k, v, split_qk=None, **kwargs):  # see test_torch_harness.jax_kernels
        return orig(q, k, v, **kwargs)

    monkeypatch.setattr(attention_pallas, "fused_attention", fused_attention)
    return rec, jattention


GRID = list(itertools.product(
    [4, 8, 16, 30, 128],  # B
    [10, 63, 64, 75, 194, 601],  # Lq
    [5, 8, 17, 33, 64, 76, 128, 601],  # Lk
    ["float32", "bfloat16"],
    [False, True],  # pair factors
))


@pytest.mark.parametrize("variant", ["segmm", "kernel"])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("training", [False, True])
def test_routing_matches_jax(jax_recorder, monkeypatch, mode, variant, training):
    """Over a grid of (B, Lq, Lk, dtype, pair), with "on the card" stubbed
    true on both sides (CUDA tensors' device for the port, the TPU backend
    for JAX), the kernel the port's dispatch picks is the one the JAX
    package's reaches, in eval and in a dropout-free training call, with
    both SHORTKEY_VARIANT values."""
    jax_recorder, jattention = jax_recorder
    monkeypatch.setattr(jkernels, "SHORTKEY_VARIANT", variant)
    monkeypatch.setattr(kernels, "SHORTKEY_VARIANT", variant)
    cuda = torch.device("cuda")
    mismatches = []
    for B, Lq, Lk, dtype, pair in GRID:
        jdt = JAX_DT[dtype]
        q = jnp.zeros((B, Lq, 64), jdt)
        k = v = jnp.zeros((B, Lk, 64), jdt)
        pf = (jnp.zeros((B, 2, Lq), bool), jnp.zeros((B, 2, Lk), bool)) if pair else None
        jax_recorder.route = "unset"
        with jkernels.pallas_scope(mode):
            jattention.dispatch_attention_core(
                q, k, v, num_heads=2, key_valid_mask=None, logit_bias=None, pair_factors=pf,
                dropout_rate=0.0, deterministic=not training, dropout_rng=None,
            )
        with kernels.pallas_scope(mode):
            got = kernels.attention_kernel(B, Lq, Lk, TORCH_DT[dtype], cuda, pair=pair,
                                           training=training)
        if got != jax_recorder.route:
            mismatches.append(((B, Lq, Lk, dtype, pair), got, jax_recorder.route))
    assert not mismatches, mismatches[:10]


def test_routing_reaches_every_kernel():
    """The grid above holds a case for each kernel."""
    cuda = torch.device("cuda")
    seen = set()
    for variant, mode in (("segmm", "on"), ("kernel", "auto"), ("segmm", "auto")):
        old = kernels.SHORTKEY_VARIANT
        kernels.SHORTKEY_VARIANT = variant
        try:
            with kernels.pallas_scope(mode):
                for B, Lq, Lk, dtype, pair in GRID:
                    seen.add(kernels.attention_kernel(B, Lq, Lk, TORCH_DT[dtype], cuda, pair=pair))
        finally:
            kernels.SHORTKEY_VARIANT = old
    assert seen == {None, "packed", "packed_pair", "shortkey", "shortkey_onematmul", "batched"}


def test_dispatch_takes_the_routed_plain_versions():
    """On CPU tensors under "on", the dispatch's output is the plain version
    of the routed kernel: kernel 4 for short keys, kernel 3 for long keys
    with pair factors; split_qk and active dropout take attention_core."""
    B, Lq, E, H = 4, 64, 64, 2
    for lk, fn in ((17, sk.attention_shortkey_reference), (72, ap.attention_packed_pair_reference)):
        q, k, v, mask, pair = _case(3, B, Lq, lk, E, H)
        tq, tk, tv, tm, tp = _torch_args(q, k, v, mask, pair, "bfloat16")
        with kernels.pallas_scope("on"), torch.no_grad():
            got = dispatch_attention_core(tq, tk, tv, H, key_valid_mask=tm, pair_factors=tp)
        torch.testing.assert_close(got, fn(tq, tk, tv, H, tm, tp), rtol=0, atol=0)
    old = kernels.SHORTKEY_VARIANT
    kernels.SHORTKEY_VARIANT = "kernel"
    try:
        q, k, v, mask, pair = _case(4, 8, Lq, 17, E, H)
        tq, tk, tv, tm, tp = _torch_args(q, k, v, mask, pair, "bfloat16")
        with kernels.pallas_scope("on"), torch.no_grad():  # "on" takes the Pallas tier first
            got = dispatch_attention_core(tq, tk, tv, H, key_valid_mask=tm, pair_factors=tp)
        torch.testing.assert_close(got, sk.attention_shortkey_reference(tq, tk, tv, H, tm, tp))
    finally:
        kernels.SHORTKEY_VARIANT = old


def test_short_key_wrappers_refuse_what_the_kernel_does_not_take():
    """Non-CPU tensors the kernels do not take raise before any launch (meta
    tensors stand in for device tensors)."""
    before = (sk.launches, sk.onematmul_launches, ap.pair_launches)
    meta = dict(device="meta")
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, **meta)
    k = torch.zeros(2, 17, 64, dtype=torch.bfloat16, **meta)
    qw = torch.zeros(2, 64, 512, dtype=torch.bfloat16, **meta)
    kw = torch.zeros(2, 17, 512, dtype=torch.bfloat16, **meta)
    for fn in (sk.attention_shortkey, sk.attention_shortkey_onematmul):
        with pytest.raises(TypeError):
            fn(q.half(), k.half(), k.half(), 2)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(qw, kw, kw, 2)  # head_dim 256: the wide bodies
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, k, k, 4)  # head_dim 16: an instance
        with pytest.raises(ValueError, match="shapes"):
            fn(q, k, k[..., :32].contiguous(), 2)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, k, k, 2)
    kl = torch.zeros(2, 72, 64, dtype=torch.bfloat16, **meta)
    pair = (torch.zeros(2, 2, 64, dtype=torch.bool, **meta), torch.zeros(2, 2, 72, dtype=torch.bool, **meta))
    with pytest.raises(TypeError):  # bf16 or fp32
        ap.attention_packed_pair(q.half(), kl.half(), kl.half(), 2, None, pair)
    with pytest.raises(ValueError, match="unsupported device"):
        ap.attention_packed_pair(q, kl, kl, 2, None, pair)
    assert (sk.launches, sk.onematmul_launches, ap.pair_launches) == before


def test_bf16_short_key_kernel_runs_the_mma_body():
    """attention_shortkey.cu sends bf16 operands of both short-key kernels to
    the tensor cores: the packed short-key kernel to the shared mma body with
    the pair kernel's rounding chain (attention_mma.cuh, Chain::PAIR), with
    at most 64 keys resident and the pair factors a compile-time option; the
    one-matmul kernel to its own kernel on the same mma tiles, one block per
    (sample, query tile) over every head, its logits through the pair
    chain's masks with the bf16 scale already in q, its segment sums divided
    exactly. No CUDA-core body has a bf16 instance (fp32 runs in 3xTF32:
    test_torch_shortkey_fp32.py)."""
    csrc = REPO / "mesm_tpu_torch" / "kernels" / "csrc"
    source = (csrc / "attention_shortkey.cu").read_text()
    assert '#include "attention_mma.cuh"' in source
    assert "if (is_bf16) {  // the route by dtype: the tensor-core kernels" in source
    assert "return attn_grid::by_head_dim(E / H, (int)cudaErrorInvalidValue" in source
    assert "return dispatch_mma<HD>(" in source
    assert "return dispatch_onematmul_mma<HD>(" in source
    assert "constexpr int SHORT_KEYS = 64;" in source
    assert "mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, SHORT_KEYS>(" in source
    assert "mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, SHORT_KEYS, false>(" in source
    assert "attention_shortkey_onematmul_mma_kernel(" in source
    assert "mma_attn::logits<HD, NT, mma_attn::Chain::PAIR>(" in source
    assert "mma_attn::div_rn(e * pre * mul, l, r)" in source
    assert "dispatch_pair<bf16" not in source and "struct IO<bf16>" not in source
    header = (csrc / "attention_mma.cuh").read_text()
    assert "bool FACTORS = true>" in header
    assert "if constexpr (C == Chain::PAIR && FACTORS)" in header


@pytest.mark.parametrize("dtype,onematmul,hd,accepted", [
    (torch.bfloat16, False, 32, True), (torch.bfloat16, False, 64, True),
    (torch.bfloat16, False, 48, True), (torch.float32, False, 32, True),
    (torch.float32, False, 64, True), (torch.bfloat16, True, 64, True),
    (torch.bfloat16, True, 32, True), (torch.float32, True, 64, True),
    (torch.bfloat16, False, 256, True), (torch.float32, False, 256, True),
    (torch.bfloat16, True, 256, True), (torch.float32, True, 256, True),
    (torch.bfloat16, False, 192, True), (torch.bfloat16, True, 512, True),
])
def test_short_key_wrappers_accept_the_head_dims_of_their_route(dtype, onematmul, hd, accepted):
    """Before any launch: both short-key kernels take every head_dim in
    both dtypes (16, 32, 64, 128 and multiples of 128 above native, any
    other padded to the next). On a device that is neither the CPU nor CUDA
    an accepted operand set reaches the device check; no launch is
    counted."""
    H, B, Lq, Lk = 4, 2, 5, 7
    q = torch.empty(B, Lq, H * hd, dtype=dtype, device="meta")
    k = torch.empty(B, Lk, H * hd, dtype=dtype, device="meta")
    fn = sk.attention_shortkey_onematmul if onematmul else sk.attention_shortkey
    before = (sk.launches, sk.onematmul_launches)
    with pytest.raises(ValueError, match="unsupported device" if accepted else "head_dim"):
        fn(q, k, k, H)
    assert (sk.launches, sk.onematmul_launches) == before


@pytest.mark.parametrize("dtype,onematmul,lk,accepted", [
    (torch.bfloat16, True, 64, True), (torch.bfloat16, True, 65, False),
    (torch.float32, True, 65, True), (torch.bfloat16, False, 65, True),
])
def test_bf16_onematmul_kernel_takes_at_most_64_keys(dtype, onematmul, lk, accepted):
    """The bf16 one-matmul kernel keeps every key's logit of a head in
    registers: it takes the short-key tier's keys (at most 64) and refuses
    more before any launch; the fp32 one-matmul kernel and the packed
    short-key kernel take more."""
    H, B, Lq = 8, 2, 5
    q = torch.empty(B, Lq, 256, dtype=dtype, device="meta")
    k = torch.empty(B, lk, 256, dtype=dtype, device="meta")
    fn = sk.attention_shortkey_onematmul if onematmul else sk.attention_shortkey
    assert sk.ONEMATMUL_MAX_LK == kernels.SHORTKEY_MAX_LK
    with pytest.raises(ValueError, match="unsupported device" if accepted else "at most 64 keys"):
        fn(q, k, k, H)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _card_case(B, Lq, Lk, pair: bool, dtype=torch.bfloat16, seed=0, E=256):
    g = torch.Generator(device="cuda").manual_seed(seed)
    H = 8
    q = torch.randn(B, Lq, E, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").to(dtype) for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    mask[1] = False
    pf = None
    if pair:
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[2, 3] = True
        qf[2, 3, ::2] = True
        pf = (qf, kf)
    return q, k, v, mask, pf, H


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,B,Lq,Lk,pair", [
    ("shortkey", 128, 194, 17, True), ("shortkey", 30, 75, 33, True),
    ("shortkey", 30, 75, 33, False), ("onematmul", 128, 194, 17, True),
    ("onematmul", 30, 75, 33, True), ("onematmul", 30, 75, 33, False),
    ("packed_pair", 128, 194, 81, True),
] + [(kernel, 3, Lq, Lk, pair)  # the bf16 mma tiles' edges
     for kernel, Lq, Lk, pair in itertools.product(("shortkey", "onematmul"), SHORTKEY_EDGE_LQ,
                                                   SHORTKEY_EDGE_LK, (True, False))])
@pytest.mark.parametrize("E", [256, 512])  # head_dim 32 and 64
def test_short_key_kernels_match_plain(cuda, kernel, B, Lq, Lk, pair, E):
    q, k, v, mask, pf, H = _card_case(B, Lq, Lk, pair, E=E)
    fns = {"shortkey": (sk.attention_shortkey, sk.attention_shortkey_reference, "launches"),
           "onematmul": (sk.attention_shortkey_onematmul, sk.attention_shortkey_onematmul_reference,
                         "onematmul_launches"),
           "packed_pair": (ap.attention_packed_pair, ap.attention_packed_pair_reference,
                           "pair_launches")}
    fn, ref, counter = fns[kernel]
    mod = ap if kernel == "packed_pair" else sk
    before = getattr(mod, counter)
    got = fn(q, k, v, H, mask, pf)
    want = ref(q, k, v, H, mask, pf)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 1
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]
    # sample 1: every key masked, every head uniform over all Lk keys
    assert float((got[1].float() - v[1].float().mean(0)).abs().max()) <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("E", [256, 512])  # head_dim 32 and 64
def test_onematmul_kernel_bf16_takes_the_fallback_of_an_underflowed_segment(cuda, E):
    """Sample 2's head 1 logits sit ~180 (hd 32) or ~250 (hd 64) above its
    other heads': their segment sums underflow to 0, so each of those heads
    takes 1/Lk on every key (the mean of v over all Lk keys, padded keys
    included) while head 1 keeps its own softmax; the kernel agrees with its
    plain version (3e-2)."""
    q, k, v, mask, pf, H = _card_case(3, 70, 17, True, E=E, seed=5)
    hd = E // H
    sign = torch.randint(0, 2, (hd,), generator=torch.Generator().manual_seed(9)).cuda() * 2 - 1
    q[2, :, hd:2 * hd] = (40.0 * sign).bfloat16()
    k[2, :, hd:2 * hd] = (k[2, :, hd:2 * hd].float().abs() * sign).bfloat16()
    pf[0][2, 1] = False  # head 1 keeps every unmasked key
    before = sk.onematmul_launches
    got = sk.attention_shortkey_onematmul(q, k, v, H, mask, pf)
    want = sk.attention_shortkey_onematmul_reference(q, k, v, H, mask, pf)
    torch.cuda.synchronize()
    assert sk.onematmul_launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]
    mean_v = v[2].float().mean(0)
    for h in (0, 2, 7):
        cols = slice(h * hd, (h + 1) * hd)
        assert float((got[2, :, cols].float() - mean_v[cols]).abs().max()) <= TOL["bfloat16"]
    assert float((got[2, :, hd:2 * hd].float() - mean_v[hd:2 * hd]).abs().max()) > TOL["bfloat16"]


@pytest.mark.cuda
def test_onematmul_kernel_fp32_matches_plain(cuda):
    q, k, v, mask, pf, H = _card_case(16, 75, 33, True, torch.float32)
    got = sk.attention_shortkey_onematmul(q, k, v, H, mask, pf)
    want = sk.attention_shortkey_onematmul_reference(q, k, v, H, mask, pf)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max().clamp(min=1)) <= TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,E", HEADS_EDGE_SHAPES)
def test_pair_kernel_bf16_at_the_tile_edges(cuda, B, Lq, Lk, E):
    """The bf16 pair kernel (on the mma body) at the edges of the mma tiles
    against its plain version (3e-2). Sample 0 has every key of head 0
    flagged and every other query of that head flagged, sample 1 (where
    B > 1) every key masked: those rows average v over all Lk keys."""
    H = 8
    g = torch.Generator(device="cuda").manual_seed(B + Lq + Lk + E)
    q = torch.randn(B, Lq, E, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").bfloat16() for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    if B > 1:
        mask[1] = False
    qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
    kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
    kf[0, 0] = True
    qf[0, 0, ::2] = True
    before = ap.pair_launches
    got = ap.attention_packed_pair(q, k, v, H, mask, (qf, kf))
    want = ap.attention_packed_pair_reference(q, k, v, H, mask, (qf, kf))
    torch.cuda.synchronize()
    assert ap.pair_launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]
    hd = E // H
    dead = ~mask[:, None, None, :] | (qf[..., :, None] & kf[..., None, :])  # (B, H, Lq, Lk)
    rows = dead.all(-1)
    assert bool(rows[0, 0, ::2].all())
    mean_v = v.float().mean(1).view(B, 1, H, hd)
    diff = (got.float().view(B, Lq, H, hd) - mean_v).abs().amax(-1).transpose(1, 2)
    assert float(diff[rows].max()) <= TOL["bfloat16"]
