"""The fp32 "batched" attention kernel's plain version and the trainable
attention Function against the JAX package, the dispatch of the fp32 tier,
and the rule that a kernel wrapper never drops a gradient.

On the CPU the wrappers run their plain versions: `attention_batched_reference`
meets `_fused_attention_impl(..., variant="batched", interpret=True)`, and
`attention_trainable` meets `jax.vjp` of `fused_attention_trainable` (its
Pallas forward in interpret mode). Inputs are made from a numpy seed; JAX at
matmul precision "highest", torch without TF32. Tolerances: fp32 1e-5 in units
of max(1, max |reference|) (the two differ in summation order only); bf16
3e-2 (bf16 keeps 8 mantissa bits, and the packed kernel's softmax rounds to
bf16 where the plain backward's does not). Tests marked `cuda` hold the CUDA
kernel against its plain version on the card and skip here.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops.attention_pallas import _fused_attention_impl, fused_attention_trainable
from mesm_tpu_torch import kernels
from mesm_tpu_torch.models.attention import attention_core, dispatch_attention_core
from mesm_tpu_torch.ops import attention_batched as ab
from mesm_tpu_torch.ops import attention_packed as ap
from mesm_tpu_torch.ops import attention_trainable as at
from mesm_tpu_torch.ops import ln_dense as ld

from test_torch_attention_backward import _mm_3xtf32

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def grad_mode_on():
    """These tests take gradients; another module of the suite turns grad
    mode off for its whole process when it is imported
    (tests/test_transformer_oracle.py)."""
    with torch.enable_grad():
        yield


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _qkv(seed, B, Lq, Lk, E):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, E)).astype(np.float32)
    k = rng.normal(size=(B, Lk, E)).astype(np.float32)
    v = rng.normal(size=(B, Lk, E)).astype(np.float32)
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = False  # the global token is never a key
    mask[1] = False  # a padded row: every key masked
    return q, k, v, mask


@pytest.mark.parametrize("B,lq,lk,E,H", [(4, 64, 64, 64, 2), (3, 72, 96, 128, 2), (2, 65, 65, 64, 4)])
def test_attention_batched_reference_matches_pallas(B, lq, lk, E, H):
    q, k, v, mask = _qkv(0, B, lq, lk, E)
    with jax.default_matmul_precision("highest"):
        want = _fused_attention_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask, jnp.float32),
            H, True, "batched",
        )
    want = np.asarray(want)
    got = ab.attention_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, torch.from_numpy(mask)
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    # the fully masked sample: every query gets the plain average of v
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), got[1].shape), atol=1e-5)
    assert _err(got, want) <= TOL["float32"]


def test_attention_batched_reference_is_attention_core_in_fp32():
    q, k, v, mask = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 80, 64))
    torch.testing.assert_close(
        ab.attention_batched_reference(q, k, v, 2, mask),
        attention_core(q, k, v, 2, key_valid_mask=mask), rtol=0, atol=1e-6,
    )


def _jax_trainable(q, k, v, mask, H, dtype, g, pair=None):
    jq, jk, jv = (jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v))
    jpair = None if pair is None else tuple(jnp.asarray(p) for p in pair)

    def f(q, k, v):
        return fused_attention_trainable(q, k, v, H, jnp.asarray(mask), jpair)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, jq, jk, jv)
        grads = vjp(jnp.asarray(g, JAX_DT[dtype]))
    return [np.asarray(a.astype(jnp.float32)) for a in (out, *grads)]


def _torch_trainable(q, k, v, mask, H, dtype, g, pair=None):
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DT[dtype]).requires_grad_(True) for a in (q, k, v))
    tpair = None if pair is None else tuple(torch.from_numpy(p) for p in pair)
    out = at.attention_trainable(tq, tk, tv, H, torch.from_numpy(mask), tpair)
    out.backward(torch.from_numpy(g).to(TORCH_DT[dtype]))
    return [t.detach().float().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_pair", [False, True])
def test_attention_trainable_matches_jax_vjp(dtype, with_pair):
    """Value and dq/dk/dv of the Function against jax.vjp of
    fused_attention_trainable: the packed (bf16) or batched (fp32) kernel
    forward, attention_core's gradients; with pair factors both sides take
    attention_core."""
    B, L, E, H = 2, 72, 64, 2
    q, k, v, mask = _qkv(2, B, L, L, E)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(B, L, E)).astype(np.float32)
    pair = None
    if with_pair:
        pair = (rng.random((B, H, L)) < 0.2, (rng.random((B, H, L)) < 0.2) & mask[:, None, :])
    want = _jax_trainable(q, k, v, mask, H, dtype, g, pair)
    got = _torch_trainable(q, k, v, mask, H, dtype, g, pair)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        assert _err(a, b) <= TOL[dtype], (name, _err(a, b))


def test_attention_trainable_kernel_forward_core_backward():
    """The forward is the batched kernel's function, the backward is
    attention_core's: gradients equal autograd through attention_core."""
    q, k, v, mask = (torch.from_numpy(a) for a in _qkv(4, 2, 64, 64, 64))
    g = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(5))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = at.attention_trainable(*leaves, 2, mask)
    out.backward(g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention_core(*ref_leaves, 2, key_valid_mask=mask)
    ref.backward(g)
    torch.testing.assert_close(out, ab.attention_batched_reference(q, k, v, 2, mask), rtol=0, atol=0)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)


def test_fp32_tier_dispatch():
    """kernels.py:75-78, 379: fp32 takes the batched kernel from L >= 512
    and B >= 16 on the card under "auto"; "on" takes both sides >= 64 on any
    device; "off" and CPU tensors under "auto" take attention_core."""
    cuda, cpu, f32, bf16 = torch.device("cuda"), torch.device("cpu"), torch.float32, torch.bfloat16
    assert kernels.attention_kernel(16, 601, 601, f32, cuda) == "batched"
    assert kernels.attention_kernel(32, 601, 601, f32, cuda) == "batched"
    assert kernels.attention_kernel(8, 601, 601, f32, cuda) is None
    assert kernels.attention_kernel(128, 195, 195, f32, cuda) is None
    assert kernels.attention_kernel(128, 195, 195, bf16, cuda) == "packed"
    assert kernels.attention_kernel(16, 601, 601, f32, cpu) is None
    with kernels.pallas_scope("on"):
        assert kernels.attention_kernel(2, 65, 65, f32, cpu) == "batched"
        assert kernels.attention_kernel(2, 65, 63, f32, cpu) is None
        assert kernels.attention_kernel(2, 65, 65, bf16, cpu) == "packed"
    with kernels.pallas_scope("off"):
        assert kernels.attention_kernel(16, 601, 601, f32, cuda) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_route_keeps_the_gradient(dtype):
    """The repaired fault: a training call with dropout 0 once went straight
    to the kernel wrapper, whose output has no graph, so the gradients into
    q, k, v were dropped. The wrapper now refuses such inputs, and the
    dispatch sends training calls through the Function, whose gradients are
    attention_core's."""
    dt = TORCH_DT[dtype]
    q, k, v, mask = (torch.from_numpy(a) for a in _qkv(6, 2, 64, 64, 64))
    q, k, v = (t.to(dt) for t in (q, k, v))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    wrapper = ab.attention_batched if dtype == "float32" else ap.attention_packed
    with pytest.raises(RuntimeError, match="requires grad"):
        wrapper(*leaves, 2, mask)  # the old route
    with kernels.pallas_scope("on"):
        out = dispatch_attention_core(*leaves, 2, key_valid_mask=mask, training=True)
    assert out.grad_fn is not None and "AttentionTrainable" in type(out.grad_fn).__name__
    out.float().sum().backward()
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention_core(*ref_leaves, 2, key_valid_mask=mask).float().sum().backward()
    for a, b in zip(leaves, ref_leaves):
        assert a.grad is not None
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    # under no_grad the wrapper runs as before
    with torch.no_grad():
        assert wrapper(*leaves, 2, mask).shape == q.shape


def test_ln_dense_refuses_inputs_that_need_grad():
    x = torch.randn(5, 70)
    gamma, beta = torch.ones(70, requires_grad=True), torch.zeros(70)
    w, b = torch.randn(48, 70), torch.zeros(48)
    with pytest.raises(RuntimeError, match="requires grad"):
        ld.ln_dense(x, gamma, beta, w, b, True)
    with torch.no_grad():
        assert ld.ln_dense(x, gamma, beta, w, b, True).shape == (5, 48)


# the float32 body on the tensor cores in 3xTF32
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "mesm_tpu_torch" / "kernels" / "csrc"


def test_fp32_kernels_run_the_3xtf32_body():
    """The float32 instances of kernels 6 (batched), 7 and 8 (the heads
    layouts), 2 (packed) and 3 (its pair entry point, with the pair flags)
    run the tensor-core body of attention_fp32.cuh: S = qs . K^T and each
    key tile's P . V through the shared 3xTF32 products (attention_tf32.cuh:
    product_nt, product_kt, three mma.sync a step), at every head_dim (the
    fast body up to 128, the wide one above); the register tiles keep only
    their bf16 body, and no CUDA-core pair kernel is left."""
    body = (CSRC / "attention_fp32.cuh").read_text()
    assert '#include "attention_tf32.cuh"' in body
    assert body.count("tf32x3::product_nt<HD, NT>(") == 2  # the body and the wide body
    assert body.count("tf32x3::product_kt<HD, KN, NH>(") == 1  # Online::accumulate
    assert "fmaf(av[" not in body and "mma_tf32(" not in body
    for name in ("attention_batched", "attention_heads", "attention_packed"):
        source = (CSRC / f"{name}.cu").read_text()
        assert '#include "attention_fp32.cuh"' in source, name
        assert "fp32_attn::block_attend<HD>(q, k, v, mask, out, Lq, Lk, E, scale" in source, name
        assert "fp32_attn::block_attend_wide<false>(" in source, name
    packed = (CSRC / "attention_packed.cu").read_text()
    assert "fp32_attn::block_attend<HD, true>(q, k, v, mask, out, Lq, Lk, E, scale" in packed
    assert "fp32_attn::block_attend_wide<true>(" in packed
    assert "PairSmem" not in packed and "attention_packed_pair_kernel" not in packed
    regtile = (CSRC / "attention_regtile.cuh").read_text()
    assert "IO<float>" not in regtile and "const float* __restrict__ q" not in regtile


def _forward_3xtf32(q, k, v, mask, heads: int, terms: str = "3x"):
    """attention_batched_reference in float32 as the 3xTF32 body takes it,
    per 32-key tile: S = qs . K^T as one tensor-core sum over head_dim
    (_mm_3xtf32: split operands, three mma terms a step of 8, truncated
    sums), the masks, the online softmax in f32 (running max m and sum l,
    the output rescaled by exp(m_old - m_new)), the tile's e . V a 3xTF32
    sum from zero over its keys added to the f32 running output; then o /
    l. terms="1x" takes one TF32 product."""
    B, Lq, E = q.shape
    Lk, hd, KT = k.shape[1], E // heads, 32
    scale = torch.tensor(hd**-0.5)
    out = torch.zeros_like(q)
    for b in range(B):
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            qs, kh, vh = q[b, :, cols] * scale, k[b, :, cols], v[b, :, cols]
            m = torch.full((Lq, 1), -float("inf"))
            l, o = torch.zeros(Lq, 1), torch.zeros(Lq, hd)
            for k0 in range(0, Lk, KT):
                keys = slice(k0, min(k0 + KT, Lk))
                s = _mm_3xtf32(qs, kh[keys].T, hd, terms)
                s = torch.where(mask[b, keys][None], s, torch.tensor(-1e9))
                mn = torch.maximum(m, s.amax(1, keepdim=True))
                alpha, e = torch.exp(m - mn), torch.exp(s - mn)
                l = l * alpha + e.sum(1, keepdim=True)
                o = o * alpha + _mm_3xtf32(e, vh[keys], KT, terms)
                m = mn
            out[b, :, cols] = o / l
    return out


def test_3xtf32_forward_holds_the_fp32_tolerance_at_the_tacos_sizes():
    """An emulation of the float32 body's 3xTF32 split and summation order
    (attention_fp32.cuh) on the TACoS encoder's sums: logits over head_dim
    32, 601 keys in 19 tiles of 32 (the last short), padded keys. It stays
    within a quarter of the kernels' 1e-5 of the f32 plain version (in units
    of max(1, max |reference|)); one TF32 product a step does not hold
    1e-5."""
    B, L, E, heads = 1, 601, 64, 2  # head_dim 32
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, L, E)).astype(np.float32)) for _ in range(3))
    mask = torch.arange(L)[None] < 560
    want = ab.attention_batched_reference(q, k, v, heads, mask)
    got = _forward_3xtf32(q, k, v, mask, heads)
    one = _forward_3xtf32(q, k, v, mask, heads, terms="1x")
    assert _err(got.numpy(), want.numpy()) <= TOL["float32"] / 4
    assert _err(one.numpy(), want.numpy()) > TOL["float32"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 32])
def test_attention_batched_kernel_matches_plain(cuda, B):
    """The TACoS shapes: eval (16 rows) and the stacked train pass (32), a
    fully masked row among varied key masks."""
    g = torch.Generator(device=cuda).manual_seed(1)
    L, E, H = 601, 256, 8
    q, k, v = (torch.randn(B, L, E, generator=g, device=cuda) for _ in range(3))
    lengths = torch.randint(60, L + 1, (B,), generator=g, device=cuda)
    mask = torch.arange(L, device=cuda)[None] < lengths[:, None]
    mask[:, 0] = False
    mask[3] = False
    before = ab.launches
    with torch.no_grad():
        got = ab.attention_batched(q, k, v, H, mask)
        want = ab.attention_batched_reference(q, k, v, H, mask)
    torch.cuda.synchronize()
    assert ab.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got[3] - v[3].mean(0)).abs().max()) <= 1e-5
    err = float((got - want).abs().max() / want.abs().max().clamp(min=1))
    assert err <= TOL["float32"]


@pytest.mark.cuda
def test_attention_trainable_on_card_keeps_the_gradient(cuda):
    """On the card at the TACoS train shape: the dispatch launches the
    batched kernel in the forward, and the gradients into q, k, v equal
    autograd through attention_core."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, L, E, H = 32, 601, 256, 8
    q, k, v = (torch.randn(B, L, E, generator=g, device=cuda) for _ in range(3))
    mask = torch.rand(B, L, generator=g, device=cuda) < 0.9
    mask[:, 0] = False
    cot = torch.randn(B, L, E, generator=g, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (ab.launches, at.launches)
    out = dispatch_attention_core(*leaves, H, key_valid_mask=mask, training=True)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (ab.launches, at.launches) == (before[0] + 1, before[1] + 1)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = attention_core(*ref_leaves, H, key_valid_mask=mask)
    ref.backward(cot)
    assert float((out - ref).abs().max()) <= 1e-4
    for a, b in zip(leaves, ref_leaves):
        assert float((a.grad - b.grad).abs().max() / b.grad.abs().max().clamp(min=1)) <= 1e-5
