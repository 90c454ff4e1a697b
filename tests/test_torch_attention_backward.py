"""The float32 backward of the trainable attention (ops/attention_backward.py)
against the JAX package and the port's own autograd, and the trainable
Function's choice of backward.

On the CPU `attention_backward` runs its plain version,
`attention_backward_reference`: it meets `jax.vjp` of
`mesm_tpu.models.attention.attention_core` (matmul precision "highest")
within 1e-5 in units of max(1, max |reference|) (f32 sums in another order),
and torch autograd through the port's `attention_core` bit for bit (the
same ops in the same order). Inputs are made from a numpy seed; every case
has a sample whose keys are all masked (its P is uniform over all Lk keys:
dv gets its dO through every key, dq and dk get nothing). Tests marked
`cuda` hold the CUDA kernels against the plain version on the card and skip
here.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu_torch import kernels
from mesm_tpu_torch.models.attention import attention_core
from mesm_tpu_torch.ops import attention_backward as abw
from mesm_tpu_torch.ops import attention_trainable as at

from chip_smoke import HEADS_EDGE_SHAPES

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
H = 2
# (B, Lq, Lk, E) with H = 2: head_dim 32 at E = 64, 64 at E = 128, 256 (a
# wide head) at E = 512; Lq != Lk
CASES = [(2, 17, 17, 64), (3, 40, 72, 64), (2, 72, 33, 128), (3, 64, 64, 128),
         (2, 40, 33, 512)]


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


def _case(seed, B, Lq, Lk, E):
    """q, k, v, the output gradient g and a key mask: padded keys, the first
    key masked everywhere, sample 1 with every key masked."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, E)).astype(np.float32)
    k, v = (rng.normal(size=(B, Lk, E)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(B, Lq, E)).astype(np.float32)
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = False
    mask[1] = False
    return q, k, v, g, mask


def _autograd(q, k, v, g, mask, heads=H, **kw):
    """Torch autograd through the port's attention_core: (out, dq, dk, dv)."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention_core(*leaves, heads, key_valid_mask=mask, **kw)
    out.backward(g)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("B,Lq,Lk,E", CASES)
def test_reference_matches_jax_vjp(B, Lq, Lk, E):
    from mesm_tpu.models.attention import attention_core as jax_core

    q, k, v, g, mask = _case(B + Lq + Lk + E, B, Lq, Lk, E)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b, c: jax_core(a, b, c, H, key_valid_mask=jnp.asarray(mask)),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = abw.attention_backward_reference(*(torch.from_numpy(a) for a in (q, k, v, g)), H,
                                           torch.from_numpy(mask))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _err(a.numpy(), b) <= TOL, (name, _err(a.numpy(), b))
    # sample 1, every key masked: P = 1/Lk everywhere, so dv at every key is
    # the sum of dO over the queries over Lk, and no gradient reaches q or k
    dq, dk, dv = (t.numpy() for t in got)
    assert np.abs(dq[1]).max() == 0 and np.abs(dk[1]).max() == 0
    np.testing.assert_allclose(dv[1], np.broadcast_to(g[1].sum(0) / Lk, dv[1].shape),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("B,Lq,Lk,E", CASES)
def test_reference_is_attention_core_autograd(B, Lq, Lk, E, with_mask):
    """The plain version's gradients are autograd's through attention_core,
    bit for bit: the Function's CPU backward keeps the values it had when it
    differentiated attention_core itself."""
    q, k, v, g, mask = (torch.from_numpy(a) for a in _case(7 * B + Lq, B, Lq, Lk, E))
    mask = mask if with_mask else None
    want = _autograd(q, k, v, g, mask)[1:]
    got = abw.attention_backward_reference(q, k, v, g, H, mask)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    q, k, v, g, mask = (torch.from_numpy(a) for a in _case(3, 2, 20, 24, 64))
    out = attention_core(q, k, v, H, key_valid_mask=mask)
    before = abw.backward_launches
    got = abw.attention_backward(q, k, v, out, g, H, mask)
    want = abw.attention_backward_reference(q, k, v, g, H, mask)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert abw.backward_launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Non-CPU tensors the kernels do not take raise before any launch (meta
    tensors stand in for device tensors), and so do inputs that need grad in
    grad mode (no double backward)."""
    B, L, E = 2, 9, 64
    meta = [torch.empty(B, L, E, device="meta") for _ in range(5)]
    before = abw.backward_launches
    with pytest.raises(TypeError):
        abw.attention_backward(*(t.to(torch.bfloat16) for t in meta), H)  # float32 only
    with pytest.raises(ValueError, match="unsupported device"):
        abw.attention_backward(*(torch.empty(B, L, 1024, device="meta") for _ in range(5)),
                               4)  # head_dim 256: the wide kernels
    with pytest.raises(ValueError, match="unsupported device"):
        abw.attention_backward(*meta, 4)  # head_dim 16: an instance
    with pytest.raises(ValueError, match="unsupported device"):
        abw.attention_backward(*meta, H)
    with pytest.raises(RuntimeError, match="requires grad"):
        abw.attention_backward(meta[0].requires_grad_(True), *meta[1:], H)
    assert abw.backward_launches == before


@pytest.fixture
def recorded_backward(monkeypatch):
    """The Function's calls of attention_backward, recorded."""
    calls = []

    def record(*args, **kw):
        calls.append(args)
        return abw.attention_backward(*args, **kw)

    monkeypatch.setattr(at, "attention_backward", record)
    return calls


@pytest.mark.parametrize("dtype,pair,Lq,variant,kernel_backward", [
    # the batched kernel's forward: the backward kernel
    (torch.float32, False, 66, "", True),
    # pair factors (the fp32 pair kernel's forward): attention_core's autograd
    (torch.float32, True, 66, "packed", False),
    # bf16 (the packed kernel's forward): the same
    (torch.bfloat16, False, 66, "", False),
    # no kernel route (a side below 64): the same
    (torch.float32, False, 40, "", False),
])
def test_function_backward_route(recorded_backward, monkeypatch, dtype, pair, Lq, variant,
                                 kernel_backward):
    """The Function takes the backward kernel for float32 operands with no
    pair factors on a kernel route, and attention_core's autograd for the
    rest; on the CPU the kernel's route is its plain version, so every route
    gives attention_core's gradients (fp32 bit for bit, bf16 within 3e-2)."""
    monkeypatch.setenv(kernels.ATTN_VARIANT_ENV, variant)
    B, Lk, E = 2, 72, 64
    q, k, v, g, mask = (torch.from_numpy(a) for a in _case(11, B, Lq, Lk, E))
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
    pf = None
    if pair:
        rng = np.random.default_rng(12)
        pf = (torch.from_numpy(rng.random((B, H, Lq)) < 0.3),
              torch.from_numpy(rng.random((B, H, Lk)) < 0.3))
    assert (kernels.fused_route(Lq, Lk, dtype, pair) is not None) == (Lq >= 64)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = abw.backward_launches
    at.attention_trainable(*leaves, H, mask, pf).backward(g)
    assert len(recorded_backward) == int(kernel_backward)
    assert abw.backward_launches == before  # CPU tensors: no kernel launched
    want = _autograd(q, k, v, g, mask, pair_factors=pf)[1:]
    if kernel_backward:
        plain = abw.attention_backward_reference(q, k, v, g, H, mask)
        for a, b in zip(leaves, plain):
            torch.testing.assert_close(a.grad, b, rtol=0, atol=0)
    for a, b in zip(leaves, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a.grad, b, rtol=0, atol=0)
        else:
            assert _err(a.grad.float().numpy(), b.float().numpy()) <= 3e-2


# ---------------------------------------------------------------------------
# the kernels' 3xTF32 products
# ---------------------------------------------------------------------------

CSRC = REPO / "mesm_tpu_torch" / "kernels" / "csrc"


def test_backward_kernels_run_their_products_as_3xtf32():
    """attention_backward.cu issues every product of both kernels on the
    tensor cores as three tf32 mma of split operands (hi = rna(x), lo =
    rna(x - hi): cvt.rna.tf32.f32's rounding, as _tf32_rna below), the small
    terms first: S and dP in each kernel (product_nt), dQ in the dq kernel
    and dV and dK in the dk / dv kernel (product_kt); the staged operands
    are split once a block (split_tile), the A fragments at each step
    (SplitA); no CUDA-core product is left. The helpers live in the header
    it shares with the forward's float32 body (attention_tf32.cuh), with no
    copy left in the source; the wide-head kernels take the same products
    on 128-column slices."""
    own = (CSRC / "attention_backward.cu").read_text()
    assert '#include "attention_tf32.cuh"' in own and "void mma3(" not in own
    assert "uint32_t tf32(float x)" not in own and "void walk(" not in own
    wide = own[own.index("attention_backward_dq_wide_kernel(const"):]
    own = own[:own.index("// wide heads\n")]
    source = own + (CSRC / "attention_tf32.cuh").read_text()
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in source
    assert "hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));" in source
    assert source.count('asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "') == 1
    body = source[source.index("__device__ __forceinline__ void mma3("):]
    body = body[:body.index("\n}\n")]
    assert [line.strip() for line in body.splitlines() if "mma_tf32(" in line] == [
        "mma_tf32(c, a.lo, bh0, bh1);", "mma_tf32(c, a.hi, bl0, bl1);",
        "mma_tf32(c, a.hi, bh0, bh1);"]
    assert source.count("mma3(") == 3  # its definition, product_nt, product_kt
    assert source.count("split(x.") == 4  # split_tile: the staged operands
    assert source.count("split(a") == 4  # SplitA: the A fragments
    dq = source[source.index("attention_backward_dq_3xtf32_kernel(const"):
                source.index("attention_backward_dkdv_3xtf32_kernel(const")]
    dkdv = source[source.index("attention_backward_dkdv_3xtf32_kernel(const"):]
    # product_kt takes the output columns in NH<HD> tiles at a time (half of
    # them at head_dim 128, all below)
    assert dq.count("product_nt<HD, NT>(") == 2 and dq.count("product_kt<HD, STEP, NH<HD>>(") == 1
    assert (dkdv.count("product_nt<HD, NT>(") == 2
            and dkdv.count("product_kt<HD, STEP, NH<HD>>(") == 2)
    assert "fmaf(av[" not in source and "tile_dot" not in source
    # the wide-head kernels: S and dP a slice at a time, then chunk c's
    # products, in half the columns at a time
    dq_wide = wide[:wide.index("attention_backward_dkdv_wide_kernel(const")]
    dkdv_wide = wide[wide.index("attention_backward_dkdv_wide_kernel(const"):]
    assert (dq_wide.count("product_nt<HD, NT>(") == 2
            and dq_wide.count("product_kt<HD, STEP, NHW>(") == 1)
    assert (dkdv_wide.count("product_nt<HD, NT>(") == 2
            and dkdv_wide.count("product_kt<HD, STEP, NHW>(") == 2)
    assert "fmaf(av[" not in wide


def test_tf32_rounding_is_cvt_rna():
    """The kernels' integer tf32 rounding, (bits + 0x1000) & ~0x1fff, is
    cvt.rna.tf32.f32's on finite values: the nearer of the two tf32 values
    around x (10 mantissa bits), ties away from zero on both signs."""
    ulp = 2.0**-10
    ties = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp, 2 - ulp / 2])
    assert _tf32_rna(ties).tolist() == [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 2.0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000))
                         .astype(np.float32))
    x64 = x.double()
    down = (x.view(torch.int32) & -0x2000).view(torch.float32).double()  # toward zero
    step = torch.ldexp(torch.ones_like(x64), torch.frexp(x64)[1] - 11)  # a tf32 ulp at |x|
    away = down + torch.sign(x64) * step
    nearer_down = (x64 - down).abs() < (away - x64).abs()
    assert torch.equal(_tf32_rna(x).double(), torch.where(nearer_down, down, away))


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero
    (add half a tf32 ulp to the magnitude, clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero: the tensor cores' sums
    truncate (the worse case for a long sum: every rounding one way)."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, tile: int, terms: str = "3x") -> torch.Tensor:
    """a (M, K) @ b (K, N) as the kernels take it: each operand split into
    hi = rna(x) and lo = rna(x - hi); per step of 8 k, the mma products lo .
    hi, hi . lo, hi . hi, each added to the f32 accumulator with exact
    products and a truncated sum; the accumulator starts from 0 every `tile`
    k and each tile's sum is added to the running f32 sum (round to
    nearest). terms="1x" takes hi . hi alone (one TF32 product)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == "3x" else [(ah, bh)]
    total = torch.zeros(a.shape[0], b.shape[1])
    for t0 in range(0, a.shape[1], tile):
        c = torch.zeros(a.shape[0], b.shape[1])
        for k0 in range(t0, min(t0 + tile, a.shape[1]), 8):
            for x, y in pairs:
                step = x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
                c = _round_toward_zero(c.double() + step)
        total = total + c
    return total


def _backward_3xtf32(q, k, v, g, mask, heads: int, terms: str = "3x"):
    """The plain version's backward with each of its five products taken as
    _mm_3xtf32 at the kernels' tiles: S and dP over head_dim (one tile), dV,
    dQ and dK over 64 keys or queries a tile."""
    B, Lq, E = q.shape
    hd = E // heads
    scale = torch.tensor(hd**-0.5)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            qs, kh, vh, gh = q[b, :, cols] * scale, k[b, :, cols], v[b, :, cols], g[b, :, cols]
            s = _mm_3xtf32(qs, kh.T, hd, terms)
            s = torch.where(mask[b][None], s, torch.tensor(-1e9))
            p = torch.softmax(s, -1)
            dp = _mm_3xtf32(gh, vh.T, hd, terms)
            ds = torch._softmax_backward_data(dp, p, -1, p.dtype)
            ds = torch.where(mask[b][None], ds, torch.tensor(0.0))
            dv[b, :, cols] = _mm_3xtf32(p.T, gh, 64, terms)
            dq[b, :, cols] = _mm_3xtf32(ds, kh, 64, terms) * scale
            dk[b, :, cols] = _mm_3xtf32(ds.T, qs, 64, terms)
    return dq, dk, dv


def test_3xtf32_products_hold_the_fp32_tolerance_at_the_tacos_sizes():
    """An emulation of the kernels' 3xTF32 products (split operands, three
    mma terms a step, truncated tensor-core sums, 64-key tiles added in f32)
    on the TACoS train shape's sums: S and dP over head_dim 32, dV, dQ and
    dK over 601 keys or queries, with padded keys. The gradients stay within
    the kernel's 1e-5 of the f32 plain version (in units of max(1, max
    |reference|)); one TF32 product (hi . hi alone) does not."""
    B, L, E, heads = 1, 601, 64, 2  # head_dim 32
    rng = np.random.default_rng(21)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, L, E)).astype(np.float32))
                  for _ in range(4))
    mask = torch.arange(L)[None] < 560
    want = abw.attention_backward_reference(q, k, v, g, heads, mask)
    got = _backward_3xtf32(q, k, v, g, mask, heads)
    one = _backward_3xtf32(q, k, v, g, mask, heads, terms="1x")
    errs = [_err(a.numpy(), b.numpy()) for a, b in zip(got, want)]
    errs_1x = [_err(a.numpy(), b.numpy()) for a, b in zip(one, want)]
    assert max(errs) <= TOL / 4, errs
    assert max(errs_1x) > TOL, errs_1x


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _card_case(B, Lq, Lk, E, seed=0):
    """q, k, v, g on the card and a key mask: padded keys, sample 1 (where
    B > 1) with every key masked."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, g = (torch.randn(B, Lq, E, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(B, Lk, E, generator=gen, device="cuda") for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=gen, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    if B > 1:
        mask[1] = False
    return q, k, v, g, mask


def _card_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1))


# the edges of the kernels' 64-row tiles (chip_smoke.HEADS_EDGE_SHAPES: Lq 1
# and 70, Lk 17, 81 and 601, head_dim 64 at E = 512), Lq != Lk with the
# roles swapped, and the TACoS train step's encoder (32 rows of 601)
CARD_SHAPES = list(HEADS_EDGE_SHAPES) + [(2, 81, 70, 256), (32, 601, 601, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,E", CARD_SHAPES)
def test_backward_kernel_matches_plain(cuda, B, Lq, Lk, E):
    """The kernels against their plain version and against autograd through
    attention_core on the same card tensors (1e-5: f32 sums in another
    order), the same bits from two calls (no atomics), one count a call."""
    heads = 8
    q, k, v, g, mask = _card_case(B, Lq, Lk, E)
    out = attention_core(q, k, v, heads, key_valid_mask=mask)
    before = abw.backward_launches
    got = abw.attention_backward(q, k, v, out, g, heads, mask)
    again = abw.attention_backward(q, k, v, out, g, heads, mask)
    torch.cuda.synchronize()
    assert abw.backward_launches == before + 2
    plain = abw.attention_backward_reference(q, k, v, g, heads, mask)
    auto = _autograd(q, k, v, g, mask, heads)[1:]
    for name, a, b, c, d in zip(("dq", "dk", "dv"), got, again, plain, auto):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name
        assert _card_err(a, c) <= TOL, (name, _card_err(a, c))
        assert _card_err(a, d) <= TOL, (name, _card_err(a, d))
    if B > 1:  # sample 1: every key masked
        assert float(got[0][1].abs().max()) == 0 and float(got[1][1].abs().max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["batched", "per_head"])
def test_function_on_the_card_matches_attention_core(cuda, monkeypatch, variant):
    """The Function at the TACoS train shape under the variants its train
    steps take: the forward kernel, the backward kernel (one count), and
    value and gradients within 1e-5 of autograd through attention_core."""
    monkeypatch.setenv(kernels.ATTN_VARIANT_ENV, variant)
    heads = 8
    q, k, v, g, mask = _card_case(32, 601, 601, 256, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = abw.backward_launches
    out = at.attention_trainable(*leaves, heads, mask)
    out.backward(g)
    torch.cuda.synchronize()
    assert abw.backward_launches == before + 1
    want = _autograd(q, k, v, g, mask, heads)
    for name, a, b in zip(("out", "dq", "dk", "dv"), [out.detach()] + [t.grad for t in leaves],
                          want):
        assert _card_err(a, b) <= TOL, (name, _card_err(a, b))
