"""The head-dim domain of the port's attention kernels.

The Pallas kernels of mesm_tpu/ops/attention_pallas.py take any head_dim
E // H. The CUDA kernels have instances at head_dim 16, 32, 64 and 128
(kernels.ATTN_HEAD_DIMS) and, above 128, wide bodies that take any multiple
of 128 (kernels.ATTN_WIDE_STEP) in 128-column slices and output chunks; a
wrapper zero-pads any other head_dim to the next of them
(ops/attention_packed.pad_heads) and passes the real head_dim's scale. Here,
on the CPU:

- every route kernels.attention_kernel can return, and the backward, takes
  head_dim 8 to 512 up to its device check (meta tensors stand in for
  device tensors), and the dispatch returns the same route whatever the
  head_dim;
- a bf16 head whose keys do not fit its instance's staging runs at head_dim
  128, whose kernels take any Lk on the wide body (ops/attention_packed
  .fitted_head_dim);
- the plain versions of kernels 2-6 match the Pallas kernels in interpret
  mode at head_dim 16, 128, 256 and 512, in both dtypes, within the
  tolerances of the existing parity tests (fp32 1e-5; bf16 3e-2: bf16 keeps
  8 mantissa bits, and an exp or a sum one ulp apart moves a rounding by
  one step);
- a plain version run on zero-padded heads with the real head_dim's scale
  gives, once the padding is sliced off, its unpadded output bit for bit
  (head_dim 24, 48 and 192): what the wrappers rely on.

On the card (`-m cuda`) every route's kernel at head_dim 16, 24, 64, 128,
192, 256 and 512 is held against its plain version, and at keys past what a
block once staged (chip_smoke.HEAD_DIM_LONG_KEYS).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops.attention_pallas import _fused_attention_impl, fused_attention_shortkey
from mesm_tpu_torch import kernels
from mesm_tpu_torch.models.attention import dispatch_attention_core
from mesm_tpu_torch.ops import attention_backward as abw
from mesm_tpu_torch.ops import attention_batched as ab
from mesm_tpu_torch.ops import attention_heads as ah
from mesm_tpu_torch.ops import attention_packed as ap
from mesm_tpu_torch.ops import attention_shortkey as sk

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# each route of kernels.attention_kernel: its wrapper, whether it takes pair
# factors, and (Lq, Lk) the route sees
ROUTES = {
    "packed": (ap.attention_packed, False, (70, 72)),
    "packed_pair": (ap.attention_packed_pair, True, (70, 81)),
    "shortkey": (sk.attention_shortkey, True, (70, 17)),
    "batched": (ab.attention_batched, False, (70, 72)),
    "all_heads": (ah.attention_all_heads, False, (70, 72)),
    "per_head": (ah.attention_per_head, False, (70, 72)),
    "shortkey_onematmul": (sk.attention_shortkey_onematmul, True, (70, 17)),
}
ACCEPTED = (8, 16, 24, 32, 64, 96, 128)
WIDE = (192, 256, 512)  # on the wide bodies (192 padded to 256)


def _meta(B, L, E, dtype):
    return torch.empty(B, L, E, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", ACCEPTED + WIDE)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_takes_head_dims_up_to_128(route, hd, dtype):
    """Head_dim 8 to 128, and the wide head dims above, reach the wrapper's
    device check (16, 32, 64, 128 and multiples of 128 natively, the rest
    padded). No launch is counted."""
    fn, takes_pair, (Lq, Lk) = ROUTES[route]
    B, H = 2, 4
    q, k = _meta(B, Lq, H * hd, dtype), _meta(B, Lk, H * hd, dtype)
    args = (q, k, k, H, None) + ((None,) if takes_pair else ())
    counts = (ap.launches, ap.pair_launches, sk.launches, sk.onematmul_launches, ab.launches,
              ah.per_head_launches, ah.all_heads_launches)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args)
    assert counts == (ap.launches, ap.pair_launches, sk.launches, sk.onematmul_launches,
                      ab.launches, ah.per_head_launches, ah.all_heads_launches)


@pytest.mark.parametrize("hd", ACCEPTED + WIDE)
def test_backward_takes_head_dims_up_to_128(hd):
    B, L, H = 2, 9, 4
    meta = [_meta(B, L, H * hd, torch.float32) for _ in range(5)]
    before = abw.backward_launches
    with pytest.raises(ValueError, match="unsupported device"):
        abw.attention_backward(*meta, H)
    assert abw.backward_launches == before


# (mode, MESM_ATTN_VARIANT, SHORTKEY_VARIANT, B, Lq, Lk, dtype, pair) under
# which kernels.attention_kernel returns each route on CUDA
DISPATCH = {
    "packed": ("auto", None, "segmm", 128, 195, 195, torch.bfloat16, False),
    "packed_pair": ("on", None, "segmm", 2, 70, 81, torch.bfloat16, True),
    "shortkey": ("on", None, "segmm", 2, 70, 17, torch.bfloat16, True),
    "batched": ("auto", None, "segmm", 16, 601, 601, torch.float32, False),
    "all_heads": ("on", "all_heads", "segmm", 2, 70, 72, torch.float32, False),
    "per_head": ("on", "per_head", "segmm", 2, 70, 72, torch.float32, False),
    "shortkey_onematmul": ("auto", None, "kernel", 128, 194, 17, torch.bfloat16, True),
}


@pytest.mark.parametrize("route", sorted(DISPATCH))
def test_dispatch_refuses_head_dims_above_128(route, monkeypatch):
    """The routes once refused head dims above 128; now attention_kernel
    returns its route whatever the head_dim (it takes none), and the
    route's wrapper takes head_dim 256 and 512 (2 heads of E = 512 and
    1024) at the route's shape up to its device check. Where the dispatch
    picks no kernel (kernels "off") it returns None."""
    mode, variant, sk_variant, B, Lq, Lk, dtype, pair = DISPATCH[route]
    if variant is None:
        monkeypatch.delenv(kernels.ATTN_VARIANT_ENV, raising=False)
    else:
        monkeypatch.setenv(kernels.ATTN_VARIANT_ENV, variant)
    monkeypatch.setattr(kernels, "SHORTKEY_VARIANT", sk_variant)
    with kernels.pallas_scope(mode):
        assert kernels.attention_kernel(B, Lq, Lk, dtype, "cuda", pair=pair) == route
    fn, takes_pair, _ = ROUTES[route]
    for hd in (256, 512):
        q, k = _meta(B, Lq, 2 * hd, dtype), _meta(B, Lk, 2 * hd, dtype)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, k, k, 2, None, *((None,) if takes_pair else ()))
    with kernels.pallas_scope("off"):
        assert kernels.attention_kernel(B, Lq, Lk, dtype, "cuda", pair=pair) is None


def test_model_dispatch_refuses_head_dims_above_128():
    """The model's E = 512, 2-head call (head_dim 256) under "on" reaches
    its route, the fp32 batched kernel's wrapper, which stops only at its
    device check (meta tensors stand in for the card's)."""
    q = _meta(2, 70, 512, torch.float32)
    with kernels.pallas_scope("on"), pytest.raises(ValueError,
                                                   match="attention_batched: unsupported device"):
        dispatch_attention_core(q, q, q, 2)


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _case(seed, B, Lq, Lk, E, H):
    """q, k, v, a key mask with padded keys and sample 1 fully masked, and
    pair factors with sample 2's head 1 flagging every key and half its
    queries (rows whose every key is dropped)."""
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


def _pallas(kernel, q, k, v, mask, pair, H, dtype):
    """The Pallas kernel a route stands for, in interpret mode."""
    jdt = JAX_DT[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    with jax.default_matmul_precision("highest"):
        if kernel == "onematmul":
            out = fused_attention_shortkey(
                jq, jk, jv, H, jnp.asarray(mask),
                None if pair is None else tuple(jnp.asarray(f) for f in pair), interpret=True)
        else:
            qf = kf = None
            if pair is not None:  # head-major floats, as fused_attention passes them
                qf, kf = (jnp.asarray(f, jnp.float32).transpose(1, 0, 2) for f in pair)
            out = _fused_attention_impl(jq, jk, jv, jnp.asarray(mask, jnp.float32), H, True,
                                        "batched" if kernel == "batched" else "packed", qf, kf)
    return np.asarray(out.astype(jnp.float32))


# kernel (2-6) -> (plain-version wrapper, pair factors, Lq, Lk)
PALLAS_CASES = {
    "packed": (ap.attention_packed, False, 70, 72),
    "packed_pair": (ap.attention_packed_pair, True, 70, 81),
    "shortkey": (sk.attention_shortkey, True, 66, 17),
    "onematmul": (sk.attention_shortkey_onematmul, True, 64, 17),
    "batched": (ab.attention_batched, False, 70, 72),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 128, 256, 512])
@pytest.mark.parametrize("kernel", sorted(PALLAS_CASES))
def test_plain_versions_match_pallas_at_new_head_dims(kernel, hd, dtype):
    """Kernels 2 (packed), 3 (packed pair), 4 (short key), 5 (one-matmul)
    and 6 (batched): the wrapper's plain version on CPU tensors against the
    Pallas kernel in interpret mode, at head_dim 16, 128, 256 and 512."""
    fn, pair, Lq, Lk = PALLAS_CASES[kernel]
    B, H = 4, 2
    q, k, v, mask, pf = _case(hd + Lk, B, Lq, Lk, H * hd, H)
    pf = pf if pair else None
    want = _pallas(kernel, q, k, v, mask, pf, H, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v))
    args = (tq, tk, tv, H, torch.from_numpy(mask))
    if pair:
        args += (tuple(torch.from_numpy(f) for f in pf),)
    got = fn(*args)
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert _err(got, want) <= TOL[dtype]


# each plain version: (function, takes pair factors, dtypes)
PLAIN = {
    "packed": (ap.attention_packed_reference, False),
    "packed_pair": (ap.attention_packed_pair_reference, True),
    "shortkey": (sk.attention_shortkey_reference, True),
    "onematmul": (sk.attention_shortkey_onematmul_reference, True),
    "batched": (ab.attention_batched_reference, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 48, 192])
@pytest.mark.parametrize("name", sorted(PLAIN))
def test_padding_the_heads_leaves_each_plain_version_bit_equal(name, hd, dtype):
    """Zero columns add exact zeros to the f32 sums of q . k and give zero
    columns of p . v: a plain version run at the next instance's head_dim
    (32, 64, or 256 on the wide bodies) on zero-padded heads, with the real
    head_dim's scale, gives its unpadded output bit for bit once the padding
    is sliced off."""
    fn, pair = PLAIN[name]
    B, H, Lq, Lk = 3, 2, 70, 81 if name == "packed_pair" else 17 if pair else 72
    q, k, v, mask, pf = _case(hd, B, Lq, Lk, H * hd, H)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    extra = (tuple(torch.from_numpy(f) for f in pf),) if pair else ()
    hdp = ap.kernel_head_dim(hd)
    assert hdp == {24: 32, 48: 64, 192: 256}[hd]
    want = fn(tq, tk, tv, H, tm, *extra)
    padded = fn(*(ap.pad_heads(t, H, hdp) for t in (tq, tk, tv)), H, tm, *extra, head_dim=hd)
    assert padded.shape == (B, Lq, H * hdp)
    assert torch.equal(padded.view(B, Lq, H, hdp)[..., hd:], torch.zeros(B, Lq, H, hdp - hd,
                                                                         dtype=padded.dtype))
    assert torch.equal(ap.unpad_heads(padded, H, hd), want)


@pytest.mark.parametrize("hd", [24, 48, 192])
def test_padding_the_heads_leaves_the_backward_bit_equal(hd):
    """The same for the backward's plain version: dq, dk and dv of the
    padded heads, sliced, are the unpadded ones bit for bit."""
    B, H, Lq, Lk = 3, 2, 70, 72
    q, k, v, mask, _ = _case(hd + 1, B, Lq, Lk, H * hd, H)
    g = np.random.default_rng(hd).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    hdp = ap.kernel_head_dim(hd)
    want = abw.attention_backward_reference(tq, tk, tv, tg, H, tm)
    got = abw.attention_backward_reference(*(ap.pad_heads(t, H, hdp) for t in (tq, tk, tv, tg)),
                                           H, tm, head_dim=hd)
    for a, b in zip(got, want):
        assert torch.equal(ap.unpad_heads(a, H, hd), b)


def test_kernel_head_dim_is_the_next_instance():
    """The instances, then the multiples of 128 of the wide bodies: no
    head_dim is refused."""
    assert [ap.kernel_head_dim(d) for d in (1, 8, 16, 17, 24, 32, 33, 48, 64, 65, 96, 128)] == [
        16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 128]
    assert [ap.kernel_head_dim(d) for d in (129, 192, 256, 257, 384, 500, 512, 1000)] == [
        256, 256, 256, 384, 384, 512, 512, 1024]
    assert kernels.ATTN_HEAD_DIMS == (16, 32, 64, 128) and kernels.ATTN_WIDE_STEP == 128


def _bf16_staging_bytes(is_bf16, hd, Lk):
    """A stand-in for the sources' shared-memory functions in bf16: the mma
    body's staging of K_h and V_h (attention_mma.cuh Smem) up to head_dim
    128, where a head beyond it takes the wide body (WideSmem::block, at
    most 223,424 bytes), and the wide body above 128; float32 streams its
    keys (fp32_attn::Smem at head_dim 32)."""
    kp = -(-Lk // 16) * 16
    wide = 64 * (min(kp, 704) + 4) * 4 + 128 * 128 * 2 + min(kp, 704) + 64 * 34 * 4
    if not is_bf16:
        return (2 * 64 + 8 * 32) * 36 * 4 + 64
    staged = (64 + 2 * kp) * hd * 2 + kp
    return wide if hd > 128 or (hd == 128 and staged > ap.MAX_SMEM) else staged


@pytest.mark.parametrize("is_bf16,hd,Lk,want", [
    (1, 32, 195, 32), (1, 32, 1760, 32), (1, 32, 1761, 128), (1, 24, 1800, 128),
    (1, 64, 864, 64), (1, 64, 900, 128), (1, 16, 3536, 16), (1, 16, 5000, 128),
    (1, 128, 416, 128), (1, 128, 601, 128), (1, 128, 100000, 128), (1, 192, 5000, 256),
    (1, 512, 760, 512), (0, 32, 100000, 32), (0, 128, 601, 128),
])
def test_a_head_beyond_its_staging_runs_at_head_dim_128(is_bf16, hd, Lk, want):
    """fitted_head_dim, the wrappers' choice of instance: a bf16 head whose
    K_h and V_h do not fit a block at its own instance runs at head_dim 128
    (zero-padded), where the kernel takes the wide body beyond its staging;
    every head_dim and Lk finds an instance. Where none fits it raises."""
    assert ap.fitted_head_dim("t", _bf16_staging_bytes, is_bf16, hd, Lk) == want
    with pytest.raises(ValueError, match="t: 601 keys at head_dim 128 need"):
        ap.fitted_head_dim("t", lambda *a: ap.MAX_SMEM + 1, 1, 100, 601)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_route_matches_plain_at_each_head_dim(cuda):
    """chip_smoke's head-dim cases: every forward route at head_dim 16, 24,
    64, 128, 192, 256 and 512 in both dtypes, and the backward against its
    plain version and autograd, each on its device kernel; fully masked rows
    give the mean of v."""
    from chip_smoke import check_head_dims

    bad = [c for c in check_head_dims() if not c["ok"]]
    assert not bad, bad[:3]
