"""The MESM_ATTN_VARIANT attention layouts: the port's routing against the
JAX package's, and the per-head, all-heads and bf16 batched plain versions
against the Pallas kernels in interpret mode (the packed family's in fp32
are held there by tests/test_torch_kernels.py and
tests/test_torch_attention_shortkey.py, which take both dtypes).

`fused_attention` of the JAX package reads MESM_ATTN_VARIANT at every call
(mesm_tpu/ops/attention_pallas.py:635-649) and sends (B, H, L, hd)-layout
calls to `_mha_kernel` ("per_head" and any unnamed value),
`_mha_kernel_allheads` ("all_heads") or `_mha_kernel_batched` ("batched"),
and fp32 calls too to the packed family under "packed". The routing test
records which kernel body reaches `pallas_call` (no compute) and holds
`kernels.attention_kernel` to it over variant x dtype x pair factors x
(B, Lq, Lk) in every mode, in eval and in training. Tolerances of the value
tests: fp32 1e-5 in units of max(1, max |reference|) (summation order
only); bf16 3e-2 abs (bf16 keeps 8 mantissa bits; one probability or output
rounding can move by a step). Tests marked `cuda` hold each new kernel and
dtype instance against its plain version on the card and skip here.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops import attention_pallas
from mesm_tpu.ops.attention_pallas import _fused_attention_impl
from mesm_tpu_torch import kernels
from mesm_tpu_torch.models.attention import attention_core, dispatch_attention_core
from mesm_tpu_torch.ops import attention_batched as ab
from mesm_tpu_torch.ops import attention_heads as ah
from mesm_tpu_torch.ops import attention_packed as ap
from mesm_tpu_torch.ops import attention_shortkey as sk
from mesm_tpu_torch.ops import attention_trainable as at

from chip_smoke import BATCHED_REGTILE_SHAPES, HEADS_EDGE_SHAPES
from test_torch_attention_shortkey import JAX_DT, TOL, TORCH_DT, _case, _err

ENV = kernels.ATTN_VARIANT_ENV
# unset, every value the JAX package names, and one it does not
VARIANTS = [None, "per_head", "all_heads", "batched", "packed", "other"]


def _set_variant(monkeypatch, variant):
    if variant is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, variant)


# ---------------------------------------------------------------------------
# routing: the port's decisions against the kernel body the JAX package calls
# ---------------------------------------------------------------------------

BODIES = {
    "_mha_kernel": "per_head", "_mha_kernel_allheads": "all_heads",
    "_mha_kernel_batched": "batched", "_mha_kernel_packed": "packed",
    "_mha_kernel_packed_pair": "packed_pair", "_mha_kernel_packed_shortkey": "shortkey",
    "_shortkey_nopair": "shortkey", "_mha_kernel_shortkey_onematmul": "shortkey_onematmul",
    "_shortkey_onematmul_nopair": "shortkey_onematmul",
}


class _BodyRecorder:
    """Stands in for pallas_call: records the kernel body it is given, by the
    port's route name, and returns zeros of the output's shape."""

    def __init__(self):
        self.route = "unset"

    def pallas_call(self, kernel, *, out_shape, **kwargs):
        self.route = BODIES[getattr(kernel, "func", kernel).__name__]
        return lambda *operands: jnp.zeros(out_shape.shape, out_shape.dtype)

    def core(self, q, k, v, **kwargs):
        self.route = None
        return jnp.zeros(q.shape[:2] + (v.shape[-1],), v.dtype)


@pytest.fixture
def jax_bodies(monkeypatch):
    """The JAX dispatch with "on the TPU" stubbed true, its Pallas wrapper
    run eagerly (not from a jit cache filled by other tests) and pallas_call
    and every plain core replaced by the recorder."""
    from mesm_tpu.models import attention as jattention  # flax: imported where it is used

    rec = _BodyRecorder()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(attention_pallas.pl, "pallas_call", rec.pallas_call)
    monkeypatch.setattr(attention_pallas, "_fused_attention_impl", _fused_attention_impl.__wrapped__)
    for name in ("attention_core", "attention_core_shortkey", "attention_core_shortquery",
                 "_attention_core_remat"):
        monkeypatch.setattr(jattention, name, rec.core)
    orig = attention_pallas.fused_attention

    def fused_attention(q, k, v, split_qk=None, **kwargs):  # see test_torch_harness.jax_kernels
        return orig(q, k, v, **kwargs)

    monkeypatch.setattr(attention_pallas, "fused_attention", fused_attention)
    return rec, jattention


LENGTHS = [7, 8, 63, 64, 601]
GRID = list(itertools.product([16], LENGTHS, LENGTHS, ["float32", "bfloat16"], [False, True]))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("training", [False, True])
def test_fused_route_matches_jax_body(jax_bodies, monkeypatch, variant, mode, training):
    """With "on the card" stubbed true on both sides, the kernel the port's
    dispatch picks is the Pallas body the JAX package's reaches (or both
    take the plain core), MESM_ATTN_VARIANT set around both calls."""
    from mesm_tpu import kernels as jkernels

    rec, jattention = jax_bodies
    _set_variant(monkeypatch, variant)
    cuda = torch.device("cuda")
    mismatches = []
    for B, Lq, Lk, dtype, pair in GRID:
        jdt = JAX_DT[dtype]
        q = jnp.zeros((B, Lq, 64), jdt)
        k = v = jnp.zeros((B, Lk, 64), jdt)
        pf = (jnp.zeros((B, 2, Lq), bool), jnp.zeros((B, 2, Lk), bool)) if pair else None
        rec.route = "unset"
        with jkernels.pallas_scope(mode):
            jattention.dispatch_attention_core(
                q, k, v, num_heads=2, key_valid_mask=None, logit_bias=None, pair_factors=pf,
                dropout_rate=0.0, deterministic=not training, dropout_rng=None,
            )
        with kernels.pallas_scope(mode):
            got = kernels.attention_kernel(B, Lq, Lk, TORCH_DT[dtype], cuda, pair=pair,
                                           training=training)
        if got != rec.route:
            mismatches.append(((B, Lq, Lk, dtype, pair), got, rec.route))
    assert not mismatches, mismatches[:10]


def test_every_variant_kernel_is_routed(monkeypatch):
    """Under "on", the grid above reaches per_head, all_heads and batched in
    both dtypes, and the whole packed family in fp32."""
    cuda = torch.device("cuda")
    seen = set()
    for variant in VARIANTS:
        _set_variant(monkeypatch, variant)
        with kernels.pallas_scope("on"):
            for B, Lq, Lk, dtype, pair in GRID:
                route = kernels.attention_kernel(B, Lq, Lk, TORCH_DT[dtype], cuda, pair=pair)
                seen.add((route, dtype))
    for route in ("per_head", "all_heads", "batched", "packed", "packed_pair", "shortkey"):
        assert {(route, "float32"), (route, "bfloat16")} <= seen, route
    monkeypatch.setenv(ENV, "")  # an empty value is unset
    assert kernels.fused_route(601, 601, torch.float32, False) == "batched"
    assert kernels.fused_route(195, 195, torch.bfloat16, False) == "packed"


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _jax_impl(q, k, v, mask, pair, H, dtype, variant):
    jdt = JAX_DT[dtype]
    qf = kf = None
    if pair is not None:  # head-major floats, as fused_attention passes them
        qf, kf = (jnp.asarray(f, jnp.float32).transpose(1, 0, 2) for f in pair)
    with jax.default_matmul_precision("highest"):
        out = _fused_attention_impl(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(mask, jnp.float32), H, True, variant, qf, kf,
        )
    return np.asarray(out.astype(jnp.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrays]


LAYOUT_KERNELS = {
    "per_head": ah.attention_per_head, "all_heads": ah.attention_all_heads,
    "batched": ab.attention_batched,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk", [(64, 64), (70, 81)])
@pytest.mark.parametrize("variant", ["per_head", "all_heads", "batched"])
def test_layout_plain_versions_match_pallas(variant, lq, lk, dtype):
    """Kernels 8, 7 and 6: one function, attention_batched_reference, in
    fp32 and bf16; a sample whose keys are all masked averages v."""
    B, E, H = 4, 64, 2
    q, k, v, mask, _ = _case(0, B, lq, lk, E, H)
    want = _jax_impl(q, k, v, mask, None, H, dtype, variant)
    tq, tk, tv = _torch((q, k, v), dtype)
    got = LAYOUT_KERNELS[variant](tq, tk, tv, H, torch.from_numpy(mask))
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got[1], np.broadcast_to(tv[1].float().numpy().mean(0), got[1].shape),
                               atol=TOL[dtype])
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("variant,route", [("per_head", "per_head"), ("all_heads", "all_heads"),
                                           ("batched", "batched"), ("packed", "packed"),
                                           ("other", "per_head")])
def test_dispatch_takes_the_variant_plain_version(monkeypatch, variant, route):
    """On CPU tensors under "on", the dispatch runs the routed kernel's
    wrapper (its plain version here), fp32 and bf16, in eval."""
    called = []
    names = {"per_head": "attention_per_head", "all_heads": "attention_all_heads",
             "batched": "attention_batched", "packed": "attention_packed"}
    orig = getattr(at, names[route])
    monkeypatch.setattr(at, names[route], lambda *a, **kw: called.append(1) or orig(*a, **kw))
    monkeypatch.setenv(ENV, variant)
    B, Lq, E, H = 4, 64, 64, 2
    for dtype in ("float32", "bfloat16"):
        q, k, v, mask, _ = _case(3, B, Lq, 72, E, H)
        tq, tk, tv = _torch((q, k, v), dtype)
        tm = torch.from_numpy(mask)
        with kernels.pallas_scope("on"), torch.no_grad():
            got = dispatch_attention_core(tq, tk, tv, H, key_valid_mask=tm)
        torch.testing.assert_close(got, orig(tq, tk, tv, H, tm), rtol=0, atol=0)
    assert len(called) == 2


@pytest.mark.parametrize("variant", ["per_head", "all_heads", "batched", "packed"])
def test_trainable_under_variant_matches_attention_core(monkeypatch, variant):
    """Under each variant, the trainable Function (the variant's kernel
    forward, attention_core's recomputed backward) gives attention_core's
    value and gradients in fp32 (1e-5)."""
    monkeypatch.setenv(ENV, variant)
    B, Lq, Lk, E, H = 4, 66, 72, 64, 2
    q, k, v, mask, _ = _case(4, B, Lq, Lk, E, H)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(B, Lq, E)).astype(np.float32))
    tm = torch.from_numpy(mask)

    def run(fn):
        # grad mode on: tests/test_transformer_oracle.py turns it off for the
        # whole process when it is imported
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_(True) for t in _torch((q, k, v), "float32")]
            out = fn(*leaves)
            out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    assert kernels.fused_route(Lq, Lk, torch.float32, False) == variant
    got = run(lambda a, b, c: at.attention_trainable(a, b, c, H, tm))
    want = run(lambda a, b, c: attention_core(a, b, c, H, key_valid_mask=tm))
    for x, y in zip(got, want):
        assert _err(x.numpy(), y.numpy()) <= 1e-5


def test_variant_wrappers_refuse_what_the_kernel_does_not_take():
    """Non-CPU tensors the kernels do not take raise before any launch (meta
    tensors stand in for device tensors)."""
    before = (ah.per_head_launches, ah.all_heads_launches)
    q = torch.zeros(2, 64, 64, dtype=torch.float32, device="meta")
    wide = torch.zeros(2, 64, 512, dtype=torch.float32, device="meta")
    for fn in (ah.attention_per_head, ah.attention_all_heads):
        with pytest.raises(TypeError):
            fn(q.half(), q.half(), q.half(), 2)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(wide, wide, wide, 2)  # head_dim 256: the wide bodies
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, 4)  # head_dim 16: an instance
        with pytest.raises(ValueError, match="shapes"):
            fn(q, q, q[..., :32].contiguous(), 2)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, 2)
    assert (ah.per_head_launches, ah.all_heads_launches) == before


def test_variant_wrappers_run_plain_versions_on_cpu_without_counting():
    before = (ah.per_head_launches, ah.all_heads_launches, ab.launches, ap.launches)
    q, k, v, mask, _ = _case(6, 3, 9, 11, 64, 2)
    for dtype in ("float32", "bfloat16"):
        tq, tk, tv = _torch((q, k, v), dtype)
        tm = torch.from_numpy(mask)
        want = ab.attention_batched_reference(tq, tk, tv, 2, tm)
        for fn in (ah.attention_per_head, ah.attention_all_heads, ab.attention_batched):
            torch.testing.assert_close(fn(tq, tk, tv, 2, tm), want, rtol=0, atol=0)
        torch.testing.assert_close(ap.attention_packed(tq, tk, tv, 2, tm),
                                   ap.attention_packed_reference(tq, tk, tv, 2, tm), rtol=0, atol=0)
    assert (ah.per_head_launches, ah.all_heads_launches, ab.launches, ap.launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _card_case(B, Lq, Lk, dtype, pair: bool, seed=0, E=256):
    g = torch.Generator(device="cuda").manual_seed(seed)
    H = 8
    q = torch.randn(B, Lq, E, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").to(dtype) for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    if B > 1:
        mask[1] = False
    pf = None
    if pair:
        pf = (torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4,
              torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4)
    return q, k, v, mask, pf, H


CARD_CASES = [  # (kernel, dtype, B, Lq, Lk, pair): the charades and TACoS encoder sites,
    # and the TACoS T2V sites under "on" with the packed variant
    ("per_head", torch.float32, 16, 601, 601, False), ("per_head", torch.bfloat16, 128, 195, 195, False),
    ("all_heads", torch.float32, 16, 601, 601, False), ("all_heads", torch.bfloat16, 128, 195, 195, False),
    ("batched", torch.bfloat16, 128, 195, 195, False), ("packed", torch.float32, 16, 601, 601, False),
    ("packed_pair", torch.float32, 16, 600, 81, True), ("shortkey", torch.float32, 16, 600, 17, True),
]
# the edges of the encoder kernels' tiles (chip_smoke.HEADS_EDGE_SHAPES), and
# the bf16 batched shapes past the mma staging, which take its register tiles
CARD_CASES += [(kernel, dtype, B, Lq, Lk, False, E)
               for kernel in ("per_head", "all_heads", "batched", "packed")
               for dtype in (torch.bfloat16, torch.float32) for B, Lq, Lk, E in HEADS_EDGE_SHAPES]
CARD_CASES += [("batched", torch.bfloat16, B, Lq, Lk, False, E)
               for B, Lq, Lk, E in BATCHED_REGTILE_SHAPES]
CARD_CASES = [case if len(case) == 7 else case + (256,) for case in CARD_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype,B,Lq,Lk,pair,E", CARD_CASES)
def test_variant_kernels_match_plain(cuda, kernel, dtype, B, Lq, Lk, pair, E):
    q, k, v, mask, pf, H = _card_case(B, Lq, Lk, dtype, pair, E=E)
    fns = {"per_head": (ah.attention_per_head, ab.attention_batched_reference),
           "all_heads": (ah.attention_all_heads, ab.attention_batched_reference),
           "batched": (ab.attention_batched, ab.attention_batched_reference),
           "packed": (ap.attention_packed, ap.attention_packed_reference),
           "packed_pair": (ap.attention_packed_pair, ap.attention_packed_pair_reference),
           "shortkey": (sk.attention_shortkey, sk.attention_shortkey_reference)}
    fn, ref = fns[kernel]
    args = (q, k, v, H, mask) + ((pf,) if kernel in ("packed_pair", "shortkey") else ())
    got = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    tol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1)) <= tol
    # sample 1: every key masked, every head uniform over all Lk keys
    if B > 1:
        assert float((got[1].float() - v[1].float().mean(0)).abs().max()) <= tol


def _launch_counts():
    return (ah.per_head_launches, ah.all_heads_launches, ab.launches, ap.launches,
            ap.pair_launches)


def attention_packed_pair_bf16(q, k, v, num_heads):
    """The pair entry point with no pair flagged (its bf16 route is the mma
    body)."""
    B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
    flags = (torch.zeros(B, num_heads, Lq, dtype=torch.bool, device=q.device),
             torch.zeros(B, num_heads, Lk, dtype=torch.bool, device=q.device))
    return ap.attention_packed_pair(q, k, v, num_heads, None, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [ah.attention_per_head, ah.attention_all_heads, ab.attention_batched,
                                ap.attention_packed, attention_packed_pair_bf16],
                         ids=lambda f: f.__name__)
def test_tile_kernels_refuse_operands_off_a_16_byte_boundary(cuda, fn):
    """The kernels on the mma and register tiles load q, k and v 16 bytes
    at a time (cp.async, float4): a contiguous tensor that starts off a
    16-byte boundary raises before any launch."""
    B, L, E = 2, 70, 256
    q = torch.randn(B * L * E + 1, device=cuda).to(torch.bfloat16)[1:].view(B, L, E)
    k = torch.randn(B, L, E, device=cuda).to(torch.bfloat16)
    before = _launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fn(q, k, k, 8)
    assert _launch_counts() == before
