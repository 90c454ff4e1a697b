"""The fp32 short-key kernels (kernels 4 and 5 in float32): their route in
the CUDA source and their plain versions against the JAX package's Pallas
kernels at the edges of the CUDA kernels' tiles, on the CPU.

The CUDA side cannot run here, so the source test reads
kernels/csrc/attention_shortkey.cu: float32 operands of both short-key
kernels reach tensor-core kernels in 3xTF32 (the packed short-key kernel
the 3xTF32 body of attention_fp32.cuh, the one-matmul kernel its own
mma.sync m16n8k8 kernel), and the one CUDA-core kernel left is the fp32
one-matmul kernel's at a head_dim above 128, a route taken by shape. The
parity test runs the wrappers on CPU tensors (their plain versions) against
`_mha_kernel_packed_shortkey` / `_shortkey_nopair` (through the packed
dispatch with its short-key threshold raised above the keys, so that 64 and
65 keys reach the short-key kernel too) and `fused_attention_shortkey`, in
interpret mode, at query rows around the 64-row tiles and keys around the
fp32 kernels' tiles of 24, 32 and 40 keys, n8 tiles and key groups of 64,
with and without pair factors. Inputs come from a numpy seed with padded
keys, a sample whose keys are all masked and fully masked (b, h, q) rows.
Tolerance 1e-5 in units of max(1, max |reference|): every rounding is to
f32, sums in another order. The card tests are in
test_torch_shortkey_fp32_card.py (no JAX import).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops import attention_pallas
from mesm_tpu.ops.attention_pallas import _fused_attention_impl, fused_attention_shortkey
from mesm_tpu_torch.ops import attention_shortkey as sk

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
B, E, H = 3, 64, 2
# (Lq, Lk): every query count around the 64-row tiles meets every key count
# around the fp32 kernels' key tiles at least once
EDGES = [(63, 1), (64, 16), (65, 17), (63, 32), (64, 33), (65, 64), (63, 65)]


def _case(seed: int, Lq: int, Lk: int):
    """q, k, v, a key mask with padded keys and sample 1 fully masked, and
    pair factors with sample 2's head 1 flagging every key and every other
    query (rows whose every key is dropped)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, E)).astype(np.float32) for L in (Lq, Lk, Lk))
    mask = np.arange(Lk)[None] < rng.integers(max(1, Lk // 2), Lk + 1, B)[:, None]
    mask[1] = False
    qf, kf = rng.random((B, H, Lq)) < 0.4, rng.random((B, H, Lk)) < 0.4
    kf[2, 1] = True
    qf[2, 1, ::2] = True
    return q, k, v, mask, (qf, kf)


def _jax_shortkey(q, k, v, mask, pair):
    """_mha_kernel_packed_shortkey / _shortkey_nopair in interpret mode: the
    packed dispatch, run unjitted (no cached trace) with its short-key
    threshold above Lk."""
    impl = _fused_attention_impl.__wrapped__
    qf = kf = None
    if pair is not None:  # head-major floats, as fused_attention passes them
        qf, kf = (jnp.asarray(f, jnp.float32).transpose(1, 0, 2) for f in pair)
    with jax.default_matmul_precision("highest"):
        out = impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask, jnp.float32),
                   H, True, "packed", qf, kf)
    return np.asarray(out)


def _jax_onematmul(q, k, v, mask, pair):
    with jax.default_matmul_precision("highest"):
        out = fused_attention_shortkey(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, jnp.asarray(mask),
            None if pair is None else tuple(jnp.asarray(f) for f in pair), interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("with_pair", [True, False])
@pytest.mark.parametrize("lq,lk", EDGES)
@pytest.mark.parametrize("kernel", ["shortkey", "onematmul"])
def test_fp32_plain_versions_match_pallas_at_the_tile_edges(monkeypatch, kernel, lq, lk,
                                                            with_pair):
    monkeypatch.setattr(attention_pallas, "MIN_FUSED_LK", 128)
    q, k, v, mask, pair = _case(lq * 100 + lk, lq, lk)
    pair = pair if with_pair else None
    if kernel == "shortkey":
        fn, want = sk.attention_shortkey, _jax_shortkey(q, k, v, mask, pair)
    else:
        fn, want = sk.attention_shortkey_onematmul, _jax_onematmul(q, k, v, mask, pair)
    tp = None if pair is None else tuple(torch.from_numpy(f) for f in pair)
    got = fn(*(torch.from_numpy(a) for a in (q, k, v)), H, torch.from_numpy(mask), tp)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max() / max(1.0, np.abs(want).max())) <= TOL
    # sample 1: every key masked, every head the mean of v over all Lk keys
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), got[1].shape), atol=TOL)


def test_fp32_short_key_kernels_run_on_the_tensor_cores():
    """attention_shortkey.cu sends float32 operands to 3xTF32 kernels: the
    packed short-key kernel to the body of attention_fp32.cuh (the fp32 pair
    kernel's, the pair flags a compile-time option, key tiles of 24, 40 or
    32 by Lk, its wide path above head_dim 128); the one-matmul kernel to
    its own kernel of mma.sync m16n8k8 products of split operands (the
    small terms first), two passes over every head of a 64-row tile, a
    correctly rounded e / s_h and expf. The CUDA-core body of both (IO<float>,
    its Layout) is gone; one CUDA-core kernel stays, the fp32 one-matmul
    kernel's at a wide head, taken by shape before the launch."""
    csrc = REPO / "mesm_tpu_torch" / "kernels" / "csrc"
    source = (csrc / "attention_shortkey.cu").read_text()
    assert '#include "attention_fp32.cuh"' in source
    assert "struct IO<" not in source and "struct Layout" not in source
    assert "dispatch_pair<" not in source
    route = source[source.index('extern "C" int attention_shortkey_launch'):]
    assert "launch_3xtf32<HD, true>(" in route and "launch_3xtf32<HD, false>(" in route
    assert "launch_onematmul_3xtf32<HD, true>(" in route
    assert "launch_onematmul_3xtf32<HD, false>(" in route
    # the CUDA-core kernel only at a wide head
    wide = route[route.index("if constexpr (HD == attn_grid::WIDE)\n        return pair ? "
                             "launch_onematmul_fp32_wide"):]
    assert wide.index("launch_onematmul_fp32_wide") < wide.index("launch_onematmul_3xtf32")
    assert "fp32_attn::block_attend<HD, PAIR, KN>(" in source
    assert "fp32_attn::block_attend_wide<PAIR>(" in source
    assert "if (Lk <= 24) return f(attn_grid::HeadDim<24>{});" in source
    assert "if (Lk > 32 && Lk <= 40) return f(attn_grid::HeadDim<40>{});" in source
    kernel = source[source.index("attention_shortkey_onematmul_3xtf32_kernel("):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert kernel.count("mma3_split(") == 3 and "fmaf(" not in kernel
    assert "expf(s[nt][0] - m0)" in kernel and "__expf" not in kernel
    assert "const SegmentDivide div0(l0), div1(l1);" in kernel
    assert "__fmul_rn(x0.x, scale)" in kernel  # qs rounded to f32 before the split
    helper = source[source.index("void mma3_split("):]
    helper = helper[:helper.index("\n}\n")]
    assert helper.index("a.lo, bh0, bh1") < helper.index("a.hi, bl0, bl1") < helper.index(
        "a.hi, bh0, bh1")
    assert "--use_fast_math" not in (REPO / "mesm_tpu_torch" / "kernels" / "build.py").read_text()
    header = (csrc / "attention_tf32.cuh").read_text()
    assert "attention_shortkey.cu" in header[:header.index("#pragma once")]


@pytest.mark.parametrize("onematmul,hd,lk", [
    (False, 32, 17), (False, 32, 1000), (False, 256, 17), (True, 32, 17), (True, 32, 65),
    (True, 32, 90), (True, 16, 17), (True, 128, 17), (True, 256, 300),
])
def test_fp32_short_key_wrappers_take_the_shapes_they_took(onematmul, hd, lk):
    """Before any launch the fp32 wrappers take every head_dim and, the
    one-matmul kernel past 64 keys, the packed short-key kernel at any Lk:
    on a device that is neither the CPU nor CUDA an accepted operand set
    reaches the device check and no launch is counted."""
    Hh = 8 if hd <= 128 else 1
    q = torch.empty(2, 5, Hh * hd, device="meta")
    k = torch.empty(2, lk, Hh * hd, device="meta")
    fn = sk.attention_shortkey_onematmul if onematmul else sk.attention_shortkey
    before = (sk.launches, sk.onematmul_launches)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(q, k, k, Hh)
    assert (sk.launches, sk.onematmul_launches) == before
