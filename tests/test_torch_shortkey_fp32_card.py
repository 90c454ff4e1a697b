"""The fp32 short-key kernels (kernels 4 and 5 in float32) on the card
(skipped on a host without one). No JAX import, so the card's machine runs
this file.

Each kernel against its plain version on the same seeded inputs, 1e-5 in
units of max(1, max |plain|) (every rounding is to f32; the 3xTF32 products
and the sums run in another order), with one launch counted (the device
kernel each case launches is checked by name in chip_smoke.py's
attention_edges line, through the profiler): at the fp32 sites
(chip_smoke.FP32_SHORT_KEY_SITES), at the edges of the kernels' tiles
(chip_smoke.FP32_SHORTKEY_EDGE_LQ x FP32_SHORTKEY_EDGE_LK), at head_dim 16,
64, 128 and 256, with and without pair factors. Sample 1 has every key
masked and rows of sample 0's head 0 every key dropped by the pair mask:
those rows hold the mean of v over all Lk keys. The one-matmul kernel's
underflowed segments (a head's logits ~180 below the row's maximum, far
from the exp's threshold near 88-104) take 1/Lk on every key.
"""
from __future__ import annotations

import itertools

import pytest
import torch

import chip_smoke as cs
from mesm_tpu_torch.ops import attention_shortkey as sk

TOL = 1e-5
KERNELS = {"shortkey": (sk.attention_shortkey, sk.attention_shortkey_reference, "launches"),
           "onematmul": (sk.attention_shortkey_onematmul, sk.attention_shortkey_onematmul_reference,
                         "onematmul_launches")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _inputs(B: int, Lq: int, Lk: int, E: int, H: int, pair: bool, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda")
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda") for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    mask[1] = False
    pf = None
    if pair:
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[0, 0] = True
        qf[0, 0, ::2] = True
        pf = (qf, kf)
    return q, k, v, mask, pf


def _check(kernel: str, q, k, v, mask, pf, H: int):
    fn, ref, counter = KERNELS[kernel]
    before = getattr(sk, counter)
    got = fn(q, k, v, H, mask, pf)
    want = ref(q, k, v, H, mask, pf)
    torch.cuda.synchronize()
    assert getattr(sk, counter) == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max().clamp(min=1.0)) <= TOL
    dead_err, dead_rows = cs._dead_rows_vs_mean_v(got, v, mask, pf, H)
    assert dead_rows > 0 and dead_err <= TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("site,B,Lq,Lk", cs.FP32_SHORT_KEY_SITES)
@pytest.mark.parametrize("kernel", ["shortkey", "onematmul"])
def test_fp32_short_key_kernels_at_the_sites(cuda, kernel, site, B, Lq, Lk, pair):
    _check(kernel, *_inputs(B, Lq, Lk, 256, 8, pair, seed=B + Lq + Lk + pair), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,pair", list(itertools.product(
    cs.FP32_SHORTKEY_EDGE_LQ, cs.FP32_SHORTKEY_EDGE_LK, (True, False))))
@pytest.mark.parametrize("kernel", ["shortkey", "onematmul"])
def test_fp32_short_key_kernels_at_the_tile_edges(cuda, kernel, Lq, Lk, pair):
    _check(kernel, *_inputs(3, Lq, Lk, 256, 8, pair, seed=Lq * 100 + Lk + pair), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("hd,Lk", [(16, 17), (64, 33), (64, 65), (128, 17), (128, 40),
                                   (256, 17), (256, 100)])
@pytest.mark.parametrize("kernel", ["shortkey", "onematmul"])
def test_fp32_short_key_kernels_at_other_head_dims(cuda, kernel, hd, Lk, pair):
    H = 4
    _check(kernel, *_inputs(3, 70, Lk, H * hd, H, pair, seed=hd + Lk + pair), H)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 256])
def test_fp32_onematmul_kernel_takes_the_fallback_of_an_underflowed_segment(cuda, hd):
    """Sample 2's head 1 logits sit ~180 (hd 32) or more above its other
    heads' (head 0's are 0): their segment sums underflow to 0, so each of
    them takes 1/Lk on every key (the mean of v over all Lk keys, padded
    keys included) while head 1 keeps its own softmax."""
    H, Lk = 8, 17
    q, k, v, mask, pf = _inputs(3, 70, Lk, H * hd, H, True, seed=5 + hd)
    sign = torch.randint(0, 2, (hd,), generator=torch.Generator().manual_seed(9)).cuda() * 2 - 1
    q[2, :, hd:2 * hd] = 40.0 * sign
    k[2, :, hd:2 * hd] = k[2, :, hd:2 * hd].abs() * sign
    k[2, :, :hd] = 0.0
    pf[0][2, 1] = False  # head 1 keeps every unmasked key
    got = _check("onematmul", q, k, v, mask, pf, H)
    mean_v = v[2].mean(0)
    for h in (0, 2, 7):
        cols = slice(h * hd, (h + 1) * hd)
        assert float((got[2, :, cols] - mean_v[cols]).abs().max()) <= TOL
    assert float((got[2, :, hd:2 * hd] - mean_v[hd:2 * hd]).abs().max()) > 1e-2
