"""Kernel 1, the fused LayerNorm -> Dense, over its whole domain.

The CUDA kernel (kernels/csrc/ln_dense.cu) takes any D and any F: bf16
products on wgmma, float32 products in 3xTF32 on wgmma, the weight read
through a TMA tensor map from a copy the wrapper caches per weight version
(ops/ln_dense.kernel_weights). Here, on the CPU:

- `ln_dense_reference` (what the wrapper runs on CPU tensors) against the
  Pallas kernel `fused_ln_dense` in interpret mode at F 40 and 512 and D 256
  and 8192 (widths an earlier design of the kernel refused: F above 256, F
  not a multiple of 16 in bf16, and D whose rows did not fit a block). Tolerances as the existing
  parity test: fp32 1e-5 abs (summation order), bf16 3e-2 abs (one bf16
  step of an output of a few units);
- an emulation of the kernel's fp32 product (each operand split into tf32
  hi and lo parts, three TF32 products a k step of 8, the tensor cores'
  truncated sums from zero every K tile of 32, each tile's sum added in
  f32) at the TACoS shape's sums (D 4098, F 256) stays within the card's
  1e-4 of fp32, where one TF32 product does not;
- the weight cache makes one copy per weight version and dtype, drops it on
  an in-place update, and keeps nothing of a freed weight.
"""
from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops.layer_pallas import fused_ln_dense
from mesm_tpu_torch.ops import ln_dense as ld
from test_torch_attention_backward import _mm_3xtf32, _tf32_rna

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, N, D, F):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32) * 2.0 + 0.5
    g = rng.normal(size=D).astype(np.float32)
    b = rng.normal(size=D).astype(np.float32)
    w = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)  # flax (D, F)
    db = rng.normal(size=F).astype(np.float32)
    return x, g, b, w, db


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [256, 8192])
@pytest.mark.parametrize("F", [40, 512])
def test_reference_matches_pallas_at_any_width(F, D, dtype):
    x, g, b, w, db = _inputs(F + D, 21, D, F)
    relu = F == 40
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.default_matmul_precision("highest"):
        want = fused_ln_dense(jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b), jnp.asarray(w),
                              jnp.asarray(db), relu=relu, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = ld.ln_dense(torch.from_numpy(x).to(TORCH_DT[dtype]), torch.from_numpy(g),
                      torch.from_numpy(b), torch.from_numpy(np.ascontiguousarray(w.T)),
                      torch.from_numpy(db), relu)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (21, F)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


def test_3xtf32_product_holds_the_fp32_tolerance_at_the_tacos_shape():
    """The TACoS input projection's sums (D = 4098 -> F = 256) on 16 rows:
    the normalised rows of the plain version times the weight as the kernel
    takes the product (_mm_3xtf32 at its K tile of 32), plus the bias,
    against the plain version's f32 output, in units of max(1, max |plain|):
    within 1e-4, the card's tolerance; one TF32 product is not. The weight's
    cached split is the emulation's (ld.tf32_split)."""
    N, D, F = 16, 4098, 256
    x, g, b, w, db = _inputs(7, N, D, F)
    x, g, b, db = (torch.from_numpy(a) for a in (x, g, b, db))
    wt = torch.from_numpy(np.ascontiguousarray(w.T))  # (F, D), torch layout
    want = ld.ln_dense_reference(x, g, b, wt, db, relu=False)
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    y = ((x - mu) * torch.rsqrt(var + ld.LN_EPS)) * g + b
    hi, lo = ld.tf32_split(wt)
    assert torch.equal(hi, _tf32_rna(wt)) and torch.equal(lo, _tf32_rna(wt - hi))
    scale = max(1.0, float(want.abs().max()))
    err = float((_mm_3xtf32(y, wt.T, 32) + db - want).abs().max()) / scale
    err_1x = float((_mm_3xtf32(y, wt.T, 32, terms="1x") + db - want).abs().max()) / scale
    assert err <= 1e-4 / 4, err
    assert err_1x > 1e-4, err_1x


def test_weight_cache_keeps_one_copy_per_version_and_dtype():
    """The padded copy (bf16) and the split copies (fp32) are made once per
    version of the weight and dtype: reused while the weight is unchanged,
    made again after an in-place update (its _version moves), and dropped
    with the weight. Each copy holds the weight's values in its first D
    columns and zeros past them, on its own memory."""
    F, D = 40, 70
    w = torch.randn(F, D, generator=torch.Generator().manual_seed(3))
    made = ld.weight_copies
    (wp,) = ld.kernel_weights(w, torch.bfloat16)
    assert wp.shape == (F, ld.padded_width(D, torch.bfloat16)) == (F, 72)
    assert torch.equal(wp[:, :D], w.to(torch.bfloat16)) and not wp[:, D:].any()
    assert ld.kernel_weights(w, torch.bfloat16)[0] is wp
    hi, lo = ld.kernel_weights(w, torch.float32)
    assert hi.shape == (F, ld.padded_width(D, torch.float32)) == (F, 72)
    assert float((hi[:, :D] + lo[:, :D] - w).abs().max()) <= 2.0**-21 * float(w.abs().max())
    assert not hi[:, D:].any() and not lo[:, D:].any()
    assert ld.weight_copies == made + 2
    with torch.no_grad():
        w.add_(1.0)  # an in-place update: a new version
    (wp2,) = ld.kernel_weights(w, torch.bfloat16)
    assert wp2 is not wp and torch.equal(wp2[:, :D], w.to(torch.bfloat16))
    assert ld.weight_copies == made + 3
    assert wp.data_ptr() != w.data_ptr() and wp2.data_ptr() != w.data_ptr()
    key = id(w)
    assert key in ld._weight_cache
    del w
    gc.collect()
    assert key not in ld._weight_cache


def test_cpu_tensors_take_the_plain_version_at_any_width():
    """On CPU tensors the wrapper is the plain version, at every F and D
    the kernel takes, and counts no launch."""
    before = ld.launches
    for F, D in ((40, 70), (512, 33), (300, 8192)):
        x, g, b, w, db = (torch.from_numpy(a) for a in _inputs(F, 5, D, F))
        wt = w.t().contiguous()
        torch.testing.assert_close(ld.ln_dense(x, g, b, wt, db, True),
                                   ld.ln_dense_reference(x, g, b, wt, db, True), rtol=0, atol=0)
    assert ld.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_at_its_edges(cuda):
    """chip_smoke's ln_dense edges (ragged row tiles, F 40, 300 and 512, D
    256, 2817 and 8192, with and without ReLU, both dtypes; x, gamma and
    beta off 16-byte boundaries) on its two device kernels, within bf16
    2**-6 and fp32 1e-4 of the plain version."""
    from chip_smoke import check_ln_dense_edges

    assert all(r["max_err_rel_to_max1"] <= r["tol"] for r in check_ln_dense_edges())


@pytest.mark.cuda
def test_kernel_rows_are_the_same_bits_at_any_address(cuda):
    """A row's statistics are summed in an order fixed by the elements'
    indices: rows at every element offset of a 16-byte span give the bits
    of the rows at offset 0 (the coalesced eval step projects K batches'
    rows in one call)."""
    from chip_smoke import check_ln_dense_alignment

    assert check_ln_dense_alignment()["ok"]


@pytest.mark.cuda
def test_kernel_weight_cache_follows_the_weight_on_the_card(cuda):
    """An in-place update of the weight changes the kernel's result the next
    call (the cached copy is made again)."""
    from chip_smoke import TOL as CARD_TOL
    from chip_smoke import _ln_inputs, _rel_err

    x, g, b, w, bb = _ln_inputs("bfloat16", 300, 2818, 256)
    first = ld.ln_dense(x, g, b, w, bb, False)
    with torch.no_grad():
        w.mul_(2.0)
    second = ld.ln_dense(x, g, b, w, bb, False)
    want = ld.ln_dense_reference(x, g, b, w, bb, False)
    assert _rel_err(second, want) <= CARD_TOL["ln_dense_bfloat16"]
    assert not torch.equal(first, second)
