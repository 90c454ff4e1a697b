"""The port's kernel plain versions against the JAX package's Pallas kernels.

The CUDA kernels run only on a GPU; their plain torch versions
(`ln_dense_reference`, `attention_packed_reference`) carry the same
arithmetic and are what a wrapper runs for CPU tensors. Here each plain
version meets the Pallas kernel it stands for, run in interpret mode on the
CPU, on the same inputs made from a numpy seed. Tolerances: fp32 1e-5 abs
(the two differ only in summation order); bf16 3e-2 abs (bf16 keeps 8
mantissa bits, and a sum taken in another order or an exp one ulp apart can
move a bf16 rounding by one step).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops.attention_pallas import _fused_attention_impl
from mesm_tpu.ops.layer_pallas import fused_ln_dense
from mesm_tpu_torch.ops import attention_packed as ap
from mesm_tpu_torch.ops import ln_dense as ld

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(37, 70), (3, 13, 70)])
def test_ln_dense_reference_matches_pallas(shape, relu, dtype):
    rng = np.random.default_rng(0)
    D, F = shape[-1], 48
    x = rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    g = rng.normal(size=D).astype(np.float32)
    b = rng.normal(size=D).astype(np.float32)
    w = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)  # flax (D, F)
    db = rng.normal(size=F).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.default_matmul_precision("highest"):
        want = fused_ln_dense(
            jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b), jnp.asarray(w),
            jnp.asarray(db), relu=relu, interpret=True,
        )
    want = np.asarray(want.astype(jnp.float32))
    got = ld.ln_dense(
        _to_torch(x, dtype), torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(db), relu,
    )
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk", [(64, 64), (72, 96)])
def test_attention_packed_reference_matches_pallas(lq, lk, dtype):
    rng = np.random.default_rng(1)
    B, H, E = 4, 4, 64
    q = rng.normal(size=(B, lq, E)).astype(np.float32)
    k = rng.normal(size=(B, lk, E)).astype(np.float32)
    v = rng.normal(size=(B, lk, E)).astype(np.float32)
    mask = rng.random((B, lk)) < 0.8
    mask[:, 0] = False  # the global token is never a key
    mask[2] = False  # a padded row: every key masked
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.default_matmul_precision("highest"):
        want = _fused_attention_impl(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(mask, jnp.float32), H, True, "packed",
        )
    want = np.asarray(want.astype(jnp.float32))
    got = ap.attention_packed(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), H, torch.from_numpy(mask)
    )
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    # the fully masked sample: every query gets the plain average of v
    v_mean = _to_torch(v, dtype).float().numpy()[2].mean(0)
    np.testing.assert_allclose(got[2], np.broadcast_to(v_mean, got[2].shape), atol=TOL[dtype])
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_dense_kernel_matches_plain(cuda, dtype):
    """The CUDA kernel against its plain version on the card, with a ragged
    last block of rows and D not a multiple of 16."""
    g = torch.Generator(device=cuda).manual_seed(0)
    N, D, F = 77, 2818, 256
    x = torch.randn(3, N, D, generator=g, device=cuda).to(TORCH_DT[dtype])
    gamma, beta = torch.randn(D, generator=g, device=cuda), torch.randn(D, generator=g, device=cuda)
    w = torch.randn(F, D, generator=g, device=cuda) / D**0.5
    b = torch.randn(F, generator=g, device=cuda)
    before = ld.launches
    got = ld.ln_dense(x, gamma, beta, w, b, True)
    want = ld.ln_dense_reference(x, gamma, beta, w, b, True)
    torch.cuda.synchronize()
    assert ld.launches == before + 1
    tol = 2.0**-6 if dtype == "bfloat16" else 1e-4  # relative to max(1, |plain|)
    err = ((got.float() - want.float()).abs() / want.float().abs().clamp(min=1)).max()
    assert float(err) <= tol


@pytest.mark.cuda
def test_attention_packed_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, L, E, H = 16, 195, 256, 8
    q, k, v = (torch.randn(B, L, E, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    mask = torch.rand(B, L, generator=g, device=cuda) < 0.8
    mask[:, 0] = False
    mask[3] = False
    before = ap.launches
    got = ap.attention_packed(q, k, v, H, mask)
    want = ap.attention_packed_reference(q, k, v, H, mask)
    torch.cuda.synchronize()
    assert ap.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]
