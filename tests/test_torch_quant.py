"""mesm_tpu_torch.ops.quant.int8_dense against mesm_tpu.ops.quant.int8_dense
(the JAX function takes the kernel in flax layout, (in, out), the port the
torch weight, (out, in)): fp32 within 1e-6 relative, bf16 within one bf16
ulp; the plain version's f64 sums equal the CPU's int32 product; the CUDA
path's padding checked with _int_mm emulated on the CPU."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.ops.quant import int8_dense as jax_int8_dense
from mesm_tpu_torch.ops import quant

SHAPES = [((4, 7, 32), 48), ((1, 5), 3), ((300, 256), 1024), ((17, 33), 70)]


def _inputs(xs, N, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(xs) * 2).astype(np.float32)
    w = (rng.standard_normal((N, xs[-1])) * 0.1).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("xs,N", SHAPES)
def test_int8_dense_matches_jax_fp32(xs, N):
    x, w, b = _inputs(xs, N)
    want = np.asarray(jax_int8_dense(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b)))
    got = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("xs,N", SHAPES[:2])
def test_int8_dense_matches_jax_bf16(xs, N):
    x, w, b = _inputs(xs, N, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_int8_dense(xb, jnp.asarray(w.T), jnp.asarray(b)).astype(jnp.float32))
    got_t = quant.int8_dense(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
                             torch.from_numpy(w), torch.from_numpy(b))
    assert got_t.dtype == torch.bfloat16
    got = got_t.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("xs,N", SHAPES)
def test_plain_version_equals_the_int32_product(xs, N):
    x, w, b = (torch.from_numpy(a) for a in _inputs(xs, N, seed=2))
    torch.testing.assert_close(quant.int8_dense_reference(x, w, b), quant.int8_dense(x, w, b),
                               atol=0, rtol=0)


def test_cuda_path_pads_to_what_int_mm_takes(monkeypatch):
    """_int_mm emulated on the CPU with CUDA's shape rules: the padded call
    returns the unpadded int32 sums."""
    seen = []

    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        seen.append((tuple(a.shape), tuple(b.shape)))
        return a.to(torch.int32) @ b.to(torch.int32)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    rng = np.random.default_rng(3)
    for M, K, N in ((1, 5, 3), (16, 33, 70), (300, 256, 1024)):
        xq = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
        got = quant._padded_int_mm(xq, wq)
        assert got.shape == (M, N)
        torch.testing.assert_close(got, xq.to(torch.int32) @ wq.to(torch.int32).t())
    assert seen[0] == ((17, 8), (8, 8))


def test_cuda_path_raises_when_int_mm_refuses(monkeypatch):
    def refuse(a, b):
        raise RuntimeError("shape not supported")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    with pytest.raises(RuntimeError, match="int8_dense: torch._int_mm refused"):
        quant._padded_int_mm(torch.zeros((4, 8), dtype=torch.int8),
                             torch.zeros((8, 8), dtype=torch.int8))
