"""Dynamic int8 dense: y = x @ W^T + b with int8 x int8 -> int32 products.

Counterpart of mesm_tpu/ops/quant.py::int8_dense, an XLA dot_general that
nothing in either package calls (mesm_tpu/kernels.py:112-113 records it as
slower than bf16 on the TPU); ported as the function it is. Per output
channel weight scales and per row dynamic activation scales, each
max(amax |.|, 1e-8) / 127 in f32, values rounded half to even (and
saturated to int8, as XLA's conversion is), int32 sums, then the f32
epilogue in the JAX order ((acc * xscale) * wscale) + bias, returned in x's
dtype.

The weight is in torch Linear layout, (out, in): its rows are the JAX
kernel's columns. On CUDA the product is torch._int_mm (cuBLASLt's int8
GEMM): this function is XLA code in the JAX package, not a Pallas kernel,
so a library GEMM is its port. `_int_mm` takes M > 16 rows and K, N
multiples of 8, so the wrapper pads with zeros (which add nothing to a sum)
and slices the result; where `_int_mm` still refuses, the error is raised,
never answered by the plain version. On the CPU the product is the plain
int32 matmul (`int8_dense_reference`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def _quantize(t: torch.Tensor, dim: int):
    """(int8 values, f32 scales) with scales max(amax |t|, 1e-8) / 127 along
    `dim`, kept as a size-1 axis."""
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=dim, keepdim=True), min=1e-8) / 127.0
    q = torch.round(t32 / scale).clamp(-128, 127).to(torch.int8)
    return q, scale


def _epilogue(acc: torch.Tensor, xscale, wscale, bias, dtype) -> torch.Tensor:
    return (acc.float() * xscale * wscale + bias.float()).to(dtype)


def _padded_int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) @ wq (N, K)^T in int32 through torch._int_mm, with M padded
    to INT_MM_MIN_ROWS and K, N to multiples of INT_MM_MULTIPLE."""
    M, K = xq.shape
    N = wq.shape[0]
    k_pad = -K % INT_MM_MULTIPLE
    n_pad = -N % INT_MM_MULTIPLE
    m_pad = max(INT_MM_MIN_ROWS - M, 0)
    a = F.pad(xq, (0, k_pad, 0, m_pad)) if (k_pad or m_pad) else xq
    b = F.pad(wq, (0, k_pad, 0, n_pad)) if (k_pad or n_pad) else wq
    try:
        acc = torch._int_mm(a.contiguous(), b.contiguous().t())
    except RuntimeError as e:
        raise RuntimeError(
            f"int8_dense: torch._int_mm refused ({M}, {K}) x ({K}, {N}) padded to "
            f"{tuple(a.shape)} x {tuple(b.t().shape)}: {e}") from e
    return acc[:M, :N]


def int8_dense_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version on any device: the int32 sums computed exactly as
    f64 matrix products (every sum of int8 products below 2**31 is exact in
    f64; torch has no integer matmul on CUDA), then the same epilogue."""
    K = x.shape[-1]
    xq, xscale = _quantize(x.reshape(-1, K), -1)
    wq, wscale = _quantize(weight, 1)
    acc = (xq.double() @ wq.double().t()).to(torch.int32)
    out = _epilogue(acc, xscale, wscale.t(), bias, x.dtype)
    return out.reshape(*x.shape[:-1], weight.shape[0])


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x: (..., K) float; weight: (N, K); bias: (N,). Returns (..., N) in
    x's dtype: torch._int_mm on CUDA, the plain int32 product on the CPU."""
    K = x.shape[-1]
    xq, xscale = _quantize(x.reshape(-1, K), -1)
    wq, wscale = _quantize(weight, 1)
    if x.device.type == "cuda":
        acc = _padded_int_mm(xq, wq)
    elif x.device.type == "cpu":
        acc = xq.to(torch.int32) @ wq.to(torch.int32).t()
    else:
        raise ValueError(f"int8_dense: no path for device {x.device}")
    out = _epilogue(acc, xscale, wscale.t(), bias, x.dtype)
    return out.reshape(*x.shape[:-1], weight.shape[0])
