"""Fused LayerNorm -> Dense (-> ReLU): the wide input projection.

`ln_dense` launches the CUDA kernels of kernels/csrc/ln_dense.cu (the port
of mesm_tpu/ops/layer_pallas.py::fused_ln_dense) on CUDA tensors and runs
`ln_dense_reference`, its plain torch version, on CPU tensors. The two
compute the same function at the same rounding points: f32 statistics with
var = E[x^2] - mean^2 unclamped, the normalised rows rounded to the input
dtype, a Dense with f32 accumulation and an f32 bias, an optional ReLU, the
result in the input dtype. The kernel takes any D and any F: bf16 products
on wgmma, float32 products in 3xTF32 on wgmma (three TF32 products of
split operands, partial sums added in f32 a K tile at a time).

The kernel reads the Dense weight through TMA tensor maps, as a copy in
the input dtype with its rows padded to a 16-byte stride (in float32 split
into its tf32 hi and lo parts: each value split once per weight version).
`kernel_weights` makes those copies once per version of the weight and
dtype and keeps them while the weight lives (ops/_weight_cache.py, as
ops/ffn_int8.quantized_weights): an in-place update or a freed weight drops
them. So a launch allocates only its output and the rows' statistics (8
bytes a row) that the kernel's two passes share.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..kernels import refuse_autograd
from ._weight_cache import Entry, derived

LN_EPS = 1e-5

# kernel launches since import (or since the caller last set it to 0), and
# the padded (and split) weight copies made
launches = 0
weight_copies = 0


def ln_dense_reference(x, ln_weight, ln_bias, weight, bias, relu: bool, eps: float = LN_EPS):
    """Plain torch version. x: (..., D); ln_weight, ln_bias: (D,);
    weight: (F, D) in torch Linear layout; bias: (F,)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * ln_weight.float() + ln_bias.float()
    w = weight.to(x.dtype).float()
    out = torch.matmul(y.to(x.dtype).float(), w.t()) + bias.float()
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x.dtype)


def tf32_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 w as (hi, lo): hi = tf32(w) rounded to nearest with ties away
    from zero (cvt.rna.tf32.f32: half a tf32 ulp added to the magnitude, the
    13 low bits cleared), lo = tf32(w - hi); hi + lo keeps about 21 bits.
    The kernel splits the normalised rows the same way."""
    def rna(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w)
    return hi, rna(w - hi)


def padded_width(D: int, dtype) -> int:
    """The row stride (elements) of the cached weight: D rounded up to 16
    bytes, as a TMA tensor map's strides must be."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-D // per) * per


# id(weight) -> _weight_cache.Entry; an entry goes when its weight is freed
_weight_cache: Dict[int, Entry] = {}


def kernel_weights(weight: torch.Tensor, dtype) -> Tuple[torch.Tensor, ...]:
    """The weight (F, D) as the kernel reads it: (wp,) in bf16, (hi, lo) in
    float32 (tf32_split), each (F, padded_width(D)) with zero columns past
    D, contiguous and on their own memory; made at the first call of each
    version of the weight and dtype, then reused."""
    global weight_copies
    copies = derived(_weight_cache, (weight,))
    if dtype not in copies:
        F, D = weight.shape
        with torch.no_grad():
            wp = torch.zeros(F, padded_width(D, dtype), dtype=dtype, device=weight.device)
            wp[:, :D] = weight.detach()
            copies[dtype] = (wp,) if dtype == torch.bfloat16 else tf32_split(wp)
        weight_copies += 1
    return copies[dtype]


def ln_dense(x, ln_weight, ln_bias, weight, bias, relu: bool, eps: float = LN_EPS):
    """LayerNorm over the last axis of x, then Dense (weight (F, D), torch
    layout), optional ReLU. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 or float32, any D and F) or raise. Raises for an
    input that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("ln_dense", x, ln_weight, ln_bias, weight, bias)
    if x.device.type == "cpu":
        return ln_dense_reference(x, ln_weight, ln_bias, weight, bias, relu, eps)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_dense: the kernel takes float32 or bfloat16, got {x.dtype}")
    D = x.shape[-1]
    F = weight.shape[0]
    if weight.shape != (F, D) or ln_weight.shape != (D,) or ln_bias.shape != (D,) or bias.shape != (F,):
        raise ValueError(
            f"ln_dense: shapes x {tuple(x.shape)}, ln {tuple(ln_weight.shape)}/"
            f"{tuple(ln_bias.shape)}, weight {tuple(weight.shape)}, bias {tuple(bias.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("ln_dense: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"ln_dense: unsupported device {x.device}")
    for t in (ln_weight, ln_bias, weight, bias):
        if t.device != x.device:
            raise ValueError("ln_dense: all operands must be on the same device")
    N = x.numel() // D
    if N == 0 or D == 0:
        return torch.empty(*x.shape[:-1], F, dtype=x.dtype, device=x.device)
    ws = kernel_weights(weight, x.dtype)
    # x, and gamma and beta in f32, on 16-byte boundaries (the kernel copies
    # K tiles of them 16 bytes at a time): as they are, or a copy
    x, gamma, beta = (t if t.data_ptr() % 16 == 0 else t.clone() for t in
                      (x, ln_weight.float().contiguous(), ln_bias.float().contiguous()))
    b = bias.float().contiguous()
    out = torch.empty(*x.shape[:-1], F, dtype=x.dtype, device=x.device)
    stats = torch.empty(N, 2, dtype=torch.float32, device=x.device)
    from ..kernels.build import load

    lib = load("ln_dense")
    fn = lib.ln_dense_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ws[0].data_ptr(),
        ws[1].data_ptr() if len(ws) > 1 else None, b.data_ptr(), out.data_ptr(),
        stats.data_ptr(), N, D, ws[0].shape[1], F, int(bool(relu)), float(eps),
        1 if x.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ln_dense kernel launch failed: cudaError {err}")
    launches += 1
    return out
