"""Fused LayerNorm -> Dense (-> ReLU): the wide input projection.

`ln_dense` launches the CUDA kernel kernels/csrc/ln_dense.cu (the port of
mesm_tpu/ops/layer_pallas.py::fused_ln_dense) on CUDA tensors and runs
`ln_dense_reference`, its plain torch version, on CPU tensors. The two
compute the same function at the same rounding points: f32 statistics with
var = E[x^2] - mean^2 unclamped, the normalised rows rounded to the input
dtype, a Dense with f32 accumulation and an f32 bias, an optional ReLU, the
result in the input dtype.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import refuse_autograd

LN_EPS = 1e-5
THREADS = 256
MAX_SMEM = 232448  # bytes a block may use on sm_90

# kernel launches since import (or since the caller last set it to 0)
launches = 0


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


def _geometry(dtype, D: int, F: int):
    """(DP, DS, rows per block, shared bytes) for the kernel, or None when
    no block of rows fits in shared memory."""
    DP = -16 * (-D // 16)
    if dtype == torch.bfloat16:
        DS = DP + 8
        for bm in (32, 16):
            smem = max(bm * DS * 2, bm * F * 4)
            if smem <= MAX_SMEM:
                return DP, DS, bm, smem
    else:
        DS = DP
        for bm in (16, 8):
            smem = bm * DS * 4
            if smem <= MAX_SMEM:
                return DP, DS, bm, smem
    return None


def ln_dense(x, ln_weight, ln_bias, weight, bias, relu: bool, eps: float = LN_EPS):
    """LayerNorm over the last axis of x, then Dense (weight (F, D), torch
    layout), optional ReLU. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. Raises for an input that requires grad in
    grad mode (no graph)."""
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
    if F > THREADS or (x.dtype == torch.bfloat16 and F % 16):
        raise ValueError(f"ln_dense: the kernel takes F <= {THREADS} (a multiple of 16 in bf16), got {F}")
    if not x.is_contiguous():
        raise ValueError("ln_dense: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"ln_dense: unsupported device {x.device}")
    for t in (ln_weight, ln_bias, weight, bias):
        if t.device != x.device:
            raise ValueError("ln_dense: all operands must be on the same device")
    geom = _geometry(x.dtype, D, F)
    if geom is None:
        raise ValueError(f"ln_dense: D = {D} does not fit one block of rows in shared memory")
    DP, DS, bm, smem = geom
    N = x.numel() // D
    out = torch.empty(*x.shape[:-1], F, dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    # the weight in the input dtype, rows padded to DP with zeros: the K
    # tail then adds nothing and every row of it is 16-byte aligned
    wp = torch.zeros(F, DP, dtype=x.dtype, device=x.device)
    wp[:, :D] = weight
    gamma = ln_weight.float().contiguous()
    beta = ln_bias.float().contiguous()
    b = bias.float().contiguous()
    from ..kernels.build import load

    lib = load("ln_dense")
    fn = lib.ln_dense_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wp.data_ptr(), b.data_ptr(),
        out.data_ptr(), N, D, DP, DS, F, int(bool(relu)), float(eps),
        1 if x.dtype == torch.bfloat16 else 0, bm, smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ln_dense kernel launch failed: cudaError {err}")
    launches += 1
    return out
