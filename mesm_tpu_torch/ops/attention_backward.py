"""The backward of the trainable attention in float32: dq, dk, dv of
models/attention.attention_core with a key mask and no pair factors.

`attention_backward` launches the CUDA kernels of
kernels/csrc/attention_backward.cu on CUDA tensors (the backward of
mesm_tpu/ops/attention_pallas.py::fused_attention_trainable, `_fat_bwd`
:599-614, which is the VJP of the plain core) and runs
`attention_backward_reference`, its plain torch version, on CPU tensors.
ops/attention_trainable.py calls it from the Function's backward.

Both compute, per (sample b, head h), with qs = q_h * scale and dO the
output's gradient:

    S = qs . k_h^T, masked keys -> -1e9;  P = softmax(S)
    dV = P^T dO;  dP = dO v_h^T;  dS = P o (dP - D), 0 at masked keys
    dQ = (dS k_h) * scale;  dK = dS^T qs

with D_i = sum_j P_ij dP_ij = sum_d dO_id O_id. The plain version
materialises P and takes D from it, through softmax's own backward, in the
order of autograd's ops on attention_core: on the CPU its gradients are
those of torch.autograd.grad through attention_core, bit for bit. The
kernels never store P; they take D from the forward's output O, and take
each product on the tensor cores in 3xTF32 (each operand split into two
TF32 parts, three TF32 products a step: about 21 bits of each operand) and
in another order, within 1e-5 of the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import refuse_autograd
from .attention_packed import NEG_INF, check_operands, kernel_head_dim, mask_u8, pad_heads, unpad_heads

# launches of the backward kernels since import (or since the caller last
# set it to 0): one per call, which runs the dq kernel and then the dk / dv
# kernel
backward_launches = 0


def attention_backward_reference(q, k, v, grad_out, num_heads: int,
                                 key_valid_mask: Optional[torch.Tensor] = None,
                                 head_dim: Optional[int] = None):
    """Plain torch version. q (B, Lq, E), k, v (B, Lk, E), grad_out (B, Lq,
    E), key_valid_mask (B, Lk) True = attendable (or None) -> (dq, dk, dv).
    head_dim: the head_dim whose scale head_dim**-0.5 the logits take (E //
    num_heads when None; see attention_packed.pad_heads)."""
    B, Lq, E = q.shape
    H = num_heads
    hd = E // H
    scale = torch.tensor((head_dim or hd)**-0.5, dtype=q.dtype)  # as attention_core's
    qh, kh, vh, gh = (t.reshape(B, -1, H, hd).transpose(1, 2) for t in (q, k, v, grad_out))
    qs = qh * scale
    logits = torch.matmul(qs, kh.transpose(-1, -2))  # (B, H, Lq, Lk)
    keep = None
    if key_valid_mask is not None:
        keep = key_valid_mask[:, None, None, :].bool()
        logits = torch.where(keep, logits, torch.tensor(NEG_INF, dtype=logits.dtype,
                                                        device=q.device))
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = torch._softmax_backward_data(dp, p, -1, p.dtype)  # P o (dP - sum_j P dP)
    if keep is not None:
        ds = torch.where(keep, ds, torch.zeros((), dtype=ds.dtype, device=q.device))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(qs.transpose(-1, -2), ds).transpose(-1, -2)
    return tuple(t.transpose(1, 2).reshape(B, -1, E) for t in (dq, dk, dv))


def attention_backward(q, k, v, out, grad_out, num_heads: int,
                       key_valid_mask: Optional[torch.Tensor] = None):
    """dq, dk, dv of attention_core at (q, k, v) for the output gradient
    grad_out, given the forward's output `out`. CPU tensors take the plain
    version (which does not read `out`); CUDA tensors launch the kernels
    (float32, contiguous, 16-byte aligned, any head_dim, Ev == E) or
    raise. Raises for an input that requires grad in grad mode (no graph:
    no double backward)."""
    global backward_launches
    refuse_autograd("attention_backward", q, k, v, out, grad_out)
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, grad_out, num_heads, key_valid_mask)
    B, Lq, Lk, _, hd = check_operands("attention_backward", q, k, v, num_heads, key_valid_mask,
                                      (torch.float32,), aligned=True)
    for t in (out, grad_out):
        if (t.dtype != torch.float32 or t.shape != q.shape or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("attention_backward: out and grad_out must be contiguous float32 "
                             f"{tuple(q.shape)} on q's device, on a 16-byte boundary")
    # a head_dim without an instance runs on the next one, zero-padded: the
    # padded columns of dq, dk and dv come out 0 and are dropped
    hdp = kernel_head_dim(hd)
    q, k, v, out, grad_out = (pad_heads(t, num_heads, hdp) for t in (q, k, v, out, grad_out))
    E = num_heads * hdp
    from ..kernels.build import load

    lib = load("attention_backward")
    mask = mask_u8(key_valid_mask, B, Lk, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # each query row's softmax max, 1 / sum and D, from the dq kernel to the
    # dk / dv kernel
    stats = torch.empty(B, num_heads, Lq, 3, dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(hd**-0.5, dtype=torch.float32))  # attention_core's f32 scale
    fn = lib.attention_backward_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(*(t.data_ptr() for t in (q, k, v, out, grad_out, mask, dq, dk, dv, stats)),
             B, num_heads, Lq, Lk, E, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_backward kernel launch failed: cudaError {err}")
    backward_launches += 1
    return tuple(unpad_heads(t, num_heads, hd) for t in (dq, dk, dv))
