"""fp32 multi-head attention over (B, L, E) operands, heads split inside the
kernel: the long-sequence fp32 tier (TACoS, L = 601).

`attention_batched` launches the CUDA kernel kernels/csrc/attention_batched.cu
(the port of mesm_tpu/ops/attention_pallas.py::_mha_kernel_batched) on CUDA
tensors and runs `attention_batched_reference`, its plain torch version, on
CPU tensors. Both compute the TPU kernel's function: q * scale in the input
dtype, f32 logits, a finite -1e9 on masked keys, a max-subtracted softmax in
f32, and P.V with f32 sums. In fp32 that is models/attention.attention_core's
arithmetic too. A fully masked row averages v uniformly.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import refuse_autograd

NEG_INF = -1e9
MAX_SMEM = 232448  # bytes a block may use on sm_90

# kernel launches since import (or since the caller last set it to 0)
launches = 0


def attention_batched_reference(q, k, v, num_heads: int, key_valid_mask: Optional[torch.Tensor] = None):
    """Plain torch version. q (B, Lq, E), k (B, Lk, E), v (B, Lk, Ev),
    key_valid_mask (B, Lk) bool with True = attendable -> (B, Lq, Ev)."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    qh = q.reshape(B, Lq, H, hd).transpose(1, 2)
    kh = k.reshape(B, Lk, H, hd).transpose(1, 2)
    vh = v.reshape(B, Lk, H, hdv).transpose(1, 2)
    qs = qh * torch.tensor(hd**-0.5, dtype=q.dtype)  # product in the input dtype
    logits = torch.matmul(qs.float(), kh.float().transpose(-1, -2))
    if key_valid_mask is not None:
        logits = torch.where(
            key_valid_mask[:, None, None, :].bool(), logits,
            torch.tensor(NEG_INF, dtype=logits.dtype, device=q.device),
        )
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(p.float(), vh.float())
    return out.transpose(1, 2).reshape(B, Lq, Ev).to(v.dtype)


def attention_batched(q, k, v, num_heads: int, key_valid_mask: Optional[torch.Tensor] = None):
    """Multi-head attention over (B, L, E) operands with the batched
    kernel's numerics. CPU tensors take the plain version; CUDA tensors
    launch the kernel (float32, head_dim 32 or 64, Ev == E) or raise.
    Raises for an input that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("attention_batched", q, k, v)
    if q.device.type == "cpu":
        return attention_batched_reference(q, k, v, num_heads, key_valid_mask)
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise TypeError(f"attention_batched: the kernel takes float32, got {t.dtype}")
        if t.ndim != 3 or t.device != q.device or not t.is_contiguous():
            raise ValueError("attention_batched: q, k, v must be contiguous (B, L, E) on one device")
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    if k.shape != (B, Lk, E) or v.shape != (B, Lk, Ev) or Ev != E or E % num_heads:
        raise ValueError(
            f"attention_batched: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} with {num_heads} heads"
        )
    hd = E // num_heads
    if hd not in (32, 64):
        raise ValueError(f"attention_batched: the kernel takes head_dim 32 or 64, got {hd}")
    if key_valid_mask is not None and key_valid_mask.shape != (B, Lk):
        raise ValueError(f"attention_batched: mask {tuple(key_valid_mask.shape)} != {(B, Lk)}")
    if q.device.type != "cuda":
        raise ValueError(f"attention_batched: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention_batched: q, k, v must start on a 16-byte boundary")
    from ..kernels.build import load

    lib = load("attention_batched")
    smem_bytes = lib.attention_batched_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    need = smem_bytes(hd, Lk)
    if need > MAX_SMEM:
        raise ValueError(f"attention_batched: {Lk} keys need {need} bytes of shared memory")
    if key_valid_mask is None:
        mask = torch.ones(B, Lk, dtype=torch.uint8, device=q.device)
    else:
        mask = key_valid_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    out = torch.empty(B, Lq, Ev, dtype=v.dtype, device=q.device)
    scale = float(torch.tensor(hd**-0.5, dtype=torch.float32))
    fn = lib.attention_batched_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, num_heads, Lq, Lk, E, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_batched kernel launch failed: cudaError {err}")
    launches += 1
    return out
