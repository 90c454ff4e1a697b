"""Multi-head attention over (B, L, E) operands, heads split inside the
kernel: the long-sequence fp32 tier (TACoS, L = 601), and bf16 under
MESM_ATTN_VARIANT=batched.

`attention_batched` launches the CUDA kernel kernels/csrc/attention_batched.cu
(the port of mesm_tpu/ops/attention_pallas.py::_mha_kernel_batched) on CUDA
tensors and runs `attention_batched_reference`, its plain torch version, on
CPU tensors. Both compute the TPU kernel's function: q * scale in the input
dtype, f32 logits, a finite -1e9 on masked keys, a max-subtracted softmax in
f32, the probabilities rounded to v's dtype, and P.V with f32 sums. In fp32
that is models/attention.attention_core's arithmetic too. A fully masked row
averages v uniformly. The same function is that of the per-head and
all-heads kernels (ops/attention_heads.py), whose plain version this is too.
The kernel runs float32 on the tensor cores in 3xTF32 (both products on
split operands, any Lk), and bf16 on tensor-core mma tiles where a head's
K_h and V_h fit a block's shared memory (up to 1,760 keys at head_dim 32,
864 at 64), on the register tiles beyond. A head_dim above 128 runs on the
wide bodies, padded to a multiple of 128, any Lk.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import refuse_autograd
from .attention_packed import (NEG_INF, check_operands, fitted_head_dim, mask_u8, pad_heads,
                               unpad_heads)

# kernel launches since import (or since the caller last set it to 0)
launches = 0


def attention_batched_reference(q, k, v, num_heads: int, key_valid_mask: Optional[torch.Tensor] = None,
                                head_dim: Optional[int] = None):
    """Plain torch version. q (B, Lq, E), k (B, Lk, E), v (B, Lk, Ev),
    key_valid_mask (B, Lk) bool with True = attendable -> (B, Lq, Ev).
    head_dim: as attention_packed_reference's."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    qh = q.reshape(B, Lq, H, hd).transpose(1, 2)
    kh = k.reshape(B, Lk, H, hd).transpose(1, 2)
    vh = v.reshape(B, Lk, H, hdv).transpose(1, 2)
    qs = qh * torch.tensor((head_dim or hd)**-0.5, dtype=q.dtype)  # product in the input dtype
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
    launch the kernel (float32 or bf16, any head_dim, Ev == E) or raise.
    Raises for an input that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("attention_batched", q, k, v)
    if q.device.type == "cpu":
        return attention_batched_reference(q, k, v, num_heads, key_valid_mask)
    B, Lq, Lk, _, hd = check_operands("attention_batched", q, k, v, num_heads, key_valid_mask,
                                      (torch.float32, torch.bfloat16), aligned=True)
    from ..kernels.build import load

    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = load("attention_batched")
    smem_bytes = lib.attention_batched_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int] * 3
    hdp = fitted_head_dim("attention_batched", smem_bytes, is_bf16, hd, Lk)
    q, k, v = (pad_heads(t, num_heads, hdp) for t in (q, k, v))
    E = num_heads * hdp
    mask = mask_u8(key_valid_mask, B, Lk, q.device)
    out = torch.empty(B, Lq, E, dtype=v.dtype, device=q.device)
    scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))  # q * scale is a product in q's dtype
    fn = lib.attention_batched_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, num_heads, Lq, Lk, E, is_bf16, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_batched kernel launch failed: cudaError {err}")
    launches += 1
    return unpad_heads(out, num_heads, hd)
