"""Multi-head attention in the per-head and all-heads layouts, which the
attention dispatch takes under MESM_ATTN_VARIANT=per_head / all_heads.

`attention_per_head` and `attention_all_heads` launch the CUDA kernels of
kernels/csrc/attention_heads.cu (the ports of
mesm_tpu/ops/attention_pallas.py::_mha_kernel and _mha_kernel_allheads) on
CUDA tensors: bf16 on tensor-core mma tiles, float32 on the batched
kernel's 3xTF32 tensor-core body, one block per (sample, head, 64 query
rows; and 128 output columns at a head_dim above 128). On
the GPU one grid serves both layouts, so both launch the same kernels and
count their launches apart. The two TPU kernels compute one function, that
of the batched kernel, so their plain version is ops/attention_batched
.attention_batched_reference, which both run on CPU tensors: q * scale in
the input dtype, f32 logits, a finite -1e9 on masked keys, an f32 softmax,
the probabilities rounded to v's dtype, P.V with f32 sums.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import refuse_autograd
from .attention_batched import attention_batched_reference
from .attention_packed import check_operands, fitted_head_dim, mask_u8, pad_heads, unpad_heads

# kernel launches since import (or since the caller last set them to 0)
per_head_launches = 0
all_heads_launches = 0


def _launch(name: str, q, k, v, num_heads: int, key_valid_mask):
    """Checks the operands and launches kernels/csrc/attention_heads.cu;
    returns out."""
    B, Lq, Lk, _, hd = check_operands(name, q, k, v, num_heads, key_valid_mask,
                                      (torch.bfloat16, torch.float32), aligned=True)
    from ..kernels.build import load

    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = load("attention_heads")
    smem_bytes = lib.attention_heads_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int] * 3
    hdp = fitted_head_dim(name, smem_bytes, is_bf16, hd, Lk)
    q, k, v = (pad_heads(t, num_heads, hdp) for t in (q, k, v))
    E = num_heads * hdp
    mask = mask_u8(key_valid_mask, B, Lk, q.device)
    out = torch.empty(B, Lq, E, dtype=q.dtype, device=q.device)
    scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))  # q * scale is a product in q's dtype
    fn = lib.attention_heads_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             B, num_heads, Lq, Lk, E, is_bf16, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return unpad_heads(out, num_heads, hd)


def attention_per_head(q, k, v, num_heads: int, key_valid_mask=None):
    """The per-head layout (MESM_ATTN_VARIANT=per_head). CPU tensors take
    the plain version; CUDA tensors launch the kernel (bf16 or float32,
    any head_dim, Ev == E) or raise. Raises for an input that requires
    grad in grad mode (no graph)."""
    global per_head_launches
    refuse_autograd("attention_per_head", q, k, v)
    if q.device.type == "cpu":
        return attention_batched_reference(q, k, v, num_heads, key_valid_mask)
    out = _launch("attention_per_head", q, k, v, num_heads, key_valid_mask)
    per_head_launches += 1
    return out


def attention_all_heads(q, k, v, num_heads: int, key_valid_mask=None):
    """The all-heads layout (MESM_ATTN_VARIANT=all_heads). CPU tensors take
    the plain version; CUDA tensors launch the kernel (bf16 or float32,
    any head_dim, Ev == E) or raise. Raises for an input that requires
    grad in grad mode (no graph)."""
    global all_heads_launches
    refuse_autograd("attention_all_heads", q, k, v)
    if q.device.type == "cpu":
        return attention_batched_reference(q, k, v, num_heads, key_valid_mask)
    out = _launch("attention_all_heads", q, k, v, num_heads, key_valid_mask)
    all_heads_launches += 1
    return out
