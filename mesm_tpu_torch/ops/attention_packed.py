"""Packed multi-head attention: heads split inside the kernel, (B, L, E) in
and out, with and without the factored pair mask.

`attention_packed` launches the CUDA kernel kernels/csrc/attention_packed.cu
(the port of mesm_tpu/ops/attention_pallas.py::_mha_kernel_packed with
_softmax_lastdim) on CUDA tensors and runs `attention_packed_reference`, its
plain torch version, on CPU tensors. Both follow the KERNEL's numerics, which
differ from models/attention.attention_core in bf16: the logits are rounded
to the input dtype, the max-subtracted exp and the divide run in that dtype,
and only the denominator is summed in f32 (attention_core upcasts the whole
softmax to f32). In fp32 every rounding is to f32 and the two agree.

`attention_packed_pair` launches the same source's pair-masked entry point
(the port of `_mha_kernel_packed_pair`, attention_pallas.py:170-210) and
`attention_packed_pair_reference` is its plain version. It is not the
kernel above with a mask added: q is scaled in f32, the logits stay f32, the
softmax runs in f32, and only the probabilities are rounded to bf16 before
the f32-accumulated product with v. A pair (q, k) of head (b, h) is masked
where both pair factors, (B, H, Lq) and (B, H, Lk), flag it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import refuse_autograd

NEG_INF = -1e9
MAX_SMEM = 232448  # bytes a block may use on sm_90

# kernel launches since import (or since the caller last set it to 0): of
# the packed kernel, and of its pair-masked entry point
launches = 0
pair_launches = 0


def attention_packed_reference(q, k, v, num_heads: int, key_valid_mask: Optional[torch.Tensor] = None):
    """Plain torch version. q (B, Lq, E), k (B, Lk, E), v (B, Lk, Ev),
    key_valid_mask (B, Lk) bool with True = attendable -> (B, Lq, Ev)."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    dt = q.dtype
    qh = q.reshape(B, Lq, H, hd).transpose(1, 2)
    kh = k.reshape(B, Lk, H, hd).transpose(1, 2)
    vh = v.reshape(B, Lk, H, hdv).transpose(1, 2)
    qs = qh * torch.tensor(hd**-0.5, dtype=dt)  # product rounded to the input dtype
    logits = torch.matmul(qs.float(), kh.float().transpose(-1, -2)).to(dt)
    if key_valid_mask is not None:
        logits = torch.where(
            key_valid_mask[:, None, None, :].bool(), logits,
            torch.tensor(NEG_INF, dtype=dt, device=q.device),
        )
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.float().sum(-1, keepdim=True)
    p = (e / s.to(dt)).to(v.dtype)
    out = torch.matmul(p.float(), vh.float())
    return out.transpose(1, 2).reshape(B, Lq, Ev).to(v.dtype)


def attention_packed(q, k, v, num_heads: int, key_valid_mask: Optional[torch.Tensor] = None):
    """Multi-head attention over (B, L, E) operands with the packed kernel's
    numerics. CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16, head_dim 32 or 64, Ev == E) or raise. Raises for an input
    that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("attention_packed", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, key_valid_mask)
    out = _launch("attention_packed", q, k, v, num_heads, key_valid_mask, None)
    launches += 1
    return out


def attention_packed_pair_reference(q, k, v, num_heads: int, key_valid_mask=None,
                                    pair_factors=None):
    """Plain torch version of the pair-masked kernel. q (B, Lq, E), k (B, Lk,
    E), v (B, Lk, Ev), key_valid_mask (B, Lk) True = attendable (or None),
    pair_factors ((B, H, Lq), (B, H, Lk)) bool (or None: no pair mask) ->
    (B, Lq, Ev) in v's dtype."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    qh = q.reshape(B, Lq, H, hd).transpose(1, 2).float() * (hd**-0.5)
    kh = k.reshape(B, Lk, H, hd).transpose(1, 2).float()
    vh = v.reshape(B, Lk, H, hdv).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # (B, H, Lq, Lk) f32
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    if pair_factors is not None:
        qf, kf = pair_factors
        logits = torch.where(qf.bool()[..., :, None] & kf.bool()[..., None, :], neg, logits)
    if key_valid_mask is not None:
        logits = torch.where(key_valid_mask[:, None, None, :].bool(), logits, neg)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(p.float(), vh.float())
    return out.transpose(1, 2).reshape(B, Lq, Ev).to(v.dtype)


def check_operands(name: str, q, k, v, num_heads: int, key_valid_mask,
                   dtypes=(torch.bfloat16,), head_dims=(32, 64)):
    """The checks every (B, L, E) attention wrapper makes before it
    launches: one dtype of `dtypes`, contiguous, on one CUDA device, Ev == E,
    a head_dim of `head_dims`, a (B, Lk) mask. Returns (B, Lq, Lk, E,
    head_dim)."""
    for t in (q, k, v):
        if t.dtype not in dtypes or t.dtype != q.dtype:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: the kernel takes {names} operands, got {t.dtype}")
        if t.ndim != 3 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: q, k, v must be contiguous (B, L, E) on one device")
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    if k.shape != (B, Lk, E) or v.shape != (B, Lk, Ev) or Ev != E or E % num_heads:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} with {num_heads} heads"
        )
    hd = E // num_heads
    if hd not in head_dims:
        raise ValueError(
            f"{name}: the kernel takes head_dim {' or '.join(map(str, head_dims))}, got {hd}"
        )
    if key_valid_mask is not None and key_valid_mask.shape != (B, Lk):
        raise ValueError(f"{name}: mask {tuple(key_valid_mask.shape)} != {(B, Lk)}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return B, Lq, Lk, E, hd


def _as_u8(t, device):
    """A 0/1 tensor as contiguous uint8 on `device`: a bool tensor is viewed
    as its bytes (0 or 1), with no copy when it is contiguous already."""
    t = t.to(device=device).contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t.to(torch.uint8)


def mask_u8(key_valid_mask, B: int, Lk: int, device):
    """The (B, Lk) key mask as contiguous uint8 (all ones when None)."""
    if key_valid_mask is None:
        return torch.ones(B, Lk, dtype=torch.uint8, device=device)
    return _as_u8(key_valid_mask, device)


def factors_u8(pair_factors, B: int, H: int, Lq: int, Lk: int, device):
    """The (B, H, Lq) and (B, H, Lk) pair factors as contiguous uint8."""
    qf, kf = pair_factors
    if qf.shape != (B, H, Lq) or kf.shape != (B, H, Lk):
        raise ValueError(
            f"pair factors {tuple(qf.shape)}, {tuple(kf.shape)} != {(B, H, Lq)}, {(B, H, Lk)}"
        )
    return _as_u8(qf, device), _as_u8(kf, device)


def _launch(name: str, q, k, v, num_heads: int, key_valid_mask, pair_factors):
    """Checks the operands and launches kernels/csrc/attention_packed.cu: its
    pair-masked entry point when pair_factors is given, else the packed
    one. Returns out."""
    B, Lq, Lk, E, hd = check_operands(name, q, k, v, num_heads, key_valid_mask)
    from ..kernels.build import load

    lib = load("attention_packed")
    smem_bytes = lib.attention_packed_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    need = smem_bytes(hd, Lk)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: {Lk} keys need {need} bytes of shared memory")
    mask = mask_u8(key_valid_mask, B, Lk, q.device)
    out = torch.empty(B, Lq, E, dtype=v.dtype, device=q.device)
    if pair_factors is None:
        fn = lib.attention_packed_launch
        operands = (q, k, v, mask, out)
        scale = float(torch.tensor(hd**-0.5, dtype=torch.bfloat16))  # q * scale is a bf16 product
    else:
        fn = lib.attention_packed_pair_launch
        operands = (q, k, v, mask, *factors_u8(pair_factors, B, num_heads, Lq, Lk, q.device), out)
        scale = hd**-0.5  # an f32 product
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(operands) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    err = fn(*(t.data_ptr() for t in operands), B, num_heads, Lq, Lk, E, E, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def attention_packed_pair(q, k, v, num_heads: int, key_valid_mask, pair_factors):
    """Multi-head attention over (B, L, E) operands under the factored pair
    mask, with the pair kernel's numerics (f32 softmax, bf16 probabilities).
    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16,
    head_dim 32 or 64, Ev == E) or raise. Raises for an input that requires
    grad in grad mode (no graph)."""
    global pair_launches
    refuse_autograd("attention_packed_pair", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_pair_reference(q, k, v, num_heads, key_valid_mask, pair_factors)
    out = _launch("attention_packed_pair", q, k, v, num_heads, key_valid_mask, pair_factors)
    pair_launches += 1
    return out
