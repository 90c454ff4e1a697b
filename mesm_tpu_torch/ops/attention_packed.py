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

Both kernels take bf16 (the default packed variant) and float32 (what
MESM_ATTN_VARIANT=packed sends an fp32 model to). The packed kernel runs
bf16 on tensor-core mma tiles at the rounding points above and float32 on
the batched kernel's body, its products in 3xTF32 on the tensor cores: in
float32 every rounding point is f32, so the function is
attention_batched_reference's.

`attention_packed_pair` launches the same source's pair-masked entry point
(the port of `_mha_kernel_packed_pair`, attention_pallas.py:170-210) and
`attention_packed_pair_reference` is its plain version. It is not the
kernel above with a mask added: q is scaled in f32, the logits stay f32, the
softmax runs in f32, and only the probabilities are rounded to bf16 before
the f32-accumulated product with v. A pair (q, k) of head (b, h) is masked
where both pair factors, (B, H, Lq) and (B, H, Lk), flag it. bf16 operands
run on the tensor-core mma body (its pair chain), float32 on the packed
kernel's 3xTF32 body with the pair flags (in float32 the pair chain is the
batched function with the pair mask): a route by dtype, chosen before the
launch. Both take operands on 16-byte boundaries.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ATTN_HEAD_DIMS, ATTN_WIDE_STEP, refuse_autograd

NEG_INF = -1e9
MAX_SMEM = 232448  # bytes a block may use on sm_90

# kernel launches since import (or since the caller last set it to 0): of
# the packed kernel, and of its pair-masked entry point
launches = 0
pair_launches = 0


def attention_packed_reference(q, k, v, num_heads: int, key_valid_mask: Optional[torch.Tensor] = None,
                               head_dim: Optional[int] = None):
    """Plain torch version. q (B, Lq, E), k (B, Lk, E), v (B, Lk, Ev),
    key_valid_mask (B, Lk) bool with True = attendable -> (B, Lq, Ev).
    head_dim: the head_dim whose scale head_dim**-0.5 the logits take
    (E // num_heads when None: another is what a kernel run on zero-padded
    heads takes, see pad_heads)."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    dt = q.dtype
    qh = q.reshape(B, Lq, H, hd).transpose(1, 2)
    kh = k.reshape(B, Lk, H, hd).transpose(1, 2)
    vh = v.reshape(B, Lk, H, hdv).transpose(1, 2)
    qs = qh * torch.tensor((head_dim or hd)**-0.5, dtype=dt)  # product rounded to the input dtype
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
    kernel (bf16 or float32, any head_dim, Ev == E) or raise. Raises for an
    input that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("attention_packed", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, key_valid_mask)
    out = _launch("attention_packed", q, k, v, num_heads, key_valid_mask, None)
    launches += 1
    return out


def attention_packed_pair_reference(q, k, v, num_heads: int, key_valid_mask=None,
                                    pair_factors=None, head_dim: Optional[int] = None):
    """Plain torch version of the pair-masked kernel. q (B, Lq, E), k (B, Lk,
    E), v (B, Lk, Ev), key_valid_mask (B, Lk) True = attendable (or None),
    pair_factors ((B, H, Lq), (B, H, Lk)) bool (or None: no pair mask) ->
    (B, Lq, Ev) in v's dtype. head_dim: as attention_packed_reference's."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    qh = q.reshape(B, Lq, H, hd).transpose(1, 2).float() * ((head_dim or hd)**-0.5)
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


def kernel_head_dim(hd: int) -> int:
    """The head_dim of the kernel instance a head_dim runs on: the smallest
    of kernels.ATTN_HEAD_DIMS (16, 32, 64, 128) that holds it; above 128 the
    next multiple of ATTN_WIDE_STEP (128), which the wide bodies take in
    128-column slices."""
    for d in ATTN_HEAD_DIMS:
        if hd <= d:
            return d
    return -(-hd // ATTN_WIDE_STEP) * ATTN_WIDE_STEP


def fitted_head_dim(name: str, smem_bytes, is_bf16: int, hd: int, Lk: int) -> int:
    """The head_dim of the instance a wrapper launches for head_dim hd and Lk
    keys: kernel_head_dim(hd), or 128 where that instance's block needs more
    than MAX_SMEM (the bf16 mma body stages K_h and V_h whole; at 128 a head
    beyond that staging takes the wide body, any Lk). smem_bytes is the
    source's (is_bf16, head_dim, Lk) -> bytes. Raises where none fits."""
    hdp = kernel_head_dim(hd)
    if hdp < ATTN_HEAD_DIMS[-1] and smem_bytes(is_bf16, hdp, Lk) > MAX_SMEM:
        hdp = ATTN_HEAD_DIMS[-1]
    need = smem_bytes(is_bf16, hdp, Lk)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: {Lk} keys at head_dim {hdp} need {need} bytes of shared memory")
    return hdp


def pad_heads(t, num_heads: int, hdp: int):
    """(B, L, H * hd) -> (B, L, H * hdp): each head's columns followed by
    hdp - hd zero columns; t itself when hd == hdp. Zero columns add exact
    zeros to the f32 sums of q . k and give zero columns of p . v, so a
    kernel at head_dim hdp, given the real head_dim's scale, computes the
    unpadded function."""
    B, L, E = t.shape
    hd = E // num_heads
    if hd == hdp:
        return t
    return F.pad(t.reshape(B, L, num_heads, hd), (0, hdp - hd)).reshape(B, L, num_heads * hdp)


def unpad_heads(t, num_heads: int, hd: int):
    """The inverse of pad_heads: the first hd columns of each head, as a
    contiguous (B, L, H * hd); t itself when it has no padding."""
    B, L, Ep = t.shape
    hdp = Ep // num_heads
    if hd == hdp:
        return t
    return t.reshape(B, L, num_heads, hdp)[..., :hd].reshape(B, L, num_heads * hd)


def check_operands(name: str, q, k, v, num_heads: int, key_valid_mask,
                   dtypes=(torch.bfloat16,), aligned: bool = False):
    """The checks every (B, L, E) attention wrapper makes before it
    launches: one dtype of `dtypes`, contiguous, on one CUDA device, Ev == E
    (any head_dim: one without an instance is padded by the wrapper,
    `kernel_head_dim`, `pad_heads`), a (B, Lk) mask, and with `aligned` q, k,
    v on 16-byte boundaries (for cp.async and 16-byte loads). Returns (B, Lq,
    Lk, E, head_dim)."""
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
    if key_valid_mask is not None and key_valid_mask.shape != (B, Lk):
        raise ValueError(f"{name}: mask {tuple(key_valid_mask.shape)} != {(B, Lk)}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if aligned and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start on a 16-byte boundary")
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
    """Checks the operands (16-byte aligned: both entry points copy them 16
    bytes at a time) and launches kernels/csrc/attention_packed.cu: its
    pair-masked entry point when pair_factors is given, else the packed one.
    Returns out."""
    pair = pair_factors is not None
    B, Lq, Lk, _, hd = check_operands(name, q, k, v, num_heads, key_valid_mask,
                                      (torch.bfloat16, torch.float32), aligned=True)
    from ..kernels.build import load

    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = load("attention_packed")
    smem_bytes = lib.attention_packed_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int] * 3
    hdp = fitted_head_dim(name, smem_bytes, is_bf16, hd, Lk)
    q, k, v = (pad_heads(t, num_heads, hdp) for t in (q, k, v))
    E = num_heads * hdp
    mask = mask_u8(key_valid_mask, B, Lk, q.device)
    out = torch.empty(B, Lq, E, dtype=v.dtype, device=q.device)
    if not pair:
        fn = lib.attention_packed_launch
        operands = (q, k, v, mask, out)
        scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))  # q * scale is a product in q's dtype
    else:
        fn = lib.attention_packed_pair_launch
        operands = (q, k, v, mask, *factors_u8(pair_factors, B, num_heads, Lq, Lk, q.device), out)
        scale = hd**-0.5  # an f32 product
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(operands) + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    err = fn(*(t.data_ptr() for t in operands), B, num_heads, Lq, Lk, E, E, is_bf16,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return unpad_heads(out, num_heads, hd)


def attention_packed_pair(q, k, v, num_heads: int, key_valid_mask, pair_factors):
    """Multi-head attention over (B, L, E) operands under the factored pair
    mask, with the pair kernel's numerics (f32 softmax, probabilities rounded
    to the operand dtype). CPU tensors take the plain version; CUDA tensors
    launch a kernel (bf16 on the mma body or float32 on the 3xTF32 body, on
    16-byte boundaries; any head_dim, Ev == E) or raise. Raises for an input that
    requires grad in grad mode (no graph)."""
    global pair_launches
    refuse_autograd("attention_packed_pair", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_pair_reference(q, k, v, num_heads, key_valid_mask, pair_factors)
    out = _launch("attention_packed_pair", q, k, v, num_heads, key_valid_mask, pair_factors)
    pair_launches += 1
    return out
