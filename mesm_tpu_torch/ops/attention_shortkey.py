"""Short-key multi-head attention: long video queries against a short text
key sequence, (B, L, E) in and out, the factored pair mask optional.

Two kernels of mesm_tpu/ops/attention_pallas.py, both in the CUDA source
kernels/csrc/attention_shortkey.cu:

- `attention_shortkey` is the packed family's short-key kernel
  (`_mha_kernel_packed_shortkey`, `_shortkey_nopair`, :213-259), which the
  dispatch takes under "on" for bf16 keys shorter than 64. It computes the
  function of the pair kernel (ops/attention_packed.attention_packed_pair):
  q scaled in f32, f32 logits, an f32 softmax over the keys, the
  probabilities rounded to the operand dtype before an f32-accumulated
  product with v. The TPU kernel's transposed (Lk, Lq) logits are a lane
  layout; the values are the same. Plain version:
  `attention_shortkey_reference`.
- `attention_shortkey_onematmul` is `fused_attention_shortkey`
  (`_mha_kernel_shortkey_onematmul`, `_shortkey_onematmul_nopair`,
  :262-416), which the dispatch takes under "auto" when
  kernels.SHORTKEY_VARIANT is "kernel". Its numerics differ: q * scale is
  rounded to the operand dtype, the softmax subtracts the row's maximum over
  ALL heads, each head's keys are a segment with its own sum, and a segment
  whose sum underflows to 0 takes weight 1/Lk on every key. The TPU kernel's
  block-diagonal kp / vp packing is a lane-layout device: the CUDA kernel
  reads each head's slice of the model-native operands and packs nothing.
  Plain version: `attention_shortkey_onematmul_reference`.

CPU tensors take the plain versions; CUDA tensors launch the kernel (bf16 or
fp32, head_dim 32, Ev == E) or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..kernels import refuse_autograd
from .attention_packed import (MAX_SMEM, NEG_INF, attention_packed_pair_reference, check_operands,
                               factors_u8, mask_u8)

PairFactors = Optional[Tuple[torch.Tensor, torch.Tensor]]

# kernel launches since import (or since the caller last set them to 0)
launches = 0  # the packed short-key kernel
onematmul_launches = 0  # the one-matmul segment-softmax kernel


def attention_shortkey_reference(q, k, v, num_heads: int, key_valid_mask=None,
                                 pair_factors: PairFactors = None):
    """Plain torch version of the packed short-key kernel: the pair kernel's
    f32 softmax, with the pair mask optional."""
    return attention_packed_pair_reference(q, k, v, num_heads, key_valid_mask, pair_factors)


def attention_shortkey_onematmul_reference(q, k, v, num_heads: int, key_valid_mask=None,
                                           pair_factors: PairFactors = None):
    """Plain torch version of the one-matmul short-key kernel. q (B, Lq, E),
    k (B, Lk, E), v (B, Lk, Ev), key_valid_mask (B, Lk) True = attendable,
    pair_factors ((B, H, Lq), (B, H, Lk)) bool -> (B, Lq, Ev) in v's dtype."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    hd, hdv = E // H, Ev // H
    qs = q * torch.tensor(hd**-0.5, dtype=q.dtype)  # product rounded to the operand dtype
    qh = qs.reshape(B, Lq, H, hd).float()
    kh = k.reshape(B, Lk, H, hd).float()
    logits = torch.einsum("bqhd,bkhd->bqhk", qh, kh)  # (B, Lq, H, Lk) f32
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    if pair_factors is not None:
        qf, kf = pair_factors
        dis = qf.bool().transpose(1, 2)[..., None] & kf.bool()[:, None]
        logits = torch.where(dis, neg, logits)
    if key_valid_mask is not None:
        logits = torch.where(key_valid_mask.bool()[:, None, None, :], logits, neg)
    gmax = logits.amax(dim=(2, 3), keepdim=True)  # the row's max over every head
    e = torch.exp(logits - gmax)
    sums = e.sum(-1, keepdim=True)  # per-head segment sums
    p = torch.where(sums > 0.0, e / sums, torch.tensor(1.0 / Lk, device=q.device)).to(v.dtype)
    vh = v.reshape(B, Lk, H, hdv).float()
    out = torch.einsum("bqhk,bkhd->bqhd", p.float(), vh)
    return out.reshape(B, Lq, Ev).to(v.dtype)


def _launch(name: str, q, k, v, num_heads: int, key_valid_mask, pair_factors: PairFactors,
            onematmul: bool):
    """Checks the operands and launches kernels/csrc/attention_shortkey.cu;
    returns out."""
    B, Lq, Lk, E, _ = check_operands(name, q, k, v, num_heads, key_valid_mask,
                                     (torch.bfloat16, torch.float32), (32,))
    H = num_heads
    from ..kernels.build import load

    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = load("attention_shortkey")
    smem_bytes = lib.attention_shortkey_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int] * 4
    need = smem_bytes(is_bf16, H, Lk, E)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: {Lk} keys of width {E} need {need} bytes of shared memory")
    mask = mask_u8(key_valid_mask, B, Lk, q.device)
    qf = kf = None
    if pair_factors is not None:
        qf, kf = factors_u8(pair_factors, B, H, Lq, Lk, q.device)
    scale = (E // H) ** -0.5
    if onematmul:  # q * scale is a product in the operand dtype
        scale = float(torch.tensor(scale, dtype=q.dtype))
    out = torch.empty(B, Lq, E, dtype=q.dtype, device=q.device)
    fn = lib.attention_shortkey_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        None if qf is None else qf.data_ptr(), None if kf is None else kf.data_ptr(),
        out.data_ptr(), B, H, Lq, Lk, E, is_bf16, int(onematmul), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def attention_shortkey(q, k, v, num_heads: int, key_valid_mask=None,
                       pair_factors: PairFactors = None):
    """The packed short-key kernel (f32 softmax per head). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise. Raises for
    an input that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("attention_shortkey", q, k, v)
    if q.device.type == "cpu":
        return attention_shortkey_reference(q, k, v, num_heads, key_valid_mask, pair_factors)
    out = _launch("attention_shortkey", q, k, v, num_heads, key_valid_mask, pair_factors, False)
    launches += 1
    return out


def attention_shortkey_onematmul(q, k, v, num_heads: int, key_valid_mask=None,
                                 pair_factors: PairFactors = None):
    """The one-matmul short-key kernel (segment softmax under the row's
    global maximum, 1/Lk for an empty segment). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Raises for an input
    that requires grad in grad mode (no graph)."""
    global onematmul_launches
    refuse_autograd("attention_shortkey_onematmul", q, k, v)
    if q.device.type == "cpu":
        return attention_shortkey_onematmul_reference(q, k, v, num_heads, key_valid_mask,
                                                      pair_factors)
    out = _launch("attention_shortkey_onematmul", q, k, v, num_heads, key_valid_mask,
                  pair_factors, True)
    onematmul_launches += 1
    return out
