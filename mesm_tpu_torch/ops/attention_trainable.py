"""The attention kernels in training: an autograd.Function with the kernel
forward and a recomputed plain backward.

Port of mesm_tpu/ops/attention_pallas.py::fused_attention_trainable
(`_fat_fwd`, `_fat_bwd`, :571-614). The forward is what `fused_attention`
(:617-675) runs for a dropout-free call: the kernel that
kernels.fused_route picks for the operands (bf16: the packed kernel, its
pair-masked entry point or the short-key kernel; fp32: the batched kernel),
and models/attention.attention_core where the JAX function itself takes its
plain core (a side too short, pair factors on the fp32 variant). Only q, k,
v, the key mask and the pair factors are kept for the backward, never the
(B, H, Lq, Lk) probabilities. The backward recomputes attention_core (f32
softmax, not the kernel's numerics, as `_fat_bwd` does) on detached inputs
and differentiates it with torch.autograd.grad. The JAX package has no
Pallas backward here (its backward is XLA's VJP of the plain core), so the
port's backward is the plain core's autograd. Dropout is the caller's
concern: only dropout-free attention may come here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from .attention_batched import attention_batched
from .attention_packed import attention_packed, attention_packed_pair
from .attention_shortkey import attention_shortkey

# forward passes that launched a kernel since import (or since the caller
# last set it to 0); the kernel's own wrapper counts the launch as well
launches = 0


def _route(q, k, pair_factors) -> Optional[str]:
    return kernels.fused_route(q.shape[1], k.shape[1], q.dtype, pair_factors is not None)


def fused_attention(q, k, v, num_heads: int, key_valid_mask=None,
                    pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The dropout-free attention of attention_pallas.fused_attention: the
    kernel kernels.fused_route picks, or attention_core where there is none."""
    route = _route(q, k, pair_factors)
    if route == "packed":
        return attention_packed(q, k, v, num_heads, key_valid_mask)
    if route == "packed_pair":
        return attention_packed_pair(q, k, v, num_heads, key_valid_mask, pair_factors)
    if route == "shortkey":
        return attention_shortkey(q, k, v, num_heads, key_valid_mask, pair_factors)
    if route == "batched":
        return attention_batched(q, k, v, num_heads, key_valid_mask)
    from ..models.attention import attention_core

    return attention_core(q, k, v, num_heads, key_valid_mask=key_valid_mask,
                          pair_factors=pair_factors)


class _AttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, key_valid_mask, qf, kf):
        global launches
        pair = None if qf is None else (qf, kf)
        out = fused_attention(q, k, v, num_heads, key_valid_mask, pair)
        if q.device.type == "cuda" and _route(q, k, pair) is not None:
            launches += 1
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, key_valid_mask, qf, kf)
        return out

    @staticmethod
    def backward(ctx, g):
        from ..models.attention import attention_core

        q, k, v, mask, qf, kf = ctx.saved_tensors
        pair = None if qf is None else (qf, kf)
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = attention_core(qd, kd, vd, ctx.num_heads, key_valid_mask=mask, pair_factors=pair)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None


def attention_trainable(q, k, v, num_heads: int, key_valid_mask=None,
                        pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Differentiable dropout-free multi-head attention over (B, L, E)
    operands: kernel forward, attention_core's gradients."""
    qf, kf = pair_factors if pair_factors is not None else (None, None)
    return _AttentionTrainable.apply(q, k, v, num_heads, key_valid_mask, qf, kf)
