"""The attention kernels in training: an autograd.Function with the kernel
forward and a recomputed plain backward.

Port of mesm_tpu/ops/attention_pallas.py::fused_attention_trainable
(`_fat_fwd`, `_fat_bwd`, :571-614). The forward is what `fused_attention`
(:617-675) runs for a dropout-free call: the bf16 packed kernel
(ops/attention_packed.py) or the fp32 batched kernel
(ops/attention_batched.py), and models/attention.attention_core where the
JAX function itself takes its plain core (a side shorter than 64, pair
factors on the fp32 variant) or where its kernel is not ported yet (on the
bf16 variant, pair factors or a key side shorter than 64: kernels 3 and 4
of the port's table). Only q, k, v, the key mask and the pair factors are
kept for the backward, never the (B, H, Lq, Lk) probabilities. The backward recomputes attention_core (f32
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
from .attention_packed import attention_packed

# forward passes that launched a kernel since import (or since the caller
# last set it to 0); the kernel's own wrapper counts the launch as well
launches = 0


def _kernel_route(q, k, pair_factors) -> Optional[str]:
    """The kernel `fused_attention` would launch for these operands, or None
    where it computes attention_core."""
    if min(q.shape[1], k.shape[1]) < kernels.MIN_FUSED_LEN or pair_factors is not None:
        return None
    if q.dtype == torch.bfloat16:
        return "packed"
    if q.dtype == torch.float32:
        return "batched"
    return None


def fused_attention(q, k, v, num_heads: int, key_valid_mask=None,
                    pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The dropout-free attention of attention_pallas.fused_attention: the
    kernel of the operands' dtype, or attention_core where there is none."""
    route = _kernel_route(q, k, pair_factors)
    if route == "packed":
        return attention_packed(q, k, v, num_heads, key_valid_mask)
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
        if q.device.type == "cuda" and _kernel_route(q, k, pair) is not None:
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
