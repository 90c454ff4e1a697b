"""The attention kernels in training: an autograd.Function with the kernel
forward and, in float32, the backward kernel.

Port of mesm_tpu/ops/attention_pallas.py::fused_attention_trainable
(`_fat_fwd`, `_fat_bwd`, :571-614). The forward is what `fused_attention`
(:617-675) runs for a dropout-free call: the kernel that
kernels.fused_route picks for the operands and MESM_ATTN_VARIANT (by
default, bf16: the packed kernel, its pair-masked entry point or the
short-key kernel; fp32: the batched kernel; under the variant also the
per-head and all-heads kernels, and either family in either dtype), and
models/attention.attention_core where the JAX function itself takes its
plain core (a side too short, pair factors outside the packed variant).
q, k, v, the key mask, the pair factors and (for the backward kernel) the
output are kept for the backward, never the (B, H, Lq, Lk) probabilities.

The gradients are attention_core's (f32 softmax, not the forward kernel's
numerics), as `_fat_bwd`'s, which is XLA's VJP of the plain core. The route
is chosen from the operands in the forward, before any launch: float32
operands with no pair factors on a kernel route take the backward kernel
(ops/attention_backward.py, whose plain version runs for CPU tensors and
equals autograd through attention_core); every other call (pair factors,
bf16, no kernel route) recomputes attention_core on detached inputs and
differentiates it with torch.autograd.grad. Dropout is the caller's concern:
only dropout-free attention may come here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from .attention_backward import attention_backward
from .attention_batched import attention_batched
from .attention_heads import attention_all_heads, attention_per_head
from .attention_packed import attention_packed, attention_packed_pair
from .attention_shortkey import attention_shortkey

# forward passes that launched a kernel since import (or since the caller
# last set it to 0); the kernel's own wrapper counts the launch as well
launches = 0


def _route(q, k, pair_factors) -> Optional[str]:
    return kernels.fused_route(q.shape[1], k.shape[1], q.dtype, pair_factors is not None)


def fused_attention(q, k, v, num_heads: int, key_valid_mask=None,
                    pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    route: Optional[str] = None):
    """The dropout-free attention of attention_pallas.fused_attention: the
    kernel kernels.fused_route picks, or attention_core where there is none.
    `route`, when given, is the caller's decision on the whole sample's
    lengths (a sequence-sharded call holds a slice of the queries)."""
    route = route or _route(q, k, pair_factors)
    if route == "packed":
        return attention_packed(q, k, v, num_heads, key_valid_mask)
    if route == "packed_pair":
        return attention_packed_pair(q, k, v, num_heads, key_valid_mask, pair_factors)
    if route == "shortkey":
        return attention_shortkey(q, k, v, num_heads, key_valid_mask, pair_factors)
    if route == "batched":
        return attention_batched(q, k, v, num_heads, key_valid_mask)
    if route == "all_heads":
        return attention_all_heads(q, k, v, num_heads, key_valid_mask)
    if route == "per_head":
        return attention_per_head(q, k, v, num_heads, key_valid_mask)
    from ..models.attention import attention_core

    return attention_core(q, k, v, num_heads, key_valid_mask=key_valid_mask,
                          pair_factors=pair_factors)


class _AttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, key_valid_mask, qf, kf, route):
        global launches
        pair = None if qf is None else (qf, kf)
        route = route or _route(q, k, pair)
        out = fused_attention(q, k, v, num_heads, key_valid_mask, pair, route)
        if q.device.type == "cuda" and route is not None:
            launches += 1
        ctx.num_heads = num_heads
        # the backward kernel takes float32 without pair factors on a kernel route
        ctx.kernel_backward = route is not None and pair is None and q.dtype == torch.float32
        ctx.save_for_backward(q, k, v, key_valid_mask, qf, kf, out if ctx.kernel_backward else None)
        return out

    @staticmethod
    def backward(ctx, g):
        from ..models.attention import attention_core

        q, k, v, mask, qf, kf, out = ctx.saved_tensors
        if ctx.kernel_backward:
            dq, dk, dv = attention_backward(q, k, v, out, g.contiguous(), ctx.num_heads, mask)
            return dq, dk, dv, None, None, None, None, None
        pair = None if qf is None else (qf, kf)
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = attention_core(qd, kd, vd, ctx.num_heads, key_valid_mask=mask, pair_factors=pair)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None, None


def attention_trainable(q, k, v, num_heads: int, key_valid_mask=None,
                        pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        route: Optional[str] = None):
    """Differentiable dropout-free multi-head attention over (B, L, E)
    operands: kernel forward, attention_core's gradients (the backward
    kernel's in float32 without pair factors). `route` as fused_attention's."""
    qf, kf = pair_factors if pair_factors is not None else (None, None)
    return _AttentionTrainable.apply(q, k, v, num_heads, key_valid_mask, qf, kf, route)
