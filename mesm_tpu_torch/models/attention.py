"""Attention: one functional core, the kernel dispatch, and the two
projection styles.

Parity target: mesm_tpu/models/attention.py. `attention_core` is the plain
path at every site that is not a kernel: scaled QK^T, finite -1e9 masking,
the factored pair mask, the split (content | positional) logits of the DAB
decoder, and a softmax in f32. `dispatch_attention_core` takes the JAX
package's routing (mesm_tpu/models/attention.py:322-375, decided by
mesm_tpu_torch.kernels.attention_kernel): the bf16 packed kernel, its
pair-masked entry point (ops/attention_packed.py), the packed short-key and
the one-matmul short-key kernels (ops/attention_shortkey.py), the fp32
batched kernel (ops/attention_batched.py) or, under MESM_ATTN_VARIANT, the
per-head and all-heads kernels (ops/attention_heads.py), directly in eval
and through the trainable autograd.Function (ops/attention_trainable.py) in
training.

The JAX package's "segmm"/"reshape" short-key and its short-query
reformulations (attention.py:114-293) are TPU layout rewrites of the same
values with no Pallas kernel; here their sites take attention_core.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import kernels
from ..parallel import rows
from ..ops.attention_shortkey import attention_shortkey_onematmul
from ..ops.attention_trainable import attention_trainable, fused_attention
from .layers import Linear

NEG_INF = -1e9
# training calls whose attention_core ran under torch.utils.checkpoint
remat_calls = 0


def attention_core(
    q: torch.Tensor,  # (B, Lq, E), positional terms already added
    k: torch.Tensor,  # (B, Lk, E)
    v: torch.Tensor,  # (B, Lk, Ev)
    num_heads: int,
    key_valid_mask: Optional[torch.Tensor] = None,  # (B, Lk) True = attendable
    pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,H,Lq), (B,H,Lk)
    split_qk: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,Lq,E2), (B,Lk,E2)
    dropout_rate: float = 0.0,
    training: bool = False,
    logit_bias: Optional[torch.Tensor] = None,  # additive, broadcastable to (B,H,Lq,Lk)
) -> torch.Tensor:
    """Multi-head attention core, (B, Lq, Ev) before the out-projection.

    The scale uses the head dim of the query embedding (the concat width
    (E + E2) / H when split_qk is given, since <cat(qc, qp), cat(kc, kp)> is
    <qc, kc> + <qp, kp> per head). A pair (q, k) of head (b, h) is masked when
    both pair factors flag it. `logit_bias` (the CLIP tower's causal bias) is
    added to the logits in their dtype, after the split-qk term and before
    the masks. In bf16 the logits are stored in bf16 and the softmax runs in
    f32, as mesm_tpu's attention_core; in fp32 everything is f32."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    H = num_heads
    E_total = E + (split_qk[0].shape[-1] if split_qk is not None else 0)
    # the scale in the activation dtype, as a weakly typed scalar is in JAX
    scale = torch.tensor((E_total // H) ** -0.5, dtype=q.dtype)
    qh = q.reshape(B, Lq, H, E // H).transpose(1, 2)
    kh = k.reshape(B, Lk, H, E // H).transpose(1, 2)
    vh = v.reshape(B, Lk, H, Ev // H).transpose(1, 2)
    logits = torch.matmul(qh * scale, kh.transpose(-1, -2))  # (B, H, Lq, Lk)
    if split_qk is not None:
        q2, k2 = split_qk
        E2 = q2.shape[-1]
        q2h = q2.reshape(B, Lq, H, E2 // H).transpose(1, 2)
        k2h = k2.reshape(B, Lk, H, E2 // H).transpose(1, 2)
        logits = logits + torch.matmul(q2h * scale, k2h.transpose(-1, -2))
    if logit_bias is not None:
        logits = logits + logit_bias
    # a fill kernel, not a host tensor copied over: a CUDA graph captures it
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device)
    if pair_factors is not None:
        qf, kf = pair_factors
        logits = torch.where(qf[..., :, None] & kf[..., None, :], neg, logits)
    if key_valid_mask is not None:
        logits = torch.where(key_valid_mask[:, None, None, :].bool(), logits, neg)
    weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    if dropout_rate > 0.0 and training:
        weights = F.dropout(weights, dropout_rate, training=True)
    out = torch.matmul(weights, vh)  # (B, H, Lq, Ev/H)
    return out.transpose(1, 2).reshape(B, Lq, Ev)


def dispatch_attention_core(q, k, v, num_heads: int, key_valid_mask=None, pair_factors=None,
                            split_qk=None, dropout_rate: float = 0.0, training: bool = False,
                            q_len: Optional[int] = None):
    """mesm_tpu/models/attention.py:322-375. A call with split_qk or active
    dropout takes attention_core (no tier takes them). Otherwise
    mesm_tpu_torch.kernels.attention_kernel decides: a Pallas-tier kernel
    runs as itself in eval (fused_attention) and as the trainable Function's
    forward in training, whose backward is attention_core's; the short-key
    tier's "kernel" variant (eval only) launches the one-matmul short-key
    kernel; everything else is attention_core, which a training call whose
    sides both reach kernels.ATTN_REMAT_MIN_L runs under
    torch.utils.checkpoint when kernels.ATTN_REMAT is set (the JAX package's
    jax.checkpoint, attention.py:296-319): the backward recomputes the
    logits, the softmax and, with the forward's RNG state restored, the
    same dropout mask.

    Every decision is taken on the whole batch's lengths, as the JAX
    package's GSPMD program sees them: the rows of every data rank
    (parallel/rows.py) and `q_len`, the whole query axis of a call whose
    queries are this rank's slice of the video (parallel/seq.py; the keys
    of such a call are gathered whole). The kernel then runs on the local
    queries against those keys."""
    global remat_calls
    dropout_active = training and dropout_rate > 0.0
    Lq = q.shape[1] if q_len is None else q_len
    route = None
    if split_qk is None and not dropout_active:
        route = kernels.attention_kernel(
            q.shape[0] * rows.world(), Lq, k.shape[1], q.dtype, q.device,
            pair=pair_factors is not None, training=training,
        )
    if route == "shortkey_onematmul":
        return attention_shortkey_onematmul(q, k, v, num_heads, key_valid_mask, pair_factors)
    if route is not None:
        if training:
            return attention_trainable(q, k, v, num_heads, key_valid_mask, pair_factors, route)
        return fused_attention(q, k, v, num_heads, key_valid_mask, pair_factors, route)
    if kernels.use_attn_remat(Lq, k.shape[1], training):
        remat_calls += 1
        return torch.utils.checkpoint.checkpoint(
            attention_core, q, k, v, num_heads, key_valid_mask, pair_factors, split_qk,
            dropout_rate, training, use_reentrant=False, preserve_rng_state=True,
        )
    return attention_core(
        q, k, v, num_heads, key_valid_mask=key_valid_mask, pair_factors=pair_factors,
        split_qk=split_qk, dropout_rate=dropout_rate, training=training,
    )


class ProjAttention(nn.Module):
    """torch nn.MultiheadAttention parameters (packed in_proj (3E, E) +
    out_proj) on batch-first tensors and valid-masks."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k, v, key_valid_mask=None, pair_factors=None, q_len=None):
        """`q_len`: dispatch_attention_core's."""
        wq, wk, wv = self.in_proj_weight.to(q.dtype).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(q.dtype).chunk(3)
        out = dispatch_attention_core(
            F.linear(q, wq, bq), F.linear(k, wk, bk), F.linear(v, wv, bv), self.num_heads,
            key_valid_mask=key_valid_mask, pair_factors=pair_factors,
            dropout_rate=self.dropout, training=self.training, q_len=q_len,
        )
        return self.out_proj(out)


class CoreAttention(nn.Module):
    """Projection-free attention (reference model/attention.py:61-122): the
    callers project q/k/v; only out_proj (vdim -> vdim) lives here."""

    def __init__(self, vdim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.out_proj = Linear(vdim, vdim)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k, v, key_valid_mask=None, split_qk=None):
        out = dispatch_attention_core(
            q, k, v, self.num_heads, key_valid_mask=key_valid_mask, split_qk=split_qk,
            dropout_rate=self.dropout, training=self.training,
        )
        return self.out_proj(out)
