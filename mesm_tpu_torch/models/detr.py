"""DETR transformer: global-token encoder + DAB-style anchor decoder.

Parity targets: mesm_tpu/models/detr.py and the reference
model/transformer.py (gen_sineembed_for_position :43-59, encoder layer
:615-673 post-norm, decoder layer :676-797, decoder :280-420, Transformer
:119-205). Batch-first; masks are valid-masks (True = attendable).

The reference xavier-initialises every >1-dim parameter of the transformer
(:168-171); the zero bias of the bbox head's last layer survives.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel import seq
from .attention import CoreAttention, ProjAttention
from .layers import MLP, LayerNorm, Linear, apply_ln, ffn, make_activation


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def gen_sine_embed(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Sine embedding of (center, width) anchors: (B, nq, 2) -> (B, nq, dim)."""
    scale = 2 * math.pi
    each_dim = dim // 2
    i = torch.arange(each_dim, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.floor(i / 2) / each_dim)

    def embed(component):  # (B, nq)
        x = component[..., None] * scale / dim_t
        out = torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])], dim=-1)
        return out.reshape(*x.shape[:-1], -1)

    return torch.cat([embed(pos[..., 0]), embed(pos[..., 1])], dim=-1)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 1024,
                 dropout: float = 0.1, activation: str = "prelu"):
        super().__init__()
        self.self_attn = ProjAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.activation = make_activation(activation)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src, valid_mask, pos, replicated: int = 0):
        """`valid_mask` is the key mask of the whole sequence. Under a
        sequence shard (parallel/seq.py) `src` and `pos` hold `replicated`
        leading entries (the global token) and this rank's slice of the
        rest: the queries stay local, the keys and values are gathered."""
        q = src + pos
        k = seq.gather(q, start=replicated)
        v = seq.gather(src, start=replicated)
        attn = self.self_attn(q, k, v, key_valid_mask=valid_mask,
                              q_len=seq.whole_len(q.shape[1], replicated))
        src = apply_ln(self.norm1, src + self.dropout(attn), self.training)
        y = ffn(src, self.linear1, self.activation, self.linear2, self.dropout, self.training)
        return apply_ln(self.norm2, src + self.dropout(y), self.training)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(*layer_args) for _ in range(num_layers))

    def forward(self, src, valid_mask, pos, replicated: int = 0):
        for layer in self.layers:
            src = layer(src, valid_mask, pos, replicated=replicated)
        return src


class TransformerDecoderLayer(nn.Module):
    """One DAB decoder layer: content + positional projections for the
    self-attention; for the cross-attention the per-head concat of content
    and positional halves is computed as two dot products (split_qk)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 1024,
                 dropout: float = 0.1, activation: str = "prelu", use_qpos_in_cross: bool = False):
        super().__init__()
        d = d_model
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj", "sa_kpos_proj",
                     "sa_v_proj", "ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj",
                     "ca_kpos_proj", "ca_qpos_sine_proj"):
            setattr(self, name, Linear(d, d))
        self.use_qpos_in_cross = use_qpos_in_cross
        if use_qpos_in_cross:  # keep_query_pos=False: only the first layer has it
            self.ca_qpos_proj = Linear(d, d)
        self.self_attn = CoreAttention(d, num_heads, dropout)
        self.cross_attn = CoreAttention(d, num_heads, dropout)
        self.linear1 = Linear(d, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.activation = make_activation(activation)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt, memory, memory_valid_mask, pos, query_pos, query_sine_embed):
        q = self.sa_qcontent_proj(tgt) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_kpos_proj(query_pos)
        v = self.sa_v_proj(tgt)
        tgt = self.norm1(tgt + self.dropout(self.self_attn(q, k, v)))

        q_content = self.ca_qcontent_proj(tgt)
        k_content = self.ca_kcontent_proj(memory)
        v = self.ca_v_proj(memory)
        k_pos = self.ca_kpos_proj(pos)
        if self.use_qpos_in_cross:
            q_content = q_content + self.ca_qpos_proj(query_pos)
            k_content = k_content + k_pos
        qse = self.ca_qpos_sine_proj(query_sine_embed)
        ca = self.cross_attn(q_content, k_content, v, key_valid_mask=memory_valid_mask,
                             split_qk=(qse, k_pos))
        tgt = self.norm2(tgt + self.dropout(ca))
        y = ffn(tgt, self.linear1, self.activation, self.linear2, self.dropout, self.training)
        return self.norm3(tgt + self.dropout(y))


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 1024, dropout: float = 0.1, activation: str = "prelu",
                 modulate_t_attn: bool = True):
        super().__init__()
        d = d_model
        self.d_model = d
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d, num_heads, dim_feedforward, dropout, activation,
                                    use_qpos_in_cross=(i == 0))
            for i in range(num_layers)
        )
        self.ref_point_head = MLP(d, d, d, 2)
        self.query_scale = MLP(d, d, d, 2)
        self.bbox_embed = MLP(d, d, 2, 3)
        nn.init.zeros_(self.bbox_embed.layers[-1].bias)
        self.modulate_t_attn = modulate_t_attn
        if modulate_t_attn:
            self.ref_anchor_head = MLP(d, d, 1, 2)
        self.norm = LayerNorm(d, eps=1e-5)

    def forward(self, tgt, memory, memory_valid_mask, pos, refpoints_unsigmoid):
        output = tgt
        reference_points = torch.sigmoid(refpoints_unsigmoid)
        refs = [reference_points]
        hidden = []
        n = len(self.layers)
        for layer_id, layer in enumerate(self.layers):
            obj_center = reference_points
            query_sine_embed = gen_sine_embed(obj_center, self.d_model).to(tgt.dtype)
            query_pos = self.ref_point_head(query_sine_embed)
            if layer_id != 0:
                query_sine_embed = query_sine_embed * self.query_scale(output)
            if self.modulate_t_attn:
                reft_cond = torch.sigmoid(self.ref_anchor_head(output))  # (B, nq, 1)
                query_sine_embed = query_sine_embed * (reft_cond[..., 0] / obj_center[..., 1])[..., None]
            output = layer(output, memory, memory_valid_mask, pos, query_pos, query_sine_embed)
            # iterative anchor refinement, detached for the next layer
            new_ref = torch.sigmoid(self.bbox_embed(output) + inverse_sigmoid(reference_points))
            if layer_id != n - 1:
                refs.append(new_ref)
            reference_points = new_ref.detach()
            hidden.append(self.norm(output))
        return torch.stack(hidden), torch.stack(refs)


class Transformer(nn.Module):
    """Encoder-decoder with a prepended per-sample global token, whose encoder
    output is the video-level representation for saliency scoring.

    Under a sequence shard (parallel/seq.py) `src`, `valid_mask` and
    `pos_embed` are this rank's slice of the video axis. The global token's
    query row is computed on every rank (its keys are the gathered whole
    sequence), each clip's on the rank that holds it; the decoder reads the
    gathered memory and positions and is computed alike on every rank. The
    returned memory_local is this rank's slice."""

    def __init__(self, d_model: int = 256, num_heads: int = 8, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, dim_feedforward: int = 1024, dropout: float = 0.1,
                 activation: str = "prelu"):
        super().__init__()
        self.encoder = TransformerEncoder(
            num_encoder_layers, d_model, num_heads, dim_feedforward, dropout, activation
        )
        self.decoder = TransformerDecoder(
            d_model, num_heads, num_decoder_layers, dim_feedforward, dropout, activation
        )
        for p in self.parameters():  # reference transformer.py:168-171
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)

    def forward(self, src, valid_mask, refpoint_embed, pos_embed, global_token, global_token_pos):
        B, L, d = src.shape
        src = torch.cat([global_token, src], dim=1)
        pos_embed = torch.cat([global_token_pos, pos_embed], dim=1)
        # the global token is a query (its output becomes memory_global) but
        # never attendable as a key (reference transformer.py:185-186)
        whole_mask = seq.gather(valid_mask.bool())
        full_mask = torch.cat(
            [torch.zeros(B, 1, dtype=torch.bool, device=src.device), whole_mask], dim=1
        )
        memory = self.encoder(src, full_mask, pos_embed, replicated=1)
        memory_global, memory_local = memory[:, 0], memory[:, 1:]
        nq = refpoint_embed.shape[0]
        tgt = torch.zeros(B, nq, d, dtype=src.dtype, device=src.device)
        refpoints = refpoint_embed[None].expand(B, nq, 2).to(src.dtype)
        hs, references = self.decoder(tgt, seq.gather(memory_local), whole_mask,
                                      seq.gather(pos_embed[:, 1:]), refpoints)
        return hs, references, memory_local, memory_global
