"""Text -> video cross-modal encoder (the reference's "T2V" stack).

Parity targets: mesm_tpu/models/t2v.py and the reference
model/transformer.py (T2V_TransformerEncoderLayer :485-559, the TwoMLP
variant :562-612, the encoder wrappers :62-116, :208-242).

Layer dataflow (post-norm):
  q = video + pos_vid ; k = text + pos_txt ; v = text
  x = video + attn(q, k, v)          # cross-attn, text keys masked
  out = norm2(x + ffn(norm1(x)))

The reference's mis-tiled pair mask is reproduced (PARITY.md quirk 1): it
tiles the (q, k) padding outer product head-major, but torch consumes a 3-D
attn_mask batch-major, so head h of sample b is masked by the pairs of
sample (b*H + h) % B. The values therefore depend on the padded batch size B.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel import rows
from .attention import ProjAttention
from .layers import LayerNorm, Linear, apply_ln, ffn, make_activation


def scrambled_pair_factors(vid_valid_mask: torch.Tensor, txt_valid_mask: torch.Tensor,
                           num_heads: int):
    """Factored form of the reference's mis-tiled pair mask: head h of sample
    b is masked where qpad[s, q] & kpad[s, k] with s = (b*H + h) % B. Returns
    the (B, H, Lq) and (B, H, Lk) factors; attention_core combines them as an
    outer product. In a data-parallel step B is the whole batch's row count
    and the factors are this rank's rows of them (parallel/rows.py). Under a
    sequence shard (parallel/seq.py) a video mask is this rank's slice of
    the video axis, so its factor is this rank's slice too."""
    qpad = ~rows.gather(vid_valid_mask.bool())
    kpad = ~rows.gather(txt_valid_mask.bool())
    B = qpad.shape[0]
    dev = qpad.device
    src = (torch.arange(B, device=dev)[:, None] * num_heads
           + torch.arange(num_heads, device=dev)[None, :]) % B
    src = rows.local(src)
    return qpad[src], kpad[src]


class T2VLayer(nn.Module):
    """One T2V layer. `two_mlp` adds the reversed-direction FFN and norms
    (linear1_1, linear2_1, norm1_1, norm2_1), used by the MLM path."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 1024,
                 dropout: float = 0.1, activation: str = "prelu", two_mlp: bool = False,
                 xavier_init: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.two_mlp = two_mlp
        self.self_attn = ProjAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        if two_mlp:
            self.linear1_1 = Linear(d_model, dim_feedforward)
            self.linear2_1 = Linear(dim_feedforward, d_model)
            self.norm1_1 = LayerNorm(d_model, eps=1e-5)
            self.norm2_1 = LayerNorm(d_model, eps=1e-5)
        self.activation = make_activation(activation)
        self.dropout = nn.Dropout(dropout)
        if xavier_init:  # reference transformer.py:78-81 re-inits every >1-dim param
            for p in self.parameters():
                if p.dim() > 1:
                    nn.init.xavier_uniform_(p)

    def forward(self, src_txt, src_vid, txt_valid_mask, pos_txt=None, pos_vid=None,
                vid_valid_mask=None, is_mlm: bool = False, pair_factors=None, q_len=None):
        """`pair_factors` overrides the factors of (vid_valid_mask,
        txt_valid_mask): the scramble depends on the row count of the call,
        so the stacked [positive | negative] pass passes per-half factors.
        `q_len`: the whole query axis where the video stream is this rank's
        slice of a sequence shard (models/attention.dispatch_attention_core)."""
        q = src_vid if pos_vid is None else src_vid + pos_vid
        k = src_txt if pos_txt is None else src_txt + pos_txt
        if pair_factors is None and vid_valid_mask is not None and txt_valid_mask is not None:
            pair_factors = scrambled_pair_factors(vid_valid_mask, txt_valid_mask, self.num_heads)
        attn = self.self_attn(q, k, src_txt, key_valid_mask=txt_valid_mask,
                              pair_factors=pair_factors, q_len=q_len)
        x = src_vid + self.dropout(attn)
        if self.two_mlp and is_mlm:
            norm1, linear1, linear2, norm2 = self.norm1_1, self.linear1_1, self.linear2_1, self.norm2_1
        else:
            norm1, linear1, linear2, norm2 = self.norm1, self.linear1, self.linear2, self.norm2
        y = ffn(apply_ln(norm1, x, self.training), linear1, self.activation, linear2, self.dropout,
                self.training)
        return apply_ln(norm2, x + self.dropout(y), self.training)


class T2VStack(nn.Module):
    """Stack of T2VLayers (`layers.<i>.*`): the video stream is refined, the
    text re-read by every layer. SS-MESM's `recon_trans` is a bare stack."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 1024, dropout: float = 0.1, activation: str = "prelu",
                 two_mlp: bool = False, xavier_init: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            T2VLayer(d_model, num_heads, dim_feedforward, dropout, activation, two_mlp, xavier_init)
            for _ in range(num_layers)
        )

    def forward(self, src_txt, src_vid, txt_valid_mask, pos_txt=None, pos_vid=None,
                vid_valid_mask=None, is_mlm: bool = False, pair_factors=None, q_len=None):
        x = src_vid
        for layer in self.layers:
            x = layer(src_txt, x, txt_valid_mask, pos_txt, pos_vid, vid_valid_mask,
                      is_mlm=is_mlm, pair_factors=pair_factors, q_len=q_len)
        return x


class T2VEncoder(nn.Module):
    """The upstream T2V_TransformerEncoder wrapper around a stack
    (reference model/transformer.py:62-116): `<name>.t2v_encoder.layers.<i>.*`."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.t2v_encoder = T2VStack(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self.t2v_encoder(*args, **kwargs)
