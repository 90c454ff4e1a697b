"""Frozen text encoders: the CLIP text tower and the GloVe path.

Parity targets: mesm_tpu/models/text_encoder.py (QuickGELU :31,
ResidualAttentionBlock :36, CLIPTextEncoder :67, clip_encode_text :112,
the GloVe path :136-197) and the reference model/text_encoder.py
(CLIPTextEncoder :240-354, GloVe loader :397-429, GloveTextEncoder :432-454)
with the encode paths of model/model.py:103-152.

The tower's modules carry the upstream state-dict names
(`transformer.resblocks.{i}.attn.in_proj_weight`, ...), so an upstream
`clip_text_encoder.pth` loads as it is (runner.build_clip_text_encoder).
Its parameters stay float32; it runs in the compute dtype it is given, with
the rounding points of the JAX tower's flax modules at `dtype` (the port's
Linear / LayerNorm), and returns float32 features from clip_encode_text.
It calls `attention_core` directly, as the JAX tower does: no kernel tier.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masking import l2_normalize
from .attention import NEG_INF, attention_core
from .layers import LayerNorm, Linear


class QuickGELU(nn.Module):
    """x * sigmoid(1.702 x), in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class _InProjAttention(nn.Module):
    """The parameters of torch's nn.MultiheadAttention (packed in_proj
    (3E, E), out_proj); the block splits the packed projection at use."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm causal self-attention block with a QuickGELU MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = _InProjAttention(width)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=Linear(width, 4 * width), gelu=QuickGELU(), c_proj=Linear(4 * width, width)))

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        wq, wk, wv = self.attn.in_proj_weight.to(x.dtype).chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.to(x.dtype).chunk(3)
        a = attention_core(F.linear(y, wq, bq), F.linear(y, wk, bk), F.linear(y, wv, bv),
                           self.heads, logit_bias=causal_bias)
        x = x + self.attn.out_proj(a)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """CLIP text tower: per-token states (the transformer width) and the
    eot-pooled projected sentence embedding."""

    def __init__(self, embed_dim: int, context_length: int, vocab_size: int, width: int,
                 heads: int, layers: int):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.positional_embedding, std=0.01)
        nn.init.normal_(self.text_projection, std=width**-0.5)

    def forward(self, text: torch.Tensor, dtype: torch.dtype = torch.float32):
        """text: (B, context_length) token ids -> {"last_hidden_state": (B,
        L, width), "pooler_output": (B, embed_dim)}, both in `dtype`."""
        L = self.context_length
        # gather, then cast: the same values as casting the tables first
        x = F.embedding(text, self.token_embedding.weight).to(dtype) + \
            self.positional_embedding.to(dtype)[None]
        causal = torch.triu(torch.full((L, L), NEG_INF, dtype=dtype, device=x.device), 1)
        for block in self.transformer.resblocks:
            x = block(x, causal[None, None])
        x = self.ln_final(x)
        eot = torch.argmax(text, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection.to(dtype)
        return {"last_hidden_state": x, "pooler_output": pooled}


def clip_encode_text(clip: CLIPTextEncoder, words_id: torch.Tensor, words_mask: torch.Tensor,
                     max_words_l: int, normalize_txt: bool = True,
                     dtype: torch.dtype = torch.float32):
    """Reference MESM.CLIP_encode_text (model/model.py:103-134): the frozen
    tower in `dtype`, float32 word states truncated to max_words_l, zeroed at
    padding, the sentence the masked mean, both L2-normalised (eps 1e-5).
    Returns (words_feat, sentence_feat, words_id, words_mask), truncated."""
    words_feat = clip(words_id, dtype)["last_hidden_state"].float()[:, :max_words_l]
    words_id = words_id[:, :max_words_l]
    words_mask = words_mask[:, :max_words_l]
    words_feat = torch.where(words_mask[..., None], words_feat, torch.zeros_like(words_feat))
    sentence_feat = words_feat.sum(dim=1) / words_mask.sum(dim=1, keepdim=True)
    if normalize_txt:
        words_feat = l2_normalize(words_feat, eps=1e-5)
        sentence_feat = l2_normalize(sentence_feat, eps=1e-5)
    return words_feat, sentence_feat, words_id, words_mask


class GloVeTextEncoder(nn.Module):
    """Frozen embedding lookup, filled from GloVe vectors at build time."""

    def __init__(self, num_embeddings: int, features: int = 300):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, features)
        self.embedding.weight.requires_grad_(False)

    def forward(self, word_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(word_ids)


def glove_encode_text(glove: GloVeTextEncoder, words_id: torch.Tensor, words_mask: torch.Tensor,
                      normalize_txt: bool = True):
    """Reference MESM.GloVe_encode_text (model/model.py:136-143)."""
    words_feat = glove(words_id)
    words_feat = torch.where(words_mask[..., None], words_feat, torch.zeros_like(words_feat))
    sentence_feat = words_feat.sum(dim=1) / words_mask.sum(dim=1, keepdim=True)
    if normalize_txt:
        words_feat = l2_normalize(words_feat, eps=1e-5)
        sentence_feat = l2_normalize(sentence_feat, eps=1e-5)
    return words_feat, sentence_feat


def post_process_precomputed_text(words_feat: torch.Tensor, normalize_txt: bool = True):
    """Precomputed 300-d word features as input (GloVeNLTK + load_vocab_pkl):
    reference MESM.post_process_text (model/model.py:145-152). The word mask
    comes from nonzero feature sums."""
    if normalize_txt:
        words_feat = l2_normalize(words_feat)  # default eps (1e-12), per reference
    words_mask = words_feat.sum(dim=-1) != 0
    sentence_feat = words_feat.sum(dim=1) / words_mask.sum(dim=1, keepdim=True)
    if normalize_txt:
        sentence_feat = l2_normalize(sentence_feat)
    return words_feat, words_mask, sentence_feat


def build_glove_embedding_matrix(vocab_itow: dict, glove_vectors: dict, dim: int = 300,
                                 seed: int = 0) -> np.ndarray:
    """Fill an embedding table from a word->vector dict; unknown words get the
    shared <UNK> random vector, <PAD> is zeros (reference
    text_encoder.py:402-413)."""
    rng = np.random.default_rng(seed)
    unk = rng.standard_normal(dim).astype(np.float32)
    table = np.zeros((len(vocab_itow), dim), np.float32)
    for idx, word in vocab_itow.items():
        if word == "<PAD>":
            continue
        if word == "<UNK>" or word not in glove_vectors:
            table[idx] = unk
        else:
            table[idx] = glove_vectors[word]
    return table
