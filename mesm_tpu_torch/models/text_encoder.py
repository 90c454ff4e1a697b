"""Frozen text encoders: the GloVe path.

Parity targets: mesm_tpu/models/text_encoder.py:136-197 and the reference
model/text_encoder.py (GloVe loader :397-429, GloveTextEncoder :432-454) with
the encode paths of model/model.py:136-152. The CLIP text tower is not
ported yet: its weights are not in the repository.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.masking import l2_normalize


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
