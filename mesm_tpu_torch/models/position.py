"""Positional encodings.

Parity targets: mesm_tpu/models/position.py and the reference
model/position_encoding.py (PositionEmbeddingSine :35-72 with
normalize=True, scale=2*pi; TrainablePositionalEncoding :10-32).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import LayerNorm


def sine_position_embedding(
    mask: torch.Tensor,  # (B, L) valid-mask (True = valid)
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, L) valid-mask -> (B, L, num_pos_feats) sinusoidal embedding.

    Positions are the cumulative count of valid elements, normalised to
    [0, scale] by the last cumsum value. Channel 2k is sin(x / t_k) and
    channel 2k+1 cos(x / t_k) with t_k = temperature^(2k / F): the reference's
    dim_t repeats each frequency twice, so F/2 angles suffice (the
    half-frequency form of mesm_tpu/models/position.py:35-59). sin and cos
    run in f32 and are cast to `dtype`."""
    x_embed = torch.cumsum(mask.to(torch.float32), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * scale
    half = num_pos_feats // 2
    i = torch.arange(half, dtype=torch.float32, device=mask.device)
    inv_freq = temperature ** (2.0 * i / num_pos_feats)
    angle = x_embed[..., None] / inv_freq
    pos = torch.stack([torch.sin(angle).to(dtype), torch.cos(angle).to(dtype)], dim=-1)
    return pos.reshape(*pos.shape[:-2], num_pos_feats)


class TrainablePositionEmbedding(nn.Module):
    """input + learned positional embedding -> LayerNorm -> Dropout
    (reference TrainablePositionalEncoding)."""

    def __init__(self, max_positions: int, hidden_size: int, dropout: float = 0.1):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_positions, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[1]
        emb = self.position_embeddings.weight[:L][None].to(x.dtype)
        return self.dropout(self.LayerNorm(x + emb))
