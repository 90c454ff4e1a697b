"""Mask algebra helpers shared across the model stack.

Fixed shapes plus boolean masks replace every ragged op of the reference
(pad_sequences_1d, split_and_pad, split_expand_and_pad — reference
utils/data_utils.py:34-110). Masks are boolean, True = valid; the attention
code flips them where it needs padding masks.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool valid-mask."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean of x over `dim`, counting only mask==True positions.

    Matches the reference's `sum / mask.sum()` pattern (e.g. CLIP sentence
    pooling, model/model.py:123) including its inf/nan for fully-masked
    rows — callers guarantee at least one valid element.
    """
    mask = mask.to(x.dtype)
    if mask.ndim < x.ndim:
        mask = mask.unsqueeze(-1)
    return (x * mask).sum(dim=dim) / mask.sum(dim=dim)


def masked_softmax_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace invalid logits with a large negative constant (not -inf, so a
    fully-masked row stays finite)."""
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize along `dim`: x / max(||x||, eps), as
    torch.nn.functional.normalize (the reference uses eps=1e-5 in
    model/model.py:131-132 and the default 1e-12 in criterion.py:258-259)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)
