"""DETR-style set matching for moment retrieval, on the device.

Parity target: mesm_tpu/ops/matcher.py and the reference
model/matcher.py (HungarianMatcher). Cost = cost_span * L1(cxw)
+ cost_giou * (-gIoU(xx)) + cost_class * (-P(fg)), foreground is class 0.

Two regimes:
  - single-target (charades, TACoS, charades-cg/cd): every sample has one
    target, so the per-sample assignment is the cost argmin over queries;
  - multi-target (QVHighlights): a per-sample assignment of up to
    max_windows targets to the queries, solved on the device by the batched
    Hungarian solver (ops/lsap.py) instead of a .cpu() round trip.
"""
from __future__ import annotations

import torch

from .lsap import solve_lsap_batch
from .span import generalized_temporal_iou, span_cxw_to_xx


def _pair_cost(
    pred_logits: torch.Tensor,  # (B, nq, 2)
    pred_spans: torch.Tensor,  # (B, nq, 2) cxw in [0, 1]
    tgt_spans: torch.Tensor,  # (B, T, 2) cxw
    tgt_moments: torch.Tensor,  # (B, T, 2) xx
    cost_span: float,
    cost_giou: float,
    cost_class: float,
) -> torch.Tensor:
    """Per-sample (B, nq, T) matching cost."""
    prob_fg = torch.softmax(pred_logits, dim=-1)[..., 0]
    c_class = -prob_fg[:, :, None]
    c_span = (pred_spans[:, :, None, :] - tgt_spans[:, None, :, :]).abs().sum(-1)
    c_giou = -generalized_temporal_iou(span_cxw_to_xx(pred_spans), tgt_moments)
    return cost_span * c_span + cost_giou * c_giou + cost_class * c_class


@torch.no_grad()
def single_target_match(
    pred_logits: torch.Tensor,
    pred_spans: torch.Tensor,
    tgt_span: torch.Tensor,  # (B, 2) cxw
    tgt_moment: torch.Tensor,  # (B, 2) xx
    cost_span: float = 10.0,
    cost_giou: float = 1.0,
    cost_class: float = 4.0,
) -> torch.Tensor:
    """The matched query of each sample, (B,) int64: the cost argmin, ties
    to the first index as jnp.argmin. No gradient flows through the match."""
    cost = _pair_cost(
        pred_logits, pred_spans, tgt_span[:, None, :], tgt_moment[:, None, :],
        cost_span, cost_giou, cost_class,
    )[..., 0]
    return torch.argmin(cost, dim=-1)


@torch.no_grad()
def hungarian_match(
    pred_logits: torch.Tensor,
    pred_spans: torch.Tensor,
    tgt_spans: torch.Tensor,  # (B, T, 2) cxw, padded
    tgt_moments: torch.Tensor,  # (B, T, 2) xx, padded
    tgt_mask: torch.Tensor,  # (B, T) bool
    cost_span: float = 10.0,
    cost_giou: float = 1.0,
    cost_class: float = 4.0,
) -> torch.Tensor:
    """Multi-target optimal assignment (mesm_tpu/ops/matcher.py:66-89): the
    query matched to each target, (B, T) int64, meaningful only where
    tgt_mask. Equals scipy's assignment on the unpadded per-sample costs."""
    tgt_mask = tgt_mask.bool()
    cost = _pair_cost(
        pred_logits, pred_spans, tgt_spans, tgt_moments, cost_span, cost_giou, cost_class
    )  # (B, nq, T)
    # padded targets may carry degenerate spans: keep the cost finite (the
    # solver overwrites those rows anyway)
    cost = torch.where(tgt_mask[:, None, :], cost, torch.zeros_like(cost))
    return solve_lsap_batch(cost.transpose(1, 2), tgt_mask)  # rows = targets
