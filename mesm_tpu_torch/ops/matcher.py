"""DETR-style set matching for moment retrieval, on the device.

Parity target: mesm_tpu/ops/matcher.py:24-64 and the reference
model/matcher.py (HungarianMatcher). Cost = cost_span * L1(cxw)
+ cost_giou * (-gIoU(xx)) + cost_class * (-P(fg)), foreground is class 0.

Only the single-target regime (charades, TACoS, charades-cg/cd) is ported:
every sample has one target, so the per-sample assignment is the cost
argmin over queries. The multi-target Hungarian solver of qvhighlights
(mesm_tpu/ops/lsap.py, `hungarian_match`) waits for the qvhighlights slice.
"""
from __future__ import annotations

import torch

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
