"""Temporal-span geometry on tensors, with numpy mirrors for host-side eval.

Behavioral parity targets: reference utils/span_utils.py (span_xx_to_cxw :5,
span_cxw_to_xx :26, temporal_iou :45, generalized_temporal_iou :92,
compute_temporal_iou_batch_cross :124) and utils/data_utils.py
(compute_temporal_iou_batch_paired :185).

All tensor functions are shape-polymorphic over leading dims.
"""
from __future__ import annotations

import numpy as np
import torch


def span_xx_to_cxw(xx_spans: torch.Tensor) -> torch.Tensor:
    """(start, end) -> (center, width) over the trailing dim of size 2.

    >>> span_xx_to_cxw(torch.tensor([[0., 1.], [0.2, 0.4]]))
    tensor([[0.5000, 1.0000],
            [0.3000, 0.2000]])
    """
    center = xx_spans.sum(-1) * 0.5
    width = xx_spans[..., 1] - xx_spans[..., 0]
    return torch.stack([center, width], dim=-1)


def span_cxw_to_xx(cxw_spans: torch.Tensor) -> torch.Tensor:
    """(center, width) -> (start, end) over the trailing dim of size 2."""
    x1 = cxw_spans[..., 0] - 0.5 * cxw_spans[..., 1]
    x2 = cxw_spans[..., 0] + 0.5 * cxw_spans[..., 1]
    return torch.stack([x1, x2], dim=-1)


def temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor):
    """Cross IoU between two xx-format span sets, (..., N, 2) x (..., M, 2)
    -> (iou, union), each (..., N, M).

    Golden (reference utils/span_utils.py:54-60):
      spans1=[[0,.2],[.5,1.]], spans2=[[0,.3],[0,1.]]
      iou = [[0.6667, 0.2], [0.0, 0.5]]
    """
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    left = torch.maximum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.minimum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    inter = torch.clamp(right - left, min=0)
    union = areas1[..., :, None] + areas2[..., None, :] - inter
    return inter / union, union


def generalized_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """Cross generalized IoU (gIoU), (..., N, 2) x (..., M, 2) -> (..., N, M).

    Golden (reference utils/span_utils.py:105-109):
      spans1=[[0,.2],[.5,1.]], spans2=[[0,.3],[0,1.]]
      giou = [[0.6667, 0.2], [-0.2, 0.5]]
    """
    iou, union = temporal_iou(spans1, spans2)
    left = torch.minimum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.maximum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    enclosing_area = torch.clamp(right - left, min=0)
    return iou - (enclosing_area - union) / enclosing_area


def pairwise_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """Element-wise IoU between aligned spans: (..., 2) x (..., 2) -> (...)."""
    left = torch.maximum(spans1[..., 0], spans2[..., 0])
    right = torch.minimum(spans1[..., 1], spans2[..., 1])
    inter = torch.clamp(right - left, min=0)
    union = (spans1[..., 1] - spans1[..., 0]) + (spans2[..., 1] - spans2[..., 0]) - inter
    return inter / union


def pairwise_generalized_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """Element-wise gIoU between aligned spans: (..., 2) x (..., 2) -> (...),
    the diagonal of generalized_temporal_iou without the N x N matrix."""
    left_i = torch.maximum(spans1[..., 0], spans2[..., 0])
    right_i = torch.minimum(spans1[..., 1], spans2[..., 1])
    inter = torch.clamp(right_i - left_i, min=0)
    union = (spans1[..., 1] - spans1[..., 0]) + (spans2[..., 1] - spans2[..., 0]) - inter
    iou = inter / union
    left_e = torch.minimum(spans1[..., 0], spans2[..., 0])
    right_e = torch.maximum(spans1[..., 1], spans2[..., 1])
    enclosing = torch.clamp(right_e - left_e, min=0)
    return iou - (enclosing - union) / enclosing


# ---------------------------------------------------------------------------
# Host-side numpy mirrors (used by the eval metric suite, which runs on host).
# ---------------------------------------------------------------------------


def np_temporal_iou_cross(spans1: np.ndarray, spans2: np.ndarray):
    """Cross IoU, numpy. Reference utils/span_utils.py:124-151."""
    areas1 = spans1[:, 1] - spans1[:, 0]
    areas2 = spans2[:, 1] - spans2[:, 0]
    left = np.maximum(spans1[:, None, 0], spans2[None, :, 0])
    right = np.minimum(spans1[:, None, 1], spans2[None, :, 1])
    inter = np.clip(right - left, 0, None)
    union = areas1[:, None] + areas2[None, :] - inter
    iou = inter / union
    return iou, union


def np_temporal_iou_paired(pred_windows: np.ndarray, gt_windows: np.ndarray):
    """Paired IoU with the reference's *intentionally loose* union (it uses the
    enclosing interval as "union"). Reference utils/data_utils.py:185-201 —
    kept bit-identical because R1 metrics depend on it.
    """
    intersection = np.maximum(
        0,
        np.minimum(pred_windows[:, 1], gt_windows[:, 1])
        - np.maximum(pred_windows[:, 0], gt_windows[:, 0]),
    )
    union = np.maximum(pred_windows[:, 1], gt_windows[:, 1]) - np.minimum(
        pred_windows[:, 0], gt_windows[:, 0]
    )
    return np.divide(
        intersection, union, out=np.zeros_like(intersection), where=union != 0
    )


def get_window_len(window) -> float:
    return window[1] - window[0]
