"""Prediction post-processing: timestamp clipping/rounding + temporal NMS.

Parity targets: reference utils/post_processing.py (PostProcessorDETR :5-88;
instantiated with ("clip_ts","round_multiple"), or ("clip_ts",) when
clip_len == -1 — eval.py:111-115) and utils/temporal_nms.py (:25-74, greedy
IoU suppression with the loose enclosing-interval "union"). Vectorized numpy
instead of the reference's per-line torch loops.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class SpanPostProcessor:
    def __init__(
        self,
        clip_length: float = 2,
        min_ts_val: float = 0,
        max_ts_val: float = 150,
        min_w_l: float = 2,
        max_w_l: float = 150,
        move_window_method: str = "left",
        process_func_names: Sequence[str] = ("clip_ts", "round_multiple"),
    ):
        self.clip_length = clip_length
        self.min_ts_val = min_ts_val
        self.max_ts_val = max_ts_val
        self.min_w_l = min_w_l
        self.max_w_l = max_w_l
        self.move_window_method = move_window_method
        self.process_func_names = tuple(process_func_names)

    # vectorized over all windows of all lines at once
    def process_windows(self, windows: np.ndarray) -> np.ndarray:
        for name in self.process_func_names:
            if name == "clip_ts":
                windows = np.clip(windows, self.min_ts_val, self.max_ts_val)
            elif name == "round_multiple":
                windows = np.round(windows / self.clip_length) * self.clip_length
            elif name == "clip_window_l":
                windows = self._clip_window_lengths(windows)
            else:
                raise ValueError(name)
        return windows

    def _clip_window_lengths(self, windows: np.ndarray) -> np.ndarray:
        lengths = windows[:, 1] - windows[:, 0]
        windows = self._move(windows, lengths < self.min_w_l, self.min_w_l)
        windows = self._move(windows, lengths > self.max_w_l, self.max_w_l)
        return windows

    def _move(self, windows, rows, new_len):
        if not rows.any():
            return windows
        w = windows.copy()
        if self.move_window_method == "left":
            w[rows, 1] = w[rows, 0] + new_len
        elif self.move_window_method == "right":
            w[rows, 0] = w[rows, 1] - new_len
        else:  # center
            c = (w[rows, 0] + w[rows, 1]) / 2
            w[rows, 0] = c - new_len / 2
            w[rows, 1] = c + new_len / 2
        return w

    def __call__(self, lines: List[dict]) -> List[dict]:
        if not lines:
            return lines
        counts = [len(l["pred_relevant_windows"]) for l in lines]
        flat = np.asarray(
            [w for l in lines for w in l["pred_relevant_windows"]], dtype=float
        )
        windows = self.process_windows(flat[:, :2])
        scores = flat[:, 2]
        off = 0
        for line, n in zip(lines, counts):
            rows = []
            for i in range(off, off + n):
                rows.append(
                    [float(windows[i, 0]), float(windows[i, 1]), float(f"{scores[i]:.4f}")]
                )
            line["pred_relevant_windows"] = rows
            off += n
        return lines


def _loose_iou(a, b) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union else 0.0


def temporal_nms(predictions: List[list], nms_thd: float, max_after_nms: int = 100):
    """Greedy suppression of overlapping lower-score spans
    (reference utils/temporal_nms.py:25-74)."""
    if len(predictions) == 1:
        return predictions
    pool = sorted(predictions, key=lambda x: x[2], reverse=True)
    kept: List[list] = []
    while pool and len(kept) < max_after_nms:
        best = pool.pop(0)
        kept.append(best)
        pool = [p for p in pool if _loose_iou(best[:2], p[:2]) <= nms_thd]
    return kept


def apply_nms(submission: List[dict], nms_thd: float, max_before_nms: int, max_after_nms: int):
    """reference eval.py:476-485."""
    out = []
    for e in submission:
        e["pred_relevant_windows"] = temporal_nms(
            e["pred_relevant_windows"][:max_before_nms],
            nms_thd=nms_thd,
            max_after_nms=max_after_nms,
        )
        out.append(e)
    return out
