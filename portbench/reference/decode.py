"""The plain reference of the eval's decode and post-processing (lntzm/MESM
eval.py compute_mr_results and utils/post_processing.py PostProcessorDETR):
each row's windows are its queries' (center, width) spans as (start, end)
times the video's duration, with the foreground probability as the score,
ranked by score (ties keep the query order) where sort_results, each value
rounded to 4 decimals; then clipped to [0, max_ts_val] and, where the clip
length is set, rounded to multiples of it; the saliency is the row's score
at each valid clip.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def decode_rows(scores: np.ndarray, spans: np.ndarray, saliency: np.ndarray,
                valid_len: np.ndarray, meta: dict, clip_len: float, max_ts_val: float,
                sort_results: bool) -> List[Dict]:
    """scores (n, nq), spans (n, nq, 2) (center, width), saliency (n, L),
    all float32, of the batch's n real rows."""
    scores, spans, saliency = (np.asarray(a, np.float32) for a in (scores, spans, saliency))
    xx = np.stack([spans[..., 0] - 0.5 * spans[..., 1], spans[..., 0] + 0.5 * spans[..., 1]], -1)
    rows = []
    for i in range(scores.shape[0]):
        ranked = np.concatenate([xx[i] * meta["duration"][i], scores[i][:, None]], 1).tolist()
        if sort_results:
            ranked = sorted(ranked, key=lambda r: r[2], reverse=True)
        ranked = [[float(f"{v:.4f}") for v in r] for r in ranked]
        w = np.clip(np.asarray([r[:2] for r in ranked], dtype=float), 0, max_ts_val)
        if clip_len != -1:
            w = np.round(w / clip_len) * clip_len
        rows.append(dict(
            qid=meta["qid"][i], query=meta["sentence"][i], vid=meta["video_id"][i],
            pred_relevant_windows=[[float(w[j, 0]), float(w[j, 1]), float(f"{r[2]:.4f}")]
                                   for j, r in enumerate(ranked)],
            pred_saliency_scores=saliency[i, : int(valid_len[i])].tolist(),
        ))
    return rows
