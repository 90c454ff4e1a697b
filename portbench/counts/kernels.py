"""The work of the hand-written kernels' functions, whatever implements
them: operations (a multiply-add is 2, one product counted however many
the kernel's arithmetic takes) and bytes (each input read once, each
output written once), at each row's own lengths. A kernel's roofline
share is the least time for that work on the card, the larger of
operations over the peak and bytes over the memory bandwidth, over its
traced time.
"""
from __future__ import annotations

import numpy as np


def roofline_seconds(ops: float, nbytes: float, peak_ops: float, peak_bytes: float) -> float:
    return max(ops / peak_ops, nbytes / peak_bytes)


def ln_dense(n_rows: int, D: int, F: int, elem: int = 4):
    """LayerNorm over D, then Dense D -> F, over n_rows rows: (ops, bytes)."""
    ops = 2.0 * n_rows * D * F
    nbytes = elem * (n_rows * D + F * D + n_rows * F) + 4 * (2 * D + F)
    return ops, nbytes


def attention_forward(lq: np.ndarray, lk: np.ndarray, E: int, elem: int = 4):
    """Attention of rows with lq queries against lk keys each, width E over
    the heads: QK^T and PV. (ops, bytes) with q, k, v, the key mask read
    and the output written."""
    lq, lk = np.asarray(lq, float), np.asarray(lk, float)
    ops = float((4.0 * lq * lk * E).sum())
    nbytes = float((elem * (2 * lq * E + 2 * lk * E) + lk).sum())
    return ops, nbytes


def attention_backward(lq: np.ndarray, lk: np.ndarray, E: int, elem: int = 4):
    """The gradients of attention given q, k, v, its output and the output's
    gradient: QK^T again (the probabilities are no input), dP = dO V^T,
    dV = P^T dO, dQ = dS K, dK = dS^T Q. (ops, bytes) with q, k, v, out,
    dout and the mask read, dq, dk, dv written."""
    lq, lk = np.asarray(lq, float), np.asarray(lk, float)
    ops = float((10.0 * lq * lk * E).sum())
    nbytes = float((elem * (3 * lq * E + 2 * lk * E + lq * E + 2 * lk * E) + lk).sum())
    return ops, nbytes


def encoder_rows(batch: dict):
    """The DETR encoder attention's rows of one batch: per real row its
    clips and the global token as queries, and as keys."""
    rm = np.asarray(batch["row_mask"], bool)
    lv = np.asarray(batch["video_mask"], bool).sum(1)[rm]
    return lv + 1, lv + 1
