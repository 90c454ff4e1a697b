"""The model's operations: the multiply-adds of every matrix product of
MESM's eval forward and of its training step, counted from the sizes of
each row (2 operations a multiply-add).

Lengths are the row's own: its valid clips Lv, its valid words Lw (and
Lw + 1 where SS-MESM prepends its token), the valid sentences of its SS-MESM
group G; a batch's padded rows count nothing. Every attention counts its
queries against its keys as the model lays them out (the DETR encoder's
keys include the global token, which the mask then hides). A unique video
of an eval batch is projected once; in training every row projects its own
video twice (the main projection and SS-MESM's). The training step counts
the forward (with the negative pass and the MLM branch) and a backward of
two products for each of the forward's. (Every projection of raw features
starts with a LayerNorm whose parameters train, so its input takes a
gradient too; the few small products whose input needs none, as the
decoder's first layer reading zeros, count as the rest.) The MLM keys are
the row's clips, where the model lays its GT clips out over them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _mm(m, k, n):
    return 2.0 * m * k * n


def _t2v_layer(d, F, Lq, Lk):
    """One T2V / encoder-style layer: q from Lq rows, k and v from Lk rows,
    attention, out-projection and the FFN on the Lq rows."""
    return (_mm(Lq, d, d) + 2 * _mm(Lk, d, d) + 2 * _mm(Lq, Lk, d) + _mm(Lq, d, d)
            + _mm(Lq, d, F) + _mm(Lq, F, d))


def _proj(n, i, d, layers):
    return _mm(n, i, d) + (layers - 1) * _mm(n, d, d)


def _decoder(c, Lv):
    d, F, nq = c["hidden_dim"], c["dim_feedforward"], c["num_queries"]
    total = 0.0
    for i in range(c["dec_layers"]):
        total += _mm(nq, d, d) * 2  # ref_point_head
        if i:
            total += _mm(nq, d, d) * 2  # query_scale
        total += _mm(nq, d, d) + _mm(nq, d, 1)  # ref_anchor_head
        total += 5 * _mm(nq, d, d) + 2 * _mm(nq, nq, d) + _mm(nq, d, d)  # self-attention
        total += 2 * _mm(nq, d, d) + 3 * _mm(Lv, d, d) + (_mm(nq, d, d) if i == 0 else 0)
        total += 3 * _mm(nq, Lv, d) + _mm(nq, d, d)  # cross-attention, two dot products
        total += _mm(nq, d, F) + _mm(nq, F, d)
        total += 2 * _mm(nq, d, d) + _mm(nq, d, 2)  # bbox_embed
    return total


def _heads(c, Lv):
    d, nq, L = c["hidden_dim"], c["num_queries"], c["dec_layers"]
    return (L * (_mm(nq, d, 2) + 2 * _mm(nq, d, d) + _mm(nq, d, 2))
            + _mm(Lv, d, d) + _mm(1, d, d))


def row_forward(c: dict, Lv: int, Lw: int, G: int, Lw_neg: int = -1) -> Dict[str, float]:
    """One row's forward without its video projection. Lw_neg >= 0 adds the
    negative pass (training) with a negative text of Lw_neg words."""
    d, F = c["hidden_dim"], c["dim_feedforward"]
    n_in = c["n_input_proj"]
    out = {}
    out["text_proj"] = _proj(Lw, c["t_feat_dim"], d, n_in)
    Lt = Lw
    if c["rec_ss"]:
        out["ss_text_proj"] = _proj(G, c["t_feat_dim"], d, n_in)
        out["ss_recon"] = (c["num_recss_layers"] * _t2v_layer(d, F, G, Lv) + 2 * _mm(1, d, d))
        Lt = Lw + 1
    passes = [(Lw, Lt)] + ([(Lw_neg, Lw_neg + 1 if c["rec_ss"] else Lw_neg)]
                           if Lw_neg >= 0 else [])
    out["enhance"] = out["t2v"] = out["detr_encoder"] = out["decoder"] = 0.0
    for lw, lt in passes:
        if c["rec_fw"]:
            out["enhance"] += c["num_recfw_layers"] * _t2v_layer(d, F, Lv, lw)
        out["t2v"] += c["t2v_layers"] * _t2v_layer(d, F, Lv, lt)
        out["detr_encoder"] += c["enc_layers"] * _t2v_layer(d, F, Lv + 1, Lv + 1)
        out["decoder"] += _decoder(c, Lv)
    # the span and class heads read the positive pass, the saliency both
    out["heads"] = _heads(c, Lv) + (len(passes) - 1) * (_mm(Lv, d, d) + _mm(1, d, d))
    return out


def video_proj(c: dict, Lv: int) -> float:
    return _proj(Lv, c["v_feat_dim"], c["hidden_dim"], c["n_input_proj"])


def mlm(c: dict, Lw: int, Lv: int) -> float:
    """The MLM branch of one row: the enhance stack with the words as
    queries against the row's clips, the output projection over the
    classes."""
    d, F = c["hidden_dim"], c["dim_feedforward"]
    return (c["num_recfw_layers"] * _t2v_layer(d, F, Lw, Lv)
            + _mm(Lw, d, d) + _mm(Lw, d, c["num_classes"]))


def _lengths(batch: dict):
    rm = np.asarray(batch["row_mask"], bool)
    lv = np.asarray(batch["video_mask"], bool).sum(1)
    lw = np.asarray(batch["cached_words_mask"], bool).sum(1)
    g = np.asarray(batch["ss_sent_mask"], bool).sum(1)
    return rm, lv, lw, g


def eval_batch(c: dict, batch: dict) -> float:
    """The eval forward of one collated batch: its real rows, each unique
    video projected once."""
    rm, lv, lw, g = _lengths(batch)
    total = 0.0
    for r in np.flatnonzero(rm):
        total += sum(row_forward(c, int(lv[r]), int(lw[r]), int(g[r])).values())
    if "video_mask_g" in batch:
        slots = {int(s) for s in np.asarray(batch["video_slot"])[rm]}
        lg = np.asarray(batch["video_mask_g"], bool).sum(1)
        total += sum(video_proj(c, int(lg[s])) for s in slots)
    else:
        total += sum(video_proj(c, int(lv[r])) for r in np.flatnonzero(rm))
    return total


def train_batch(c: dict, batch: dict, neg_rows=None) -> float:
    """The training step of one collated batch: forward and backward over
    its real rows. `neg_rows` (B,) gives each row's negative row (its text
    enters the negative pass); where None, the negative text is taken as
    long as the row's own."""
    rm, lv, lw, g = _lengths(batch)
    d = c["hidden_dim"]
    fwd = 0.0
    for r in np.flatnonzero(rm):
        neg = int(lw[r] if neg_rows is None else lw[int(neg_rows[r])])
        fwd += sum(row_forward(c, int(lv[r]), int(lw[r]), int(g[r]), Lw_neg=neg).values())
        fwd += 2 * video_proj(c, int(lv[r]))
        if c["rec_fw"]:
            fwd += mlm(c, int(lw[r]), int(lv[r]))
    if c["rec_fw"]:  # the unknown and mask tokens' projections, once a batch
        fwd += 2 * _proj(1, c["t_feat_dim"], d, c["n_input_proj"])
    n = int(rm.sum())
    fwd += _mm(n, d, n) if c["rec_ss"] else 0.0  # SS-MESM's InfoNCE similarities
    return 3 * fwd
