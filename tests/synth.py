"""Synthetic fixed-shape batches for model/criterion tests.

Mirrors the collate output layout (see mesm_tpu/data/collate.py): one row per
sentence, group_id marks sentences of the same video, videos replicated per
row.
"""
from __future__ import annotations

import numpy as np


def make_batch(
    rng: np.random.Generator,
    B: int = 6,
    Lv: int = 24,
    Dv: int = 32,
    Lw: int = 12,
    Dt: int = 20,
    G: int = 3,
    T: int = 0,  # 0 -> single-target batch; >0 -> multi-target (qvh-style)
    vocab_classes: int = 50,
    n_groups: int = 3,
):
    group_id = np.sort(rng.integers(0, n_groups, B)).astype(np.int32)
    # ensure at least 2 distinct groups (negative sampling requirement)
    group_id[0] = 0
    group_id[-1] = n_groups - 1

    # rows of one group share one video (mirrors the collate: a group = the
    # sentences of a single video, its features replicated per row)
    g_len = rng.integers(Lv // 2, Lv + 1, n_groups)
    g_mask = np.arange(Lv)[None] < g_len[:, None]
    g_feat = rng.normal(size=(n_groups, Lv, Dv)).astype(np.float32) * g_mask[..., None]
    vid_len = g_len[group_id]
    video_mask = g_mask[group_id]
    video_feat = g_feat[group_id]

    w_len = rng.integers(3, Lw + 1, B)
    words_mask = (np.arange(Lw)[None] < w_len[:, None])
    words_feat = rng.normal(size=(B, Lw, Dt)).astype(np.float32) * words_mask[..., None]
    sentence_feat = rng.normal(size=(B, Dt)).astype(np.float32)
    words_weight = rng.integers(1, 3, (B, Lw)).astype(np.float32) * words_mask
    unknown_mask = (rng.random((B, Lw)) < 0.1) & words_mask
    words_label = rng.integers(0, vocab_classes, (B, Lw)).astype(np.int32) * words_mask

    # GT spans within valid video
    st = rng.integers(0, np.maximum(vid_len // 2, 1))
    ed = np.minimum(st + rng.integers(1, np.maximum(vid_len // 2, 2)), vid_len - 1)
    clip_mask = (np.arange(Lv)[None] >= st[:, None]) & (np.arange(Lv)[None] <= ed[:, None])
    clip_mask &= video_mask

    norm_moment = np.stack([st / vid_len, (ed + 1) / vid_len], -1).astype(np.float32)
    center = norm_moment.mean(-1)
    width = norm_moment[:, 1] - norm_moment[:, 0]
    norm_span = np.stack([center, width], -1).astype(np.float32)

    pos_idx = np.stack([st, ed], -1).astype(np.int32)
    neg_pool_ok = st > 0
    neg_idx = np.stack([np.where(neg_pool_ok, st - 1, ed), np.zeros_like(st)], -1).astype(np.int32)

    # ss gather structures: rows of the same group, padded with self
    ss_sent_idx = np.zeros((B, G), np.int32)
    ss_sent_mask = np.zeros((B, G), bool)
    ss_own_pos = np.zeros((B,), np.int32)
    for i in range(B):
        rows = np.where(group_id == group_id[i])[0]
        if len(rows) > G:  # keep a window of G rows containing i
            pos = int(np.where(rows == i)[0][0])
            start = min(max(pos - G + 1, 0), len(rows) - G)
            rows = rows[start : start + G]
        ss_sent_idx[i, : len(rows)] = rows
        ss_sent_idx[i, len(rows):] = i
        ss_sent_mask[i, : len(rows)] = True
        ss_own_pos[i] = int(np.where(rows == i)[0][0])

    batch = dict(
        video_feat=video_feat,
        video_mask=video_mask,
        # deduplicated-video variants (drop video_feat and keep these to
        # exercise the eval dedup path)
        video_feat_g=g_feat,
        video_mask_g=g_mask,
        video_slot=group_id.astype(np.int32),
        words_feat=words_feat,
        words_mask=words_mask,
        sentence_feat=sentence_feat,
        words_weight=words_weight,
        unknown_mask=unknown_mask,
        words_label=words_label,
        clip_mask=clip_mask,
        group_id=group_id,
        norm_moment=norm_moment,
        norm_span=norm_span,
        pos_idx=pos_idx,
        neg_idx=neg_idx,
        ss_sent_idx=ss_sent_idx,
        ss_sent_mask=ss_sent_mask,
        ss_own_pos=ss_own_pos,
    )

    if T > 0:  # multi-target (qvh-style): fabricate up to T windows per row
        n_tgt = rng.integers(1, T + 1, B)
        tgt_mask = np.arange(T)[None] < n_tgt[:, None]
        ctr = rng.uniform(0.2, 0.8, (B, T)).astype(np.float32)
        wid = rng.uniform(0.05, 0.3, (B, T)).astype(np.float32)
        norm_span_m = np.stack([ctr, wid], -1)
        norm_moment_m = np.stack([ctr - wid / 2, ctr + wid / 2], -1)
        batch["norm_span"] = norm_span_m.astype(np.float32)
        batch["norm_moment"] = norm_moment_m.astype(np.float32)
        batch["tgt_mask"] = tgt_mask
        batch["saliency_label"] = (
            clip_mask.astype(np.float32) * rng.integers(0, 13, (B, Lv))
        ).astype(np.float32)

    return batch


def sample_neg_rows(rng: np.random.Generator, group_id: np.ndarray) -> np.ndarray:
    B = len(group_id)
    out = np.zeros(B, np.int32)
    for i in range(B):
        cand = np.where(group_id != group_id[i])[0]
        out[i] = rng.choice(cand) if len(cand) else (i + 1) % B
    return out


def per_video_layout(batch: dict) -> dict:
    """A per-row batch of make_batch (rows of one group share one video) in
    the layout the train collate gives with --dedup_video on: each group's
    video once (`video_feat_g`, `video_mask_g`), the rows' `video_slot`, no
    `video_feat`."""
    out = {k: v for k, v in batch.items()
           if k not in ("video_feat", "video_feat_g", "video_mask_g", "video_slot")}
    gid = np.asarray(batch["group_id"])
    groups, first = np.unique(gid, return_index=True)
    out["video_feat_g"] = np.ascontiguousarray(batch["video_feat"][first])
    out["video_mask_g"] = np.ascontiguousarray(batch["video_mask"][first])
    out["video_slot"] = np.searchsorted(groups, gid).astype(np.int32)
    assert np.array_equal(out["video_feat_g"][out["video_slot"]], batch["video_feat"])
    return out
