"""Seeded synthetic batches and the configurations of the port's main
paths, shared by the profile drivers (scripts/profile_eval.py,
scripts/profile_train.py) and chip_smoke.py.

- charades C+SF_C (config/charades/C+SF_C.json) at full width and depth,
  cached 512-d text features, the bench geometry of bench.py:740-742:
  eval batches of B = 128 rows over NG = 53 unique 194-clip videos;
- TACoS C3D_GloVe (config/TACoS/C3D_GloVe.json) at full width and depth:
  the TwoMLP enhance encoder, 4096 + 2 TEF video channels, 300-d GloVe
  text, the kernel-engaged train geometry of bench.py:780-795 (B = 16,
  Lv = 600).

Features are draws of a torch.Generator on the batch's device seeded by
`seed`, so one seed gives one batch on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.mesm import MESMConfig

TACOS = dict(B=16, Lv=600, Dv=4098, Lw=16, Dt=300, L=601, E=256, H=8)
# criterion weights (config/TACoS/C3D_GloVe.json, config/charades/C+SF_C.json)
TACOS_CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=6.0, saliency_coef=1.0,
                       recfw_coef=0.1, recss_coef=0.1, cost_span=10.0, cost_giou=1.0,
                       cost_class=6.0, rank_coef=1.0, use_triplet=True)
CHARADES_CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=4.0,
                          recfw_coef=0.1, recss_coef=0.1, cost_span=10.0, cost_giou=1.0,
                          cost_class=4.0, rank_coef=12.0)


def charades_config(**overrides) -> MESMConfig:
    return MESMConfig(**dict(dict(
        hidden_dim=256, v_feat_dim=2818, t_feat_dim=512, nheads=8, dim_feedforward=1024,
        num_recfw_layers=2, t2v_layers=2, enc_layers=2, dec_layers=2, num_recss_layers=4,
        num_queries=10, max_words_l=16, max_video_l=194, num_classes=1114,
    ), **overrides))


def tacos_config(dropout: float = 0.1, **overrides) -> MESMConfig:
    return MESMConfig(**dict(dict(
        hidden_dim=256, v_feat_dim=TACOS["Dv"], t_feat_dim=TACOS["Dt"], nheads=8,
        dim_feedforward=1024, num_recfw_layers=2, t2v_layers=2, enc_layers=2, dec_layers=2,
        num_recss_layers=4, num_queries=10, max_words_l=TACOS["Lw"], max_video_l=TACOS["Lv"],
        num_classes=1112, share_mlp=False, dropout=dropout,
    ), **overrides))


def encode_cached(batch):
    """The text encoding of a synthetic batch: its cached features."""
    if "cached_words_feat" in batch:
        return batch["cached_words_feat"], batch["cached_words_mask"], batch["cached_sentence_feat"]
    return batch["words_feat"], batch["words_mask"], batch["sentence_feat"]


def make_eval_batch(seed: int, B=128, NG=53, Lv=194, Dv=2818, Lw=16, Dt=512, min_words=3,
                    device="cuda", G=None):
    """A collated eval batch (deduplicated videos, cached text) on `device`:
    NG unique videos (~2.4 sentences each, as real charades eval batches),
    one row per sentence, features from a seed. The SS-MESM group width is
    the largest group's, or `G` (batches of one shape, as the collate's
    group capacity gives them)."""
    rng = np.random.default_rng(seed)
    counts = 1 + rng.multinomial(B - NG, np.full(NG, 1.0 / NG))
    group_id = np.repeat(np.arange(NG), counts)
    g_len = rng.integers(Lv // 4, Lv + 1, NG)
    g_len[0] = Lv
    mask_g = np.arange(Lv)[None] < g_len[:, None]
    w_len = rng.integers(min_words, Lw + 1, B)
    words_mask = np.arange(Lw)[None] < w_len[:, None]
    if G is None:
        G = int(counts.max())
    elif counts.max() > G:
        raise ValueError(f"make_eval_batch: a group of {counts.max()} rows exceeds G = {G}")
    ss_idx = np.zeros((B, G), np.int64)
    ss_mask = np.zeros((B, G), bool)
    own = np.zeros(B, np.int64)
    for i in range(B):
        rows = np.flatnonzero(group_id == group_id[i])
        ss_idx[i, : len(rows)] = rows
        ss_idx[i, len(rows):] = i
        ss_mask[i, : len(rows)] = True
        own[i] = int(np.flatnonzero(rows == i)[0])
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    mg, wm = t(mask_g), t(words_mask)
    return {
        "video_feat_g": torch.randn(NG, Lv, Dv, generator=g, device=dev) * mg[..., None],
        "video_mask_g": mg,
        "video_slot": t(group_id.astype(np.int64)),
        "video_mask": mg[t(group_id)],
        "cached_words_feat": 0.1 * torch.randn(B, Lw, Dt, generator=g, device=dev) * wm[..., None],
        "cached_words_mask": wm,
        "cached_sentence_feat": 0.1 * torch.randn(B, Dt, generator=g, device=dev),
        "ss_sent_idx": t(ss_idx), "ss_sent_mask": t(ss_mask), "ss_own_pos": t(own),
        "group_id": t(group_id),
    }


def make_train_batch(seed: int, B: int, Lv: int, Dv: int, Lw: int, Dt: int, num_classes: int,
                     G: int = 3, device="cuda") -> dict:
    """A collated train batch on `device`: ~2.4 sentences per video (the
    groups the out-of-group negatives need), each row's video replicated as
    the train collate does, GT spans inside the video, MLM labels and word
    weights, the saliency triplet's clip indices, features from a seed."""
    rng = np.random.default_rng(seed)
    n_groups = max(2, int(B / 2.4))
    group_id = np.sort(rng.integers(0, n_groups, B))
    group_id[0], group_id[-1] = 0, n_groups - 1
    g_len = rng.integers(Lv // 2, Lv + 1, n_groups)
    vid_len = g_len[group_id]
    video_mask = np.arange(Lv)[None] < vid_len[:, None]
    w_len = rng.integers(3, Lw + 1, B)
    words_mask = np.arange(Lw)[None] < w_len[:, None]
    st = rng.integers(1, np.maximum(vid_len // 2, 2))
    ed = np.minimum(st + rng.integers(1, np.maximum(vid_len // 2, 2)), vid_len - 1)
    clip_mask = (np.arange(Lv)[None] >= st[:, None]) & (np.arange(Lv)[None] <= ed[:, None])
    norm_moment = np.stack([st / vid_len, (ed + 1) / vid_len], -1).astype(np.float32)
    norm_span = np.stack([norm_moment.mean(-1), norm_moment[:, 1] - norm_moment[:, 0]], -1)
    ss_idx, ss_mask, own = np.zeros((B, G), np.int64), np.zeros((B, G), bool), np.zeros(B, np.int64)
    for i in range(B):
        rows = np.flatnonzero(group_id == group_id[i])
        if len(rows) > G:  # a window of G rows of the group holding row i
            pos = int(np.flatnonzero(rows == i)[0])
            start = min(max(pos - G + 1, 0), len(rows) - G)
            rows = rows[start:start + G]
        ss_idx[i, : len(rows)], ss_idx[i, len(rows):] = rows, i
        ss_mask[i, : len(rows)] = True
        own[i] = int(np.flatnonzero(rows == i)[0])
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    vm, wm = t(video_mask), t(words_mask)
    feat_g = torch.randn(n_groups, Lv, Dv, generator=g, device=dev)
    return {
        "video_feat": feat_g[t(group_id)] * vm[..., None],
        "video_mask": vm,
        "words_feat": 0.1 * torch.randn(B, Lw, Dt, generator=g, device=dev) * wm[..., None],
        "words_mask": wm,
        "sentence_feat": 0.1 * torch.randn(B, Dt, generator=g, device=dev),
        "words_weight": t(rng.integers(1, 3, (B, Lw)).astype(np.float32) * words_mask),
        "unknown_mask": t((rng.random((B, Lw)) < 0.1) & words_mask),
        "words_label": t(rng.integers(0, num_classes, (B, Lw)) * words_mask),
        "clip_mask": t(clip_mask), "group_id": t(group_id), "row_mask": t(np.ones(B, bool)),
        "norm_moment": t(norm_moment), "norm_span": t(norm_span.astype(np.float32)),
        "pos_idx": t(np.stack([st, ed], -1)), "neg_idx": t(np.stack([st - 1, ed], -1)),
        "ss_sent_idx": t(ss_idx), "ss_sent_mask": t(ss_mask), "ss_own_pos": t(own),
    }
