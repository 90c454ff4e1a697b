"""Fixed-shape batch assembly (the TPU replacement for ragged collation).

The reference collates ragged batches: one row per sentence with
max-in-batch padding everywhere (reference dataset/base.py:288-355,
dataset/qvhighlights.py:214-284), so every batch has a different shape.
Here every batch has ONE static shape so the train/eval steps compile once:

  - rows padded to `row_capacity` (padding duplicates row 0, masked out by
    `row_mask`; the criterion's masked means reproduce unpadded semantics),
  - video padded to the `max_video_l` bucket, words to the tokenizer width,
  - targets padded to `max_windows` with `tgt_mask` (multi-clip only),
  - the ragged "my group's sentences" structure becomes `ss_sent_idx` /
    `ss_sent_mask` / `ss_own_pos` gather indices (consumed by SS-MESM),
  - qvhighlights' per-group concatenated video for SS-MESM is stored once per
    group (`ss_video_feat_groups`) with a per-row slot index, instead of
    replicated per row,
  - with `video_groups_cap` (--dedup_video) each video is stored once per
    entry (`video_feat_g`, `video_mask_g`) with the rows' `video_slot`:
    padded to the cap at eval, exactly the batch's entries in training.

`prepare_batch_input` parity (reference dataset/base.py:358-385): norm_moment
(xx) = moment / duration and norm_span (cxw) are computed here on host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class BatchSpec:
    row_capacity: int
    max_video_l: int
    group_capacity: int
    multi_clip: bool = False
    max_windows: int = 5
    ss_video_l: int = 0  # >0: per-group concatenated video length (qvh)
    contra_pairs: int = 2  # columns in pos_idx/neg_idx
    recfw: bool = True
    with_targets: bool = True
    # Length buckets (ascending, last == max_video_l). When set, each batch is
    # padded to the smallest bucket that fits its longest video instead of
    # always max_video_l — the jitted eval step specializes once per bucket
    # (a handful of compiles) and short batches skip most of the padded
    # compute. Empty = single fixed bucket (training default: one compile).
    video_buckets: Tuple[int, ...] = ()
    # >0: emit each video ONCE (`video_feat_g` (cap, Lv, Dv) + per-row
    # `video_slot`) instead of replicating it per sentence row. The model
    # projects unique videos and gathers rows after the (2818-wide, HBM-bound)
    # input projection — a measured eval hot spot. Batches must contain at
    # most this many videos (the eval batcher enforces it). Only used when
    # every entry shares one video array across its rows (charades family).
    video_groups_cap: int = 0
    # with video_groups_cap: `video_feat_g` holds exactly the batch's videos
    # (one per entry, no padding slots), so its first dim varies from batch
    # to batch. The eager train step stages these and builds the rows on the
    # device (parallel/step.expand_video_rows); eval's graphs need the cap.
    video_groups_exact: bool = False


def _norm_xx_to_cxw(xx: np.ndarray) -> np.ndarray:
    return np.stack([xx.sum(-1) * 0.5, xx[..., 1] - xx[..., 0]], axis=-1)


def make_collate(spec: BatchSpec) -> "Collate":
    return Collate(spec)


class Collate:
    """Picklable fixed-shape collate. Loader process-pool workers receive
    the collate by pickle (forkserver/spawn contexts), so it must be a
    module-level class holding only the BatchSpec — a closure would not
    survive the trip."""

    def __init__(self, spec: BatchSpec):
        self.spec = spec

    def __call__(self, entries: List[Dict]) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
        return _collate(self.spec, entries)


def _collate(spec: BatchSpec, entries: List[Dict]) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
    R = spec.row_capacity
    Lv = spec.max_video_l
    if spec.video_buckets:
        vmax = 1
        for e in entries:
            feats = e["video_feat"] if isinstance(e["video_feat"], list) else [e["video_feat"]]
            vmax = max(vmax, max(f.shape[0] for f in feats))
        vmax = min(vmax, spec.max_video_l)
        Lv = next(b for b in spec.video_buckets if b >= vmax)
    G = spec.group_capacity

    rows: List[Dict] = []
    meta = {"qid": [], "video_id": [], "sentence": [], "duration": []}
    group_row_lists: List[List[int]] = []
    ss_groups: List[Tuple[np.ndarray, np.ndarray]] = []  # qvh per-group video

    for g, e in enumerate(entries):
        n = e["num_clips"]
        base = len(rows)
        group_row_lists.append(list(range(base, base + n)))
        if spec.ss_video_l > 0:
            # concatenate the group's valid frames once (qvh SS path)
            feats = e["video_feat"] if isinstance(e["video_feat"], list) else [e["video_feat"]] * n
            cat = np.concatenate([f for f in feats], axis=0)[: spec.ss_video_l]
            ss_groups.append(cat)
        for i in range(n):
            row = {"group": g, "entry": e, "i": i}
            rows.append(row)
            meta["qid"].append(e["qid"][i] if isinstance(e["qid"], list) else e["qid"])
            vid = e["video_id"][i] if isinstance(e["video_id"], list) else e["video_id"]
            meta["video_id"].append(vid)
            meta["sentence"].append(e["sentence"][i])
            dur = e["duration"][i] if isinstance(e["duration"], list) else e["duration"]
            meta["duration"].append(float(dur))

    n_real = len(rows)
    if n_real > R:
        raise ValueError(f"batch has {n_real} rows > capacity {R}")
    meta["n_rows"] = n_real

    first = rows[0]["entry"]
    words_id0 = first["words_id"]
    words_is_feat = words_id0.ndim == 3
    Lw = words_id0.shape[1]
    Dw = words_id0.shape[2] if words_is_feat else None
    feat0 = first["video_feat"][0] if isinstance(first["video_feat"], list) else first["video_feat"]
    Dv = feat0.shape[1]

    dedup = spec.video_groups_cap > 0 and all(
        not isinstance(e["video_feat"], list) for e in entries
    )
    batch: Dict[str, np.ndarray] = {}
    if dedup:
        NGc = len(entries) if spec.video_groups_exact else spec.video_groups_cap
        if len(entries) > NGc:
            raise ValueError(f"batch has {len(entries)} videos > cap {NGc}")
        batch["video_feat_g"] = np.zeros((NGc, Lv, Dv), np.float32)
        batch["video_mask_g"] = np.zeros((NGc, Lv), bool)
        batch["video_slot"] = np.zeros((R,), np.int32)
        for g, e in enumerate(entries):
            feat = e["video_feat"]
            L = min(feat.shape[0], Lv)
            batch["video_feat_g"][g, :L] = feat[:L]
            batch["video_mask_g"][g, :L] = True
    else:
        batch["video_feat"] = np.zeros((R, Lv, Dv), np.float32)
    batch["video_mask"] = np.zeros((R, Lv), bool)
    if words_is_feat:
        batch["words_id"] = np.zeros((R, Lw, Dw), np.float32)
    else:
        batch["words_id"] = np.zeros((R, Lw), np.int64)
    ww = first["words_weight"]
    batch["words_weight"] = np.zeros((R, ww.shape[1]), np.float32)
    if spec.recfw and first.get("unknown_mask") is not None:
        batch["unknown_mask"] = np.zeros((R, ww.shape[1]), bool)
        batch["words_label"] = np.zeros((R, ww.shape[1]), np.int64)
    batch["clip_mask"] = np.zeros((R, Lv), bool)
    batch["group_id"] = np.zeros((R,), np.int32)
    batch["row_mask"] = np.zeros((R,), bool)
    batch["duration"] = np.ones((R,), np.float32)
    if spec.with_targets:
        if spec.multi_clip:
            T = spec.max_windows
            batch["norm_moment"] = np.zeros((R, T, 2), np.float32)
            batch["norm_span"] = np.zeros((R, T, 2), np.float32)
            batch["tgt_mask"] = np.zeros((R, T), bool)
            batch["saliency_label"] = np.zeros((R, Lv), np.float32)
        else:
            batch["moment"] = np.zeros((R, 2), np.float32)
            batch["norm_moment"] = np.zeros((R, 2), np.float32)
            batch["norm_span"] = np.zeros((R, 2), np.float32)
        batch["pos_idx"] = np.zeros((R, spec.contra_pairs), np.int64)
        batch["neg_idx"] = np.zeros((R, spec.contra_pairs), np.int64)
    has_cached_text = "cached_words_feat" in first
    if has_cached_text:
        cw = first["cached_words_feat"][0]
        batch["cached_words_feat"] = np.zeros((R, *cw.shape), np.float32)
        batch["cached_words_mask"] = np.zeros((R, cw.shape[0]), bool)
        batch["cached_sentence_feat"] = np.zeros(
            (R, first["cached_sentence_feat"][0].shape[-1]), np.float32
        )
    batch["ss_sent_idx"] = np.zeros((R, G), np.int32)
    batch["ss_sent_mask"] = np.zeros((R, G), bool)
    batch["ss_own_pos"] = np.zeros((R,), np.int32)
    if spec.ss_video_l > 0:
        NG = len(entries)
        batch["ss_video_feat_groups"] = np.zeros((NG, spec.ss_video_l, Dv), np.float32)
        batch["ss_video_mask_groups"] = np.zeros((NG, spec.ss_video_l), bool)
        batch["ss_group_slot"] = np.zeros((R,), np.int32)
        for g, cat in enumerate(ss_groups):
            batch["ss_video_feat_groups"][g, : len(cat)] = cat
            batch["ss_video_mask_groups"][g, : len(cat)] = True

    for r, row in enumerate(rows):
        e, i, g = row["entry"], row["i"], row["group"]
        feat = e["video_feat"][i] if isinstance(e["video_feat"], list) else e["video_feat"]
        L = min(feat.shape[0], Lv)
        if dedup:
            batch["video_slot"][r] = g
        else:
            batch["video_feat"][r, :L] = feat[:L]
        batch["video_mask"][r, :L] = True
        batch["words_id"][r] = e["words_id"][i]
        batch["words_weight"][r] = e["words_weight"][i]
        if "unknown_mask" in batch:
            batch["unknown_mask"][r] = e["unknown_mask"][i]
            batch["words_label"][r] = e["words_label"][i]
        batch["group_id"][r] = g
        batch["row_mask"][r] = True
        batch["duration"][r] = meta["duration"][r]
        if has_cached_text:
            batch["cached_words_feat"][r] = e["cached_words_feat"][i]
            batch["cached_words_mask"][r] = e["cached_words_mask"][i]
            batch["cached_sentence_feat"][r] = e["cached_sentence_feat"][i]
        if spec.with_targets:
            if spec.multi_clip:
                nm = e["norm_moment"][i][: spec.max_windows]
                ns = e["norm_span"][i][: spec.max_windows]
                batch["norm_moment"][r, : len(nm)] = nm
                batch["norm_span"][r, : len(ns)] = ns
                batch["tgt_mask"][r, : len(nm)] = True
                sal = e["saliency_label"][i][:Lv]
                batch["saliency_label"][r, : len(sal)] = sal
                cm = np.asarray(e["clip_mask"][i])[:Lv]
                batch["clip_mask"][r, : len(cm)] = cm
                batch["pos_idx"][r] = np.asarray(e["pos_idx"][i])[: spec.contra_pairs]
                batch["neg_idx"][r] = np.asarray(e["neg_idx"][i])[: spec.contra_pairs]
            else:
                moment = np.asarray(e["moment"][i], np.float32)
                batch["moment"][r] = moment
                nm = moment / max(meta["duration"][r], 1e-6)
                batch["norm_moment"][r] = nm
                batch["norm_span"][r] = _norm_xx_to_cxw(nm)
                cm = np.asarray(e["clip_mask"][i])[:L]
                batch["clip_mask"][r, : len(cm)] = cm
                if e.get("pos_idx") is not None:
                    batch["pos_idx"][r] = np.asarray(e["pos_idx"][i])[: spec.contra_pairs]
                    batch["neg_idx"][r] = np.asarray(e["neg_idx"][i])[: spec.contra_pairs]
        elif spec.multi_clip:
            pass  # qvh test split: no targets

        # ss gather: rows of my group (window of <= G containing me)
        grows = group_row_lists[g]
        if len(grows) > G:
            pos = grows.index(r)
            start = min(max(pos - G + 1, 0), len(grows) - G)
            window = grows[start : start + G]
        else:
            window = grows
        batch["ss_sent_idx"][r, : len(window)] = window
        batch["ss_sent_idx"][r, len(window):] = r
        batch["ss_sent_mask"][r, : len(window)] = True
        batch["ss_own_pos"][r] = window.index(r)
        if spec.ss_video_l > 0:
            batch["ss_group_slot"][r] = g

    # pad rows with copies of row 0 (row_mask already False)
    if n_real < R and n_real > 0:
        for k, v in batch.items():
            if k in ("ss_video_feat_groups", "ss_video_mask_groups",
                     "video_feat_g", "video_mask_g"):
                continue
            if k == "row_mask":
                continue
            v[n_real:] = v[0]
    return batch, meta

