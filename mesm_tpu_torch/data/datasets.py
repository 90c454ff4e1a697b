"""Dataset adapters: annotation parsing, video-grouping, per-item assembly.

Parity targets:
  - BaseDataset: tokenizer selection, MLM keep-vocab loading, group-by-video
    merging, mean-pool downsampling, TEF, per-sentence clip masks and
    contrastive frame sampling (reference dataset/base.py:13-230).
  - Charades (##-txt + durations csv, swap inverted spans): dataset/charades.py
  - TACoS (frames/fps json): dataset/tacos.py
  - Charades-CG / -CD (json splits): dataset/charades_cg.py, charades_cd.py
  - QVHighlights (jsonl, multi-window, 3-annotator saliency):
    dataset/qvhighlights.py

Everything here is host-side numpy: items are dicts of small arrays; the
fixed-shape batch assembly lives in collate.py.
"""
from __future__ import annotations

import csv
import json
import os
import pickle
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .hdf5 import FeatureStore
from .tokenizers import (
    ClipBPETokenizer,
    GloVeSimpleTokenizer,
    NLTKFeatureTokenizer,
    NLTKTokenizer,
)


# ---------------------------------------------------------------------------
# MLM keep-vocab loading (reference dataset/base.py:53-92)
# ---------------------------------------------------------------------------


def load_clip_keep_vocab(ann_path: str, vocab_size: int) -> Dict:
    id2label: Dict = {}
    with open(os.path.join(ann_path, "CLIP_tokenized_count.txt")) as f:
        for count, line in enumerate(f):
            if count == vocab_size:
                break
            id2label[int(line.split(" ")[0])] = count
    id2label["<unknown>"] = vocab_size
    id2label["<start>"] = vocab_size + 1
    id2label["<end>"] = vocab_size + 2
    return id2label


def load_glove_keep_vocab(ann_path: str, vocab_size: int) -> Dict:
    id2label: Dict = {}
    with open(os.path.join(ann_path, "GloVe_tokenized_count.txt")) as f:
        for count, line in enumerate(f):
            if count == vocab_size:
                break
            id2label[int(line.split(" ")[1])] = count
    id2label["<unknown>"] = vocab_size
    return id2label


def load_glove_pkl_keep_vocab(vocab: Dict, vocab_size: int) -> Dict:
    id2label: Dict = {}
    for count, (w, _) in enumerate(vocab["counter"].most_common(vocab_size)):
        id2label[w] = count
    id2label["<unknown>"] = vocab_size
    return id2label


def mean_pool_downsample(feat: np.ndarray, max_len: int) -> np.ndarray:
    """Mean-pool a (L, D) feature sequence down to max_len segments
    (reference dataset/base.py:100-114), vectorized via cumsum."""
    L = feat.shape[0]
    if L <= max_len:
        return feat
    idxs = np.round(np.arange(0, max_len + 1) / max_len * L).clip(max=L - 1).astype(int)
    s, e = idxs[:-1], idxs[1:]
    cs = np.concatenate([np.zeros((1, feat.shape[1]), feat.dtype), np.cumsum(feat, 0)])
    seg_sum = cs[e] - cs[s]
    seg_len = (e - s).clip(min=1)[:, None]
    pooled = seg_sum / seg_len
    # where s >= e the reference takes feat[s]
    degenerate = s >= e
    if degenerate.any():
        pooled[degenerate] = feat[s[degenerate]]
    return pooled.astype(np.float32)


def add_tef(feat: np.ndarray) -> np.ndarray:
    """Append temporal-endpoint features (reference dataset/base.py:225-230)."""
    L = feat.shape[0]
    st = np.arange(L, dtype=np.float32) / L
    tef = np.stack([st, st + 1.0 / L], axis=1)
    return np.concatenate([feat, tef], axis=1)


class BaseDataset:
    """Annotation + grouping + per-item feature assembly."""

    sort_key = "start_idx"

    def __init__(
        self,
        ann_path: str,
        feat_files: Sequence[str],
        split: str,
        use_tef: bool,
        clip_len: float,
        max_words_l: int,
        max_video_l: int,
        tokenizer_type: str,
        load_vocab_pkl: bool,
        bpe_path: str,
        vocab,
        normalize_video: bool,
        contra_samples: int,
        recfw: bool,
        vocab_size: int,
        max_gather_size: int,
        seed: int = 0,
    ):
        self.ann_path = ann_path
        self.split = split
        self.use_tef = use_tef
        self.clip_len = clip_len
        self.max_words_l = max_words_l
        self.max_video_l = max_video_l
        self.contra_samples = contra_samples
        self.recfw = recfw
        self.vocab_size = vocab_size
        self.max_gather_size = max_gather_size
        self.store = FeatureStore(feat_files, normalize=normalize_video)
        self._seed = seed
        self._visit_counts: Dict[int, int] = {}
        self._rng_lock = __import__("threading").Lock()

        if tokenizer_type == "CLIP":
            id2label = load_clip_keep_vocab(ann_path, vocab_size) if recfw else None
            self.tokenizer = ClipBPETokenizer(recfw, id2label, bpe_path)
        elif tokenizer_type == "GloVeSimple":
            id2label = load_glove_keep_vocab(ann_path, vocab_size) if recfw else None
            self.tokenizer = GloVeSimpleTokenizer(recfw, id2label, vocab)
        elif tokenizer_type == "GloVeNLTK":
            if load_vocab_pkl:
                id2label = load_glove_pkl_keep_vocab(vocab, vocab_size) if recfw else None
                self.tokenizer = NLTKFeatureTokenizer(recfw, id2label, vocab)
            else:
                id2label = load_glove_keep_vocab(ann_path, vocab_size) if recfw else None
                self.tokenizer = NLTKTokenizer(recfw, id2label, vocab)
        else:
            raise ValueError(f"unknown tokenizer_type {tokenizer_type}")

        self.data = self.load_annotations()
        self.merged_data = self._gather_by_video()

    # -- to implement per dataset ------------------------------------------
    def load_annotations(self) -> List[Dict]:
        raise NotImplementedError

    def get_video_feat(self, video_id: str) -> np.ndarray:
        return self.store.get(video_id)

    # -- shared machinery -----------------------------------------------------

    def _gather_by_video(self) -> List[Dict]:
        """Group annotations by video; chunk groups at max_gather_size with a
        shuffle (reference dataset/base.py:116-162)."""
        groups: Dict[str, List[Dict]] = defaultdict(list)
        for meta in self.data:
            groups[meta["video_id"]].append(meta)

        merged: List[Dict] = []
        for _, metas in groups.items():
            if self.max_gather_size > 0:
                random.shuffle(metas)
                chunks = [
                    metas[i : i + self.max_gather_size]
                    for i in range(0, len(metas), self.max_gather_size)
                ]
            else:
                chunks = [metas]
            for chunk in chunks:
                chunk = sorted(chunk, key=lambda m: m[self.sort_key])
                entry: Dict[str, list] = defaultdict(list)
                for m in chunk:
                    for k, v in m.items():
                        entry[k].append(v)
                merged.append(dict(entry))
        return merged

    def __len__(self) -> int:
        return len(self.merged_data)

    def max_group_size(self) -> int:
        return max(len(e["video_id"]) for e in self.merged_data)

    def estimated_length(self, index: int) -> int:
        """Estimated clip count of an entry's video WITHOUT reading features:
        duration / clip_len capped at max_video_l. Drives eval length-sorted
        batching and the data-driven padding buckets; the collate still pads
        to the ACTUAL batch max, so an estimate error only costs padding.
        Fractional indexing (clip_len == -1, TACoS) has no duration->clips
        mapping — fall back to the cap (no sorting benefit there)."""
        if self.clip_len == -1:
            return self.max_video_l
        dur = float(self.merged_data[index]["duration"][0])
        import math as _math

        return min(max(int(_math.ceil(dur / self.clip_len)), 1), self.max_video_l)

    def exact_length(self, index: int) -> int:
        """EXACT post-downsample clip count of an entry, from HDF5 shape
        metadata only (no feature read): mean_pool_downsample caps at
        max_video_l, so the collated length is min(raw rows, max_video_l).
        evaluate.warm_eval_step uses this to predict each batch's padding
        bucket without building the batch."""
        return self.store.length(self.merged_data[index]["video_id"][0], self.max_video_l)

    def __getstate__(self):
        # process-pool loader workers receive the dataset by pickle
        # (forkserver context, data/pipeline.py); the thread lock can't make
        # the trip and each worker wants its own anyway
        state = self.__dict__.copy()
        state.pop("_rng_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._rng_lock = __import__("threading").Lock()

    def item_rng(self, index: int) -> np.random.Generator:
        """Per-item generator, deterministic regardless of loader thread
        scheduling: keyed on (seed, index, visit-count-of-index). Mirrors the
        reference's reproducibility stance (train.py:32-39) without sharing a
        Generator across threads.

        Process-pool loaders fork workers whose visit counts are frozen
        copies of the parent's; the parent advances `_epoch_offset`
        (advance_epoch, called by Loader._iter_process before each fork) so
        every epoch still draws fresh randomness, identically regardless of
        which worker serves the index."""
        with self._rng_lock:
            visit = self._visit_counts.get(index, 0)
            self._visit_counts[index] = visit + 1
        return np.random.default_rng(
            (self._seed, index, visit + getattr(self, "_epoch_offset", 0))
        )

    def advance_epoch(self):
        self._epoch_offset = getattr(self, "_epoch_offset", 0) + 1

    def __getitem__(self, index: int) -> Dict:
        meta = self.merged_data[index]
        num_clips = len(meta["video_id"])
        feat = self.get_video_feat(meta["video_id"][0])
        feat = mean_pool_downsample(feat, self.max_video_l)
        L = feat.shape[0]
        if self.use_tef:
            feat = add_tef(feat)

        start_idx = list(meta["start_idx"])
        end_idx = list(meta["end_idx"])
        if self.clip_len == -1:  # fractional indexing (TACoS)
            start_idx = [int(i * L) for i in start_idx]
            end_idx = [int(i * L) for i in end_idx]

        rng = self.item_rng(index)
        clip_mask = np.zeros((num_clips, L), bool)
        pos_idx = np.zeros((num_clips, max(self.contra_samples, 1)), np.int64)
        neg_idx = np.zeros_like(pos_idx)
        for i in range(num_clips):
            end_idx[i] = min(end_idx[i], L - 1)
            start_idx[i] = min(start_idx[i], end_idx[i])
            s, e = start_idx[i], end_idx[i]
            clip_mask[i, s : e + 1] = True
            if self.contra_samples > 0:
                span = np.arange(s, e + 1)
                replace = len(span) < self.contra_samples
                pos_idx[i] = rng.choice(span, self.contra_samples, replace=replace)
                pool = np.concatenate([np.arange(0, s), np.arange(e + 1, L)])
                if len(pool) == 0:
                    pool = span  # degenerate: whole video is the span
                replace = len(pool) < self.contra_samples
                neg_idx[i] = rng.choice(pool, self.contra_samples, replace=replace)

        out = {
            "num_clips": num_clips,
            "video_feat": feat,
            "video_id": meta["video_id"][0],
            "duration": meta["duration"][0],
            "moment": np.asarray(meta["moment"], np.float32),
            "sentence": meta["sentence"],
            "words_id": np.concatenate(meta["words_id"], 0),
            "words_weight": np.concatenate(meta["words_weight"], 0),
            "unknown_mask": (
                np.concatenate(meta["unknown_mask"], 0) if self.recfw else None
            ),
            "words_label": (
                np.concatenate(meta["words_label"], 0) if self.recfw else None
            ),
            "start_idx": start_idx,
            "end_idx": end_idx,
            "clip_mask": clip_mask,
            "pos_idx": pos_idx if self.contra_samples > 0 else None,
            "neg_idx": neg_idx if self.contra_samples > 0 else None,
            "qid": meta["qid"],
        }
        self._attach_cached_text(out, meta)
        return out

    @staticmethod
    def _attach_cached_text(item: Dict, meta: Dict):
        """Pass through precomputed frozen-text encodings when present
        (runner.cache_text_features)."""
        for k in ("cached_words_feat", "cached_words_mask", "cached_sentence_feat"):
            if k in meta:
                item[k] = meta[k]

    def _tokenize_one(self, sentence: str):
        return self.tokenizer.tokenize(sentence, max_valid_length=self.max_words_l)


class CharadesDataset(BaseDataset):
    """Charades-STA: `video_id st ed##sentence` txt + durations CSV
    (reference dataset/charades.py)."""

    ann_files = {"train": "charades_sta_train.txt", "test": "charades_sta_test.txt"}
    duration_files = {
        "train": "Charades_v1_train.csv",
        "val": "Charades_v1_test.csv",
        "test": "Charades_v1_test.csv",
    }

    def _load_durations(self) -> Dict[str, float]:
        durations = {}
        with open(os.path.join(self.ann_path, self.duration_files[self.split])) as f:
            reader = csv.reader(f)
            next(reader, None)  # header
            for row in reader:
                durations[row[0]] = float(row[-1])
        return durations

    def load_annotations(self) -> List[Dict]:
        durations = self._load_durations()
        out = []
        path = os.path.join(self.ann_path, self.ann_files[self.split])
        with open(path) as f:
            for qid, line in enumerate(f):
                head, sentence = line.split("##", 1)
                video_id, st, ed = head.split()
                st, ed = float(st), float(ed)
                duration = durations[video_id]
                if st > duration:
                    continue
                if st > ed:  # fix inverted annotations
                    st, ed = ed, st
                ed = min(ed, duration)
                out.append(
                    self._make_record(video_id, duration, st, ed, sentence.rstrip(), qid)
                )
        return out

    def _make_record(self, video_id, duration, st, ed, sentence, qid):
        if self.clip_len == -1:
            s_idx, e_idx = st / duration, ed / duration
        else:
            s_idx, e_idx = int(st / self.clip_len), int(ed / self.clip_len)
        ids, weight, unk, label = self._tokenize_one(sentence)
        return {
            "video_id": video_id,
            "duration": duration,
            "moment": [st, ed],
            "sentence": sentence,
            "words_id": ids,
            "words_weight": weight,
            "unknown_mask": unk,
            "words_label": label,
            "start_idx": s_idx,
            "end_idx": e_idx,
            "qid": None if self.split == "train" else qid,
            "relevant_windows": None if self.split == "train" else [[st, ed]],
        }


class _CharadesJsonDataset(CharadesDataset):
    """Charades-CG/CD style json annotations: {vid: {duration, timestamps,
    sentences}} (reference dataset/charades_cg.py:46-98)."""

    split_files: Dict[str, str] = {}

    def load_annotations(self) -> List[Dict]:
        path = os.path.join(self.ann_path, self.split_files[self.split])
        with open(path) as f:
            obj = json.load(f)
        out = []
        qid = 0
        for video_id, meta in obj.items():
            duration = float(meta["duration"])
            for ts, sentence in zip(meta["timestamps"], meta["sentences"]):
                st, ed = float(ts[0]), float(ts[1])
                if st > duration:
                    continue
                if st > ed:
                    st, ed = ed, st
                ed = min(ed, duration)
                qid += 1
                out.append(self._make_record(video_id, duration, st, ed, sentence, qid))
        return out


class CharadesCGDataset(_CharadesJsonDataset):
    split_files = {
        "train": "train.json",
        "novel_composition": "novel_composition.json",
        "novel_word": "novel_word.json",
        "test_trivial": "test_trivial.json",
    }


class CharadesCDDataset(_CharadesJsonDataset):
    split_files = {
        "train": "charades_train.json",
        "val": "charades_val.json",
        "test_iid": "charades_test_iid.json",
        "test_ood": "charades_test_ood.json",
    }


class TACoSDataset(CharadesDataset):
    """TACoS: per-video json with frame-unit timestamps and fps
    (reference dataset/tacos.py)."""

    split_files = {"train": "train.json", "test": "test.json"}

    def load_annotations(self) -> List[Dict]:
        path = os.path.join(self.ann_path, self.split_files[self.split])
        with open(path) as f:
            obj = json.load(f)
        out = []
        count = 0
        for video_id, meta in obj.items():
            duration = meta["num_frames"] / meta["fps"]
            for ts, sentence in zip(meta["timestamps"], meta["sentences"]):
                if ts[0] > ts[1]:
                    continue
                count += 1
                st = max(ts[0] / meta["fps"], 0.0)
                ed = min(ts[1] / meta["fps"], duration)
                out.append(self._make_record(video_id, duration, st, ed, sentence, count))
        return out

    def get_video_feat(self, video_id: str) -> np.ndarray:
        return self.store.get(video_id)


class QVHighlightsDataset(BaseDataset):
    """QVHighlights: jsonl with relevant_clip_ids, 3-annotator saliency
    scores, multi-window targets (reference dataset/qvhighlights.py)."""

    sort_key = "video_start"
    split_files = {
        "train": "highlight_train_release.jsonl",
        "val": "highlight_val_release.jsonl",
        "test": "highlight_test_release.jsonl",
    }

    def __init__(self, *args, max_windows: int = 5, **kwargs):
        self.max_windows = max_windows
        super().__init__(*args, **kwargs)

    def load_annotations(self) -> List[Dict]:
        path = os.path.join(self.ann_path, self.split_files[self.split])
        out = []
        with open(path) as f:
            for line in f:
                meta = json.loads(line)
                video_id, st, _ed = meta["vid"].rsplit("_", 2)
                ids, weight, unk, label = self._tokenize_one(meta["query"])
                rec = {
                    "video_id": video_id,
                    "video_start": float(st),
                    "vid": meta["vid"],
                    "duration": meta["duration"],
                    "sentence": meta["query"],
                    "words_id": ids,
                    "words_weight": weight,
                    "unknown_mask": unk,
                    "words_label": label,
                    "qid": meta["qid"],
                }
                if self.split != "test":
                    rec.update(
                        relevant_clip_ids=meta["relevant_clip_ids"],
                        saliency_scores=meta["saliency_scores"],
                        relevant_windows=meta["relevant_windows"],
                    )
                out.append(rec)
        return out

    def get_video_feat(self, video_id: str) -> np.ndarray:
        return self.store.get(video_id, max_len=self.max_video_l)

    def exact_length(self, index: int) -> int:
        """Per-clip features: the batch pads to the LONGEST clip of the
        entry, each read capped at max_video_l (get_video_feat)."""
        return max(
            self.store.length(v, self.max_video_l)
            for v in self.merged_data[index]["vid"]
        )

    def get_span_labels(self, windows: List, ctx_l: int):
        """Normalized (xx, cxw) spans, capped at max_windows with a shuffle
        (reference dataset/qvhighlights.py:142-153)."""
        windows = list(windows)
        if len(windows) > self.max_windows:
            random.shuffle(windows)
            windows = windows[: self.max_windows]
        w = np.asarray(windows, np.float32) / (ctx_l * self.clip_len)
        spans = np.stack([w.mean(-1), w[:, 1] - w[:, 0]], axis=-1)
        return w, spans

    def get_saliency_labels_all(self, rel_clip_ids, scores, ctx_l, max_n=1):
        """Aggregate 3-annotator scores; hard pos/neg = extreme aggregate
        clips, easy pos/neg sampled in/out of the relevant set
        (reference dataset/qvhighlights.py:155-199)."""
        scores = np.asarray(scores)
        agg = scores.sum(1)
        order = np.argsort(agg)
        score_array = np.zeros(ctx_l)
        for i, cid in enumerate(rel_clip_ids):
            if cid >= len(score_array):
                grown = np.zeros(cid + 1)
                grown[: len(score_array)] = score_array
                score_array = grown
            score_array[cid] = agg[i]
        score_array = score_array[:ctx_l] if len(score_array) > ctx_l else score_array
        if len(score_array) < ctx_l:
            score_array = np.pad(score_array, (0, ctx_l - len(score_array)))

        hard_pos = [min(rel_clip_ids[i], ctx_l - 1) for i in order[-max_n:]]
        hard_neg = [min(rel_clip_ids[i], ctx_l - 1) for i in order[:max_n]]
        easy_pool = list(set(range(ctx_l)) - set(rel_clip_ids))
        if len(easy_pool) >= max_n:
            easy_pos = random.sample(list(rel_clip_ids), k=max_n)
            easy_pos = [min(p, ctx_l - 1) for p in easy_pos]
            easy_neg = random.sample(easy_pool, k=max_n)
        else:
            easy_pos, easy_neg = hard_pos, hard_neg
        return hard_pos + easy_pos, hard_neg + easy_neg, score_array

    def __getitem__(self, index: int) -> Dict:
        meta = self.merged_data[index]
        num_clips = len(meta["video_id"])
        feats, norm_moments, norm_spans = [], [], []
        pos_idx, neg_idx, saliency, clip_mask = [], [], [], []
        has_labels = self.split != "test"
        for i in range(num_clips):
            feat = self.get_video_feat(meta["vid"][i])
            L = feat.shape[0]
            if self.use_tef:
                feat = add_tef(feat)
            feats.append(feat)
            if has_labels:
                m, s = self.get_span_labels(meta["relevant_windows"][i], L)
                norm_moments.append(m)
                norm_spans.append(s)
                p, n, arr = self.get_saliency_labels_all(
                    meta["relevant_clip_ids"][i], meta["saliency_scores"][i], L
                )
                pos_idx.append(np.asarray(p, np.int64))
                neg_idx.append(np.asarray(n, np.int64))
                saliency.append(arr.astype(np.float32))
                clip_mask.append(arr != 0)

        item = {
            "num_clips": num_clips,
            "video_feat": feats,  # list of per-clip (L_i, D)
            "video_id": meta["vid"],
            "duration": meta["duration"],
            "sentence": meta["sentence"],
            "words_id": np.concatenate(meta["words_id"], 0),
            "words_weight": np.concatenate(meta["words_weight"], 0),
            "unknown_mask": (
                np.concatenate(meta["unknown_mask"], 0) if self.recfw else None
            ),
            "words_label": (
                np.concatenate(meta["words_label"], 0) if self.recfw else None
            ),
            "qid": meta["qid"],
        }
        if has_labels:
            item.update(
                norm_moment=norm_moments,
                norm_span=norm_spans,
                pos_idx=pos_idx,
                neg_idx=neg_idx,
                saliency_label=saliency,
                clip_mask=clip_mask,
            )
        self._attach_cached_text(item, meta)
        return item


DATASETS = {
    "charades": CharadesDataset,
    "charades-cg": CharadesCGDataset,
    "charades-cd": CharadesCDDataset,
    "tacos": TACoSDataset,
    "qvhighlights": QVHighlightsDataset,
}

VAL_SPLITS = {
    "charades": ["test"],
    "charades-cg": ["novel_composition", "novel_word"],
    "charades-cd": ["test_ood"],
    "tacos": ["test"],
    "qvhighlights": ["val"],
}


def build_dataset(opt, split: str, recfw: bool, vocab=None):
    """Registry construction mirroring reference runner.build_dataloader
    (runner.py:44-82)."""
    kwargs = dict(
        ann_path=opt.ann_path,
        feat_files=opt.feat_files,
        split=split,
        use_tef=opt.use_tef,
        clip_len=opt.clip_len,
        max_words_l=opt.max_words_l,
        max_video_l=opt.max_video_l,
        tokenizer_type=opt.tokenizer_type,
        load_vocab_pkl=opt.load_vocab_pkl,
        bpe_path=opt.bpe_path,
        vocab=vocab,
        normalize_video=opt.normalize_video,
        contra_samples=opt.contra_samples,
        recfw=recfw,
        vocab_size=opt.vocab_size,
        max_gather_size=opt.max_gather_size,
        seed=getattr(opt, "seed", 0),
    )
    cls = DATASETS[opt.dataset_name]
    if opt.dataset_name == "qvhighlights":
        kwargs["max_windows"] = opt.max_windows
    return cls(**kwargs)
