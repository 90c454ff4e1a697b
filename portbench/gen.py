"""The general generator of the benchmark's traffic: a data set of videos
and sentences drawn from one mix's parameters (`traffic/<mix>.json`) and
the run's seed, in the layout the measured program's data sets give it.

The sizes are a layout of their own: every video's clip count, duration
and sentence count and every sentence's word count are drawn once from the
mix's `layout_seed`, so every run seed serves the same sizes. The run seed
orders them (which video takes which sizes, which sentence which words)
and draws every value: the clips' features, the words' features, the
moments. Features are L2-normalised per clip with the two temporal-endpoint
channels appended, as the program's feature store and data set give them,
and the frozen text encoder's output stands as cached features (what
`--cache_text on` holds): word vectors normalised, the sentence vector the
normalised mean of its words.

An entry is one video's sentences, in chunks of at most `max_gather_size`
where the configuration sets it, sorted by start as the program's data sets
sort them.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch


def lognormal_from_mean_and_longest(mean: float, longest: float, population: int):
    """(median, sigma) of the lognormal with this mean whose expected
    largest value over `population` draws (Blom's position of the top order
    statistic) is `longest`."""
    z = NormalDist().inv_cdf((population - 0.375) / (population + 0.25))
    sigma = z - math.sqrt(z * z - 2.0 * math.log(longest / mean))
    return mean * math.exp(-0.5 * sigma * sigma), sigma


def _durations(rng, dur: dict, clips: dict, n_vid: int):
    """Video durations in seconds. Either a lognormal of the stated median
    and sigma (with an optional uniform tail), clipped to [min, max]; or,
    where the mix states the data set's mean duration and the feature
    extraction (frames a second, frames a clip, the longest video's clips),
    the lognormal of that mean whose longest video of the data set's
    `population` has those clips, clipped to that longest duration."""
    if "mean" in dur:
        longest = clips["max_raw"] * clips["frames_per_clip"] / clips["fps"]
        median, sigma = lognormal_from_mean_and_longest(dur["mean"], longest, dur["population"])
        return np.minimum(np.exp(rng.normal(math.log(median), sigma, n_vid)), longest)
    durations = np.exp(rng.normal(math.log(dur["median"]), dur["sigma"], n_vid))
    tail = rng.random(n_vid) < dur.get("tail_share", 0.0)
    if tail.any():
        durations[tail] = rng.uniform(dur["tail_min"], dur["tail_max"], int(tail.sum()))
    return np.clip(durations, dur["min"], dur["max"])


def _layout(mix: dict, cfg: dict):
    """Per video (clips, duration_s, sentences), per sentence words and the
    moment's (start, length) as shares of the video: fixed by layout_seed."""
    rng = np.random.default_rng(int(mix["layout_seed"]))
    n_vid, n_sent = int(mix["videos"]), int(mix["sentences"])
    cap = int(cfg["max_video_l"])
    durations = _durations(rng, mix["duration_s"], mix.get("clips", {}), n_vid)
    if cfg["clip_len"] == -1:  # one feature a fixed number of frames, mean-pooled to the cap
        cl = mix["clips"]
        raw = np.floor(durations * cl["fps"] / cl["frames_per_clip"]).astype(int)
        clips = np.clip(raw, 1, cap)
    else:
        clips = np.minimum(np.ceil(durations / cfg["clip_len"]).astype(int), cap)
    # sentences a video: 1 + a multinomial share of the rest, by weight
    spread = mix.get("sentence_spread", 0.5)
    weight = np.exp(rng.normal(0.0, spread, n_vid))
    per_video = 1 + rng.multinomial(n_sent - n_vid, weight / weight.sum())
    w = mix["words"]
    words = np.clip(np.round(rng.normal(w["mean"], w["sd"], n_sent)), w["min"],
                    min(w["max"], cfg["max_words_l"])).astype(int)
    m = mix["moment_share"]
    length = rng.uniform(m["min"], m["max"], n_sent)
    start = rng.random(n_sent) * (1.0 - length)
    return clips.astype(int), durations, per_video, words, start, length


class Dataset:
    """An in-memory data set with the interface the program's batchers,
    batch specs and collate read: `merged_data` (entries with per-sentence
    lists), `max_group_size()`, `estimated_length(i)`, `exact_length(i)`,
    `split` and `ds[i]`, the item the program's data sets build (video
    features with TEF, targets, MLM fields, cached text)."""

    def __init__(self, mix: dict, cfg: dict, seed: int, device: str, features: bool = True):
        """features=False lays the data set out without drawing a value of
        it (its batches can be planned, not built)."""
        self.split = mix["split"]
        self.cfg = cfg
        self.recfw = mix["split"] == "train" and bool(cfg["rec_fw"])
        clips, durations, per_video, words, start, length = _layout(mix, cfg)
        rng = np.random.default_rng([int(seed), 1])
        n_vid = len(clips)
        order = rng.permutation(n_vid)  # which video takes which sizes
        clips, durations, per_video = clips[order], durations[order], per_video[order]
        s_order = rng.permutation(len(words))
        words, start, length = words[s_order], start[s_order], length[s_order]
        self.clips = clips
        Lw, Dt = int(cfg["max_words_l"]), int(cfg["t_feat_dim"])
        Dv = int(cfg["v_feat_dim"])
        gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
        # features in a few large draws on the device, then to the host
        total = int(clips.sum()) if features else 0
        feat = torch.randn(total, Dv, generator=gen, device=device)
        feat = feat / feat.norm(dim=-1, keepdim=True)
        self.video_feat: List[np.ndarray] = []
        off = 0
        feat_host = feat.cpu().numpy()
        del feat
        for L in clips if features else ():
            st = np.arange(L, dtype=np.float32) / L
            tef = np.stack([st, st + 1.0 / L], axis=1)
            self.video_feat.append(np.concatenate([feat_host[off:off + L], tef], axis=1))
            off += L
        del feat_host
        n_sent = len(words)
        wm = np.arange(Lw)[None] < words[:, None]
        if features:
            wmask = torch.as_tensor(wm, device=device)
            wf = torch.randn(n_sent, Lw, Dt, generator=gen, device=device) * wmask[..., None]
            sf = wf.sum(1) / wmask.sum(1, keepdim=True)
            wf = (wf / wf.norm(dim=-1, keepdim=True).clamp(min=1e-5)).cpu().numpy()
            sf = (sf / sf.norm(dim=-1, keepdim=True).clamp(min=1e-5)).cpu().numpy()
        else:
            wf = sf = np.zeros((n_sent, 0), np.float32)
        vocab = int(cfg["vocab_size"])
        ids = rng.integers(1, vocab, (n_sent, Lw)) * wm
        weights = rng.integers(1, 4, (n_sent, Lw)).astype(np.float32) * wm
        unknown = (rng.random((n_sent, Lw)) < mix.get("unknown_share", 0.0)) & wm
        labels = rng.integers(0, vocab + 1, (n_sent, Lw)) * wm
        gather = int(cfg.get("max_gather_size", -1))
        self.merged_data: List[Dict] = []
        s = 0
        for v in range(n_vid):
            n = int(per_video[v])
            sents = list(range(s, s + n))
            s += n
            rng.shuffle(sents)
            chunks = ([sents[i:i + gather] for i in range(0, n, gather)] if gather > 0
                      else [sents])
            for chunk in chunks:
                chunk = sorted(chunk, key=lambda j: start[j])
                dur = float(durations[v])
                self.merged_data.append({
                    "video": v,
                    "video_id": [f"v{v}"] * len(chunk),
                    "duration": [dur] * len(chunk),
                    "qid": [int(j) for j in chunk],
                    "sentence": [f"q{j}" for j in chunk],
                    "moment": [[float(start[j] * dur), float((start[j] + length[j]) * dur)]
                               for j in chunk],
                    "share": [(float(start[j]), float(start[j] + length[j])) for j in chunk],
                    "words_id": [ids[j][None] for j in chunk],
                    "words_weight": [weights[j][None] for j in chunk],
                    "unknown_mask": [unknown[j][None] for j in chunk],
                    "words_label": [labels[j][None] for j in chunk],
                    "cached_words_feat": [wf[j] for j in chunk],
                    "cached_words_mask": [wm[j] for j in chunk],
                    "cached_sentence_feat": [sf[j] for j in chunk],
                })
        self._seed = int(seed)

    def __len__(self) -> int:
        return len(self.merged_data)

    def max_group_size(self) -> int:
        return max(len(e["video_id"]) for e in self.merged_data)

    def estimated_length(self, index: int) -> int:
        """The program's estimate: duration / clip_len capped, or the cap
        where the clips are fractional (clip_len -1)."""
        cap = int(self.cfg["max_video_l"])
        if self.cfg["clip_len"] == -1:
            return cap
        dur = float(self.merged_data[index]["duration"][0])
        return min(max(int(math.ceil(dur / self.cfg["clip_len"])), 1), cap)

    def exact_length(self, index: int) -> int:
        return int(self.clips[self.merged_data[index]["video"]])

    def __getitem__(self, index: int) -> Dict:
        meta = self.merged_data[index]
        feat = self.video_feat[meta["video"]]
        L, n = feat.shape[0], len(meta["qid"])
        k = int(self.cfg["contra_samples"])
        rng = np.random.default_rng([self._seed, 2, index])
        clip_mask = np.zeros((n, L), bool)
        pos_idx, neg_idx = np.zeros((n, k), np.int64), np.zeros((n, k), np.int64)
        start_idx, end_idx = [], []
        for i, (a, b) in enumerate(meta["share"]):
            s_, e_ = int(a * L), min(int(b * L), L - 1)
            s_ = min(s_, e_)
            start_idx.append(s_)
            end_idx.append(e_)
            clip_mask[i, s_:e_ + 1] = True
            span = np.arange(s_, e_ + 1)
            pos_idx[i] = rng.choice(span, k, replace=len(span) < k)
            pool = np.concatenate([np.arange(0, s_), np.arange(e_ + 1, L)])
            pool = span if len(pool) == 0 else pool
            neg_idx[i] = rng.choice(pool, k, replace=len(pool) < k)
        return {
            "num_clips": n,
            "video_feat": feat,
            "video_id": meta["video_id"][0],
            "duration": meta["duration"][0],
            "moment": np.asarray(meta["moment"], np.float32),
            "sentence": meta["sentence"],
            "words_id": np.concatenate(meta["words_id"], 0),
            "words_weight": np.concatenate(meta["words_weight"], 0),
            "unknown_mask": np.concatenate(meta["unknown_mask"], 0) if self.recfw else None,
            "words_label": np.concatenate(meta["words_label"], 0) if self.recfw else None,
            "start_idx": start_idx,
            "end_idx": end_idx,
            "clip_mask": clip_mask,
            "pos_idx": pos_idx,
            "neg_idx": neg_idx,
            "qid": meta["qid"],
            "cached_words_feat": meta["cached_words_feat"],
            "cached_words_mask": meta["cached_words_mask"],
            "cached_sentence_feat": meta["cached_sentence_feat"],
        }
