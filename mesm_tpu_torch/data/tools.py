"""Offline data-prep tools.

Counterpart of mesm_tpu/data/tools.py (the same outputs), with the port's
tokenizers and vocabulary. Parity targets: reference data/npy2hdf5.py
(per-video .npy/.npz feature dirs -> one HDF5) and data/tokenized_count.py (token-frequency files that seed the
MLM keep-vocab, consumed by datasets.load_*_keep_vocab).

Usage:
  python -m mesm_tpu_torch.data.tools npy2hdf5 "<glob>" out.hdf5 [--npz-key features]
  python -m mesm_tpu_torch.data.tools clip_count <ann_path> <dataset> <bpe_path>
  python -m mesm_tpu_torch.data.tools glove_count <ann_path> <dataset>
"""
from __future__ import annotations

import argparse
import glob
import os
from collections import Counter

import numpy as np


def npy2hdf5(feat_glob: str, h5_path: str, npz_key: str = "features"):
    """Every .npy / .npz of the glob into one HDF5 file, one dataset per
    video id. Needs h5py, imported here only: the rest of the port reads
    feature directories without it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("npy2hdf5 needs the h5py package, which is not installed") from e

    with h5py.File(h5_path, "w") as h5:
        for path in sorted(glob.glob(feat_glob)):
            vid = os.path.splitext(os.path.basename(path))[0]
            if path.endswith(".npz"):
                feats = np.load(path)[npz_key]
            else:
                feats = np.load(path)
            h5.create_dataset(vid, data=np.squeeze(feats))


def _iter_sentences(ann_path: str, dataset: str):
    import json

    if dataset in ("charades",):
        for split in ("charades_sta_train.txt", "charades_sta_test.txt"):
            p = os.path.join(ann_path, split)
            if not os.path.exists(p):
                continue
            with open(p) as f:
                for line in f:
                    yield line.split("##", 1)[1].rstrip()
    elif dataset in ("charades-cg", "charades-cd", "tacos"):
        for fname in os.listdir(ann_path):
            if not fname.endswith(".json"):
                continue
            with open(os.path.join(ann_path, fname)) as f:
                obj = json.load(f)
            for meta in obj.values():
                for s in meta.get("sentences", []):
                    yield s
    elif dataset == "qvhighlights":
        import json as _json

        for fname in os.listdir(ann_path):
            if not fname.endswith(".jsonl"):
                continue
            with open(os.path.join(ann_path, fname)) as f:
                for line in f:
                    yield _json.loads(line)["query"]
    else:
        raise ValueError(dataset)


def build_clip_count(ann_path: str, dataset: str, bpe_path: str):
    """CLIP_tokenized_count.txt: '<token_id> <count>' sorted by frequency."""
    from .tokenizers import ClipBPETokenizer

    tok = ClipBPETokenizer(False, None, bpe_path)
    counts: Counter = Counter()
    for s in _iter_sentences(ann_path, dataset):
        ids, _ = tok.encode(s)
        counts.update(ids)
    with open(os.path.join(ann_path, "CLIP_tokenized_count.txt"), "w") as f:
        for tid, c in counts.most_common():
            f.write(f"{tid} {c}\n")


def build_glove_count(ann_path: str, dataset: str):
    """GloVe_tokenized_count.txt: '<word> <vocab_id> <count>' by frequency."""
    from .tokenizers import GloVeSimpleTokenizer
    from .vocab import Vocabulary

    splitter = GloVeSimpleTokenizer(False, None, None)
    counts: Counter = Counter()
    for s in _iter_sentences(ann_path, dataset):
        counts.update(splitter.split_words(s))
    vocab = Vocabulary(set(counts.keys()))
    with open(os.path.join(ann_path, "GloVe_tokenized_count.txt"), "w") as f:
        for w, c in counts.most_common():
            f.write(f"{w} {vocab.wtoi[w]} {c}\n")


def main():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("npy2hdf5")
    a.add_argument("feat_glob")
    a.add_argument("h5_path")
    a.add_argument("--npz-key", default="features")
    b = sub.add_parser("clip_count")
    b.add_argument("ann_path")
    b.add_argument("dataset")
    b.add_argument("bpe_path")
    c = sub.add_parser("glove_count")
    c.add_argument("ann_path")
    c.add_argument("dataset")
    args = p.parse_args()
    if args.cmd == "npy2hdf5":
        npy2hdf5(args.feat_glob, args.h5_path, args.npz_key)
    elif args.cmd == "clip_count":
        build_clip_count(args.ann_path, args.dataset, args.bpe_path)
    elif args.cmd == "glove_count":
        build_glove_count(args.ann_path, args.dataset)


if __name__ == "__main__":
    main()
