"""The port's offline data tools (mesm_tpu_torch/data/tools.py) on the cases
of tests/test_tools.py, with every output equal to mesm_tpu.data.tools's:
npy / npz -> HDF5, the GloVe count file of each annotation layout, the CLIP
count file, the keep vocab read back, the command line, and npy2hdf5's
error where h5py is missing (as on the GPU machine)."""
from __future__ import annotations

import gzip
import json
import shutil
import sys

import h5py
import numpy as np
import pytest

from mesm_tpu.data import tools as jtools
from mesm_tpu_torch.data import tools as ttools
from mesm_tpu_torch.data.datasets import load_glove_keep_vocab

LINES = ["V1 0.0 5.0##the dog runs\n", "V1 1.0 6.0##the dog sleeps\n",
         "V2 2.0 7.0##a person walks\n"]


def _h5(path):
    with h5py.File(path) as f:
        return {k: f[k][:] for k in f}


@pytest.mark.parametrize("ext", ["npy", "npz"])
def test_npy2hdf5_matches_jax(tmp_path, ext):
    feats = {}
    for i in range(3):
        arr = np.random.default_rng(i).normal(size=(5 + i, 4)).astype(np.float32)
        if ext == "npy":
            np.save(tmp_path / f"vid{i}.npy", arr)
        else:
            np.savez(tmp_path / f"vid{i}.npz", features=arr)
        feats[f"vid{i}"] = arr
    ttools.npy2hdf5(str(tmp_path / f"*.{ext}"), str(tmp_path / "port.hdf5"))
    jtools.npy2hdf5(str(tmp_path / f"*.{ext}"), str(tmp_path / "jax.hdf5"))
    port, ref = _h5(tmp_path / "port.hdf5"), _h5(tmp_path / "jax.hdf5")
    assert sorted(port) == sorted(ref) == sorted(feats)
    for vid, arr in feats.items():
        np.testing.assert_array_equal(port[vid], arr)
        np.testing.assert_array_equal(port[vid], ref[vid])


def test_npy2hdf5_without_h5py_names_the_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        ttools.npy2hdf5(str(tmp_path / "*.npy"), str(tmp_path / "out.hdf5"))


def _write_annotations(ann, dataset):
    ann.mkdir()
    if dataset == "charades":
        (ann / "charades_sta_train.txt").write_text("".join(LINES))
        (ann / "charades_sta_test.txt").write_text(LINES[0])
    elif dataset == "tacos":
        (ann / "train.json").write_text(json.dumps({
            "s1.avi": {"sentences": ["the dog runs", "the dog sleeps"]},
            "s2.avi": {"sentences": ["a person walks"]}}))
        (ann / "test.json").write_text(json.dumps({"s3.avi": {"sentences": ["the dog runs"]}}))
    else:
        (ann / "train.jsonl").write_text("\n".join(json.dumps({"query": s.split("##")[1].strip()})
                                                   for s in LINES) + "\n")


@pytest.mark.parametrize("dataset", ["charades", "tacos", "qvhighlights"])
def test_glove_count_matches_jax(tmp_path, dataset):
    _write_annotations(tmp_path / "port", dataset)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    ttools.build_glove_count(str(tmp_path / "port"), dataset)
    jtools.build_glove_count(str(tmp_path / "jax"), dataset)
    name = "GloVe_tokenized_count.txt"
    text = (tmp_path / "port" / name).read_text()
    assert text == (tmp_path / "jax" / name).read_text()
    rows = [line.split() for line in text.splitlines()]
    counts = [int(r[2]) for r in rows]
    assert counts == sorted(counts, reverse=True)
    assert rows[0][0] in ("the", "dog")
    id2label = load_glove_keep_vocab(str(tmp_path / "port"), vocab_size=3)
    assert id2label["<unknown>"] == 3 and len(id2label) == 4


def test_clip_count_matches_jax(tmp_path):
    bpe = tmp_path / "bpe.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: tiny", "t h", "th e</w>", "o g</w>", "d og</w>",
                           "r u", "ru n", "run s</w>"]) + "\n")
    _write_annotations(tmp_path / "port", "charades")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    ttools.build_clip_count(str(tmp_path / "port"), "charades", str(bpe))
    jtools.build_clip_count(str(tmp_path / "jax"), "charades", str(bpe))
    name = "CLIP_tokenized_count.txt"
    text = (tmp_path / "port" / name).read_text()
    assert text and text == (tmp_path / "jax" / name).read_text()


def test_command_line(tmp_path, monkeypatch):
    _write_annotations(tmp_path / "ann", "charades")
    monkeypatch.setattr(sys, "argv", ["tools", "glove_count", str(tmp_path / "ann"), "charades"])
    ttools.main()
    assert (tmp_path / "ann" / "GloVe_tokenized_count.txt").exists()
    with pytest.raises(ValueError):
        ttools.build_glove_count(str(tmp_path / "ann"), "unknown")
