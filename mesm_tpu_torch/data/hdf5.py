"""Feature store: HDF5 files with persistent handles, or directories of
per-video .npy arrays.

The reference opens the HDF5 file on EVERY __getitem__ call
(reference dataset/charades.py:108-119, dataset/qvhighlights.py:201-211) —
a measured hot spot (BASELINE.md). Here each (process, thread, file) triple
keeps one open handle: h5py handles are not thread-safe for concurrent reads
of the same handle, so instead of serializing all reads behind one lock we
give every loader thread its own handle set — reads on different threads
(and different files) overlap fully.

A feature "file" that is a directory holds one `<video_id>.npy` per video,
read through a memory map: the same rows, for hosts without h5py.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import h5py
except ImportError:  # the .npy-directory stores need no h5py
    h5py = None


class _NpyDir:
    """A directory of `<video_id>.npy` arrays behind the h5py File calls the
    store makes: `store[video_id]` (a memory map, so `.shape` and row slices
    read no more than they need), `keys()` and `close()`."""

    def __init__(self, path: str):
        self.path = path

    def __getitem__(self, video_id: str) -> np.ndarray:
        return np.load(os.path.join(self.path, f"{video_id}.npy"), mmap_mode="r")

    def keys(self):
        return sorted(f[:-4] for f in os.listdir(self.path) if f.endswith(".npy"))

    def close(self):
        pass


class FeatureStore:
    """Reads per-video features from one or more HDF5 files (or .npy
    directories), concatenating feature dims (multi-extractor fusion,
    truncated to the shortest stream — reference
    dataset/charades.py:117-119)."""

    def __init__(self, feat_files: Sequence[str], normalize: bool = False):
        if h5py is None and not all(os.path.isdir(p) for p in feat_files):
            raise RuntimeError("h5py is required for HDF5 feature stores")
        self.feat_files = list(feat_files)
        self.normalize = normalize
        self._local = threading.local()

    def __getstate__(self):
        # picklable across processes (spawn-style pools / checkpoint tooling):
        # drop the thread-local handle set; the pid check in _handles()
        # re-opens lazily on the other side
        state = dict(self.__dict__)
        state.pop("_local", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    def _handles(self) -> Dict[str, "h5py.File"]:
        # one handle set per (process, thread); re-open after fork (h5py
        # handles cannot cross processes) and never share across threads
        if getattr(self._local, "pid", None) != os.getpid():
            self._local.handles = {}
            self._local.pid = os.getpid()
        return self._local.handles

    def _handle(self, path: str):
        handles = self._handles()
        h = handles.get(path)
        if h is None:
            h = _NpyDir(path) if os.path.isdir(path) else h5py.File(path, "r")
            handles[path] = h
        return h

    def get(self, video_id: str, max_len: Optional[int] = None) -> np.ndarray:
        feats: List[np.ndarray] = []
        for path in self.feat_files:
            ds = self._handle(path)[video_id]
            arr = ds[:max_len] if max_len is not None else ds[:]
            feats.append(np.asarray(arr, dtype=np.float32))
        min_len = min(f.shape[0] for f in feats)
        feats = [f[:min_len] for f in feats]
        out = np.concatenate(feats, axis=1) if len(feats) > 1 else feats[0]
        if self.normalize:
            norm = np.linalg.norm(out, axis=1, keepdims=True)
            out = out / np.maximum(norm, 1e-12)
        return out

    def length(self, video_id: str, max_len: Optional[int] = None) -> int:
        """Feature row count from HDF5 shape METADATA only (no data read):
        min over files of the dataset's leading dim (`get` truncates to the
        shortest stream), capped at max_len. Lets callers predict padded
        batch shapes without paying a feature read."""
        n = min(self._handle(p)[video_id].shape[0] for p in self.feat_files)
        return int(n if max_len is None else min(n, max_len))

    def keys(self) -> List[str]:
        return list(self._handle(self.feat_files[0]).keys())

    def close(self):
        """Close the calling thread's handles (other threads' handles are
        released when they exit / at process teardown — read-only, safe)."""
        handles = self._handles()
        for h in handles.values():
            try:
                h.close()
            except Exception:
                pass
        self._local.handles = {}


def normalize_rows(feat: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(feat, axis=1, keepdims=True)
    return feat / np.maximum(norm, 1e-12)
