"""Native host-runtime components (C++ through the CPython C API).

Counterpart of mesm_tpu/native/__init__.py, built from the port's own copy
of module.cpp: temporal NMS (postprocess.temporal_nms), per-query AP
detection (metrics.average_precision_detection) and per-item mean-pool
downsampling (data/datasets.mean_pool_downsample). This is host code, not a
device kernel. The module is compiled by g++ at first use into `_build/`
beside this file (rebuilt when module.cpp is newer); where the build or
the import fails, each wrapper returns None and its caller takes the numpy
path, which stays as the JAX package keeps it.
"""
from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig
import tempfile
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "module.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
SO_PATH = os.path.join(BUILD_DIR, f"_mesm_native{sysconfig.get_config_var('EXT_SUFFIX') or '.so'}")

_native = None
_tried = False


def _build() -> bool:
    """g++ into a temporary file in BUILD_DIR, then renamed over SO_PATH, so
    processes that build at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"native build failed ({e}); using the numpy paths")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_native():
    """The compiled module, or None (the callers take their numpy paths)."""
    global _native, _tried
    if _native is not None or _tried:
        return _native
    _tried = True
    if not os.path.exists(SO_PATH) or os.path.getmtime(SO_PATH) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        spec = importlib.util.spec_from_file_location("_mesm_native", SO_PATH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _native = mod
    except ImportError as e:
        logger.warning(f"native import failed ({e}); using the numpy paths")
    return _native


def temporal_nms_native(windows: np.ndarray, thd: float, max_after: int) -> Optional[List[int]]:
    nat = get_native()
    if nat is None:
        return None
    w = np.ascontiguousarray(windows, dtype=np.float64)
    return nat.temporal_nms(w, float(thd), int(max_after))


def ap_detection_native(preds: np.ndarray, gts: np.ndarray, thds: np.ndarray) -> Optional[np.ndarray]:
    nat = get_native()
    if nat is None:
        return None
    p = np.ascontiguousarray(preds, dtype=np.float64).reshape(-1, 3)
    g = np.ascontiguousarray(gts, dtype=np.float64).reshape(-1, 2)
    t = np.ascontiguousarray(thds, dtype=np.float64).reshape(-1, 1)
    return np.asarray(nat.ap_detection(p, g, t))


def mean_pool_native(feat: np.ndarray, max_len: int) -> Optional[np.ndarray]:
    nat = get_native()
    if nat is None:
        return None
    f = np.ascontiguousarray(feat, dtype=np.float32)
    raw = nat.mean_pool(f, int(max_len))
    return np.frombuffer(raw, dtype=np.float32).reshape(max_len, f.shape[1]).copy()
