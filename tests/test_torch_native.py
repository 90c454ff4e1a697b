"""The port's native host module (mesm_tpu_torch/native: its own copy of
module.cpp, built by g++ at first use) against the numpy / Python paths and
against mesm_tpu.native, on the cases of tests/test_native.py, and wired in
where the JAX package wires its own: postprocess.temporal_nms,
metrics.average_precision_detection and datasets.mean_pool_downsample."""
from __future__ import annotations

import os

import numpy as np
import pytest

from mesm_tpu import native as jnative
from mesm_tpu_torch import native as tnative
from mesm_tpu_torch.data.datasets import mean_pool_downsample
from mesm_tpu_torch.metrics import average_precision_detection
from mesm_tpu_torch.postprocess import temporal_nms

from test_native import _py_ap, _py_nms


@pytest.fixture(scope="module")
def nat():
    mod = tnative.get_native()
    if mod is None:
        pytest.skip("no C++ toolchain on this host")
    assert os.path.exists(tnative.SO_PATH)
    assert tnative.SO_PATH.startswith(os.path.join(os.path.dirname(tnative.__file__), "_build"))
    return mod


@pytest.fixture
def numpy_paths(monkeypatch):
    """The callers' numpy / Python paths: the native module reported absent."""
    def off():
        monkeypatch.setattr(tnative, "get_native", lambda: None)
    return off


def _numpy_mean_pool(feat, M):
    L, D = feat.shape
    idxs = np.round(np.arange(0, M + 1) / M * L).clip(max=L - 1).astype(int)
    s, e = idxs[:-1], idxs[1:]
    cs = np.concatenate([np.zeros((1, D), np.float32), np.cumsum(feat, 0)])
    slow = (cs[e] - cs[s]) / (e - s).clip(min=1)[:, None]
    deg = s >= e
    slow[deg] = feat[s[deg]]
    return slow


def test_mean_pool_matches_numpy_and_jax(nat, numpy_paths):
    rng = np.random.default_rng(0)
    cases = []
    for L, D, M in [(37, 5, 10), (1402, 16, 600), (21, 3, 20)]:
        feat = rng.normal(size=(L, D)).astype(np.float32)
        fast = tnative.mean_pool_native(feat, M)
        np.testing.assert_allclose(fast, _numpy_mean_pool(feat, M), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(fast, jnative.mean_pool_native(feat, M))
        np.testing.assert_array_equal(mean_pool_downsample(feat, M), fast)
        cases.append((feat, M, fast))
    numpy_paths()
    for feat, M, fast in cases:
        np.testing.assert_allclose(mean_pool_downsample(feat, M), fast, rtol=1e-4, atol=1e-5)


def test_nms_matches_python_and_jax(nat, numpy_paths):
    rng = np.random.default_rng(1)
    cases = []
    for _ in range(30):
        n = int(rng.integers(2, 25))
        st = rng.uniform(0, 100, n)
        ed = st + rng.uniform(1, 40, n)
        sc = rng.uniform(0, 1, n)
        preds = np.stack([st, ed, sc], -1).tolist()
        idx = tnative.temporal_nms_native(np.asarray(preds), 0.5, 10)
        assert idx == jnative.temporal_nms_native(np.asarray(preds), 0.5, 10)
        assert [preds[i] for i in idx] == _py_nms(preds, 0.5, 10)
        assert temporal_nms(preds, 0.5, 10) == _py_nms(preds, 0.5, 10)
        cases.append(preds)
    numpy_paths()
    for preds in cases:
        assert temporal_nms(preds, 0.5, 10) == _py_nms(preds, 0.5, 10)


def test_ap_matches_python_and_jax(nat, numpy_paths):
    rng = np.random.default_rng(2)
    thds = np.linspace(0.5, 0.95, 10)
    cases = []
    for _ in range(20):
        gts, preds = [], []
        for _ in range(int(rng.integers(1, 5))):
            st = rng.uniform(0, 80)
            gts.append({"video-id": "q", "t-start": st, "t-end": st + rng.uniform(2, 30)})
        for _ in range(int(rng.integers(1, 12))):
            st = rng.uniform(0, 80)
            preds.append({"video-id": "q", "t-start": st, "t-end": st + rng.uniform(2, 30),
                          "score": float(rng.uniform(0, 1))})
        p = np.array([[x["t-start"], x["t-end"], x["score"]] for x in preds])
        g = np.array([[x["t-start"], x["t-end"]] for x in gts])
        fast = tnative.ap_detection_native(p, g, thds)
        np.testing.assert_array_equal(fast, jnative.ap_detection_native(p, g, thds))
        np.testing.assert_allclose(fast, _py_ap(gts, preds, thds), atol=1e-9)
        np.testing.assert_array_equal(average_precision_detection(gts, preds, thds), fast)
        cases.append((gts, preds, fast))
    numpy_paths()
    for gts, preds, fast in cases:
        np.testing.assert_allclose(average_precision_detection(gts, preds, thds), fast, atol=1e-9)


def test_wrappers_return_none_without_the_module(numpy_paths):
    numpy_paths()
    assert tnative.temporal_nms_native(np.zeros((2, 3)), 0.5, 10) is None
    assert tnative.ap_detection_native(np.zeros((1, 3)), np.zeros((1, 2)), np.ones(1)) is None
    assert tnative.mean_pool_native(np.zeros((4, 2), np.float32), 2) is None
