"""The dot-stats LayerNorm switch (mesm_tpu_torch.kernels.set_dot_stats_ln,
models/layers.apply_ln) against the JAX package's (mesm_tpu/kernels.py:137-159,
mesm_tpu/models/layers.py:90-142): the function in fp32 (1e-5) and bf16 (one
bf16 ulp: the squares are rounded to bf16 on both sides, the sums run in
another order), its gate over a grid of shapes and modes, and a small
charades model's eval forward under "on" (fp32, 1e-4), with the same sites
taking the path on both sides."""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu import kernels as jkernels
from mesm_tpu.models import layers as jlayers
from mesm_tpu_torch import kernels as tkernels
from mesm_tpu_torch.models import layers as tlayers

from test_torch_harness import build_pair, jax_forward, jax_kernels, torch_forward


def _ln_inputs(dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 7, 32)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, scale, bias


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_dot_stats_matches_jax(dtype):
    x, scale, bias = _ln_inputs(dtype)
    x = x.copy()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jlayers.ln_dot_stats(jnp.asarray(x, jdt), jnp.asarray(scale),
                                           jnp.asarray(bias), 1e-5).astype(jnp.float32))
    got_t = tlayers.ln_dot_stats(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                                 torch.from_numpy(bias), 1e-5)
    assert got_t.dtype == tdt
    got = got_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


def test_ln_dot_stats_squares_in_the_input_dtype():
    """In bf16 the squares are rounded to bf16 before the f32 sum: on an
    input whose squares need more than 8 significant bits the port's result
    equals the JAX function's bit for bit."""
    x = torch.full((1, 4), 1.0 + 2.0**-7, dtype=torch.bfloat16)
    x[0, 1] = 3.0
    w, b = torch.ones(4), torch.zeros(4)
    got = tlayers.ln_dot_stats(x, w, b, 1e-5).float().numpy()
    want = np.asarray(jlayers.ln_dot_stats(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                           jnp.ones(4), jnp.zeros(4), 1e-5).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@contextlib.contextmanager
def dot_stats(enabled: bool, min_rows: int = None):
    """The switch (and, where given, the row gate) set in both packages."""
    saved = [(m, m.DOT_STATS_LN, m.DOT_STATS_MIN_ROWS) for m in (jkernels, tkernels)]
    for m in (jkernels, tkernels):
        m.set_dot_stats_ln(enabled)
        if min_rows is not None:
            m.DOT_STATS_MIN_ROWS = min_rows
    try:
        yield
    finally:
        for m, on, rows in saved:
            m.set_dot_stats_ln(on)
            m.DOT_STATS_MIN_ROWS = rows


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_gate_matches_jax(mode, enabled):
    """Every (rows, d) of a grid around the gates, the port's CPU tensors
    against the JAX package on its CPU backend."""
    with dot_stats(enabled), jkernels.pallas_scope(mode), tkernels.pallas_scope(mode):
        for rows in (1, 4095, 4096, 24832, 24960):
            for d in (16, 256, 512, 513, 2818):
                assert (tkernels.use_dot_stats_ln(rows, d, "cpu")
                        == jkernels.use_dot_stats_ln(rows, d)), (rows, d)


def test_auto_takes_cuda_tensors_only():
    with dot_stats(True), tkernels.pallas_scope("auto"):
        assert tkernels.use_dot_stats_ln(24960, 256, torch.device("cuda"))
        assert not tkernels.use_dot_stats_ln(24960, 256, "cpu")
        assert not tkernels.use_dot_stats_ln(4095, 256, torch.device("cuda"))


def test_training_keeps_the_layer_norm():
    norm = tlayers.LayerNorm(32, eps=1e-5)
    x = torch.from_numpy(_ln_inputs("float32")[0])
    before = tlayers.dot_stats_calls
    with dot_stats(True, min_rows=1), tkernels.pallas_scope("on"):
        y = tlayers.apply_ln(norm, x, training=True)
    assert tlayers.dot_stats_calls == before
    torch.testing.assert_close(y, norm(x), atol=0, rtol=0)


@pytest.fixture(scope="module")
def pair():
    with jax.default_matmul_precision("highest"):
        yield build_pair()


def test_model_forward_matches_jax_under_on(pair, monkeypatch):
    """The eval forward with dot stats on every routed site (the row gate at
    1 on both sides, so the small model's sites are in range), the JAX
    package's under pallas_scope("on") against the port's; the number of
    LayerNorm calls that took the path is the same on both sides."""
    jcfg, params, tmodel, batch = pair
    calls = []
    orig = jlayers.ln_dot_stats

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jlayers, "ln_dot_stats", counted)
    before = tlayers.dot_stats_calls
    with dot_stats(True, min_rows=1), jax.default_matmul_precision("highest"), \
            jax_kernels("on"), tkernels.pallas_scope("on"):
        want = jax_forward(jcfg, params, batch)
        got = torch_forward(tmodel, batch)
    assert calls and tlayers.dot_stats_calls - before == len(calls)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0, err_msg=key)
