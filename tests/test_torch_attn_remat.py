"""The training attention core under torch.utils.checkpoint
(mesm_tpu_torch.kernels.ATTN_REMAT, models/attention.dispatch_attention_core)
against the plain core and the JAX package's jax.checkpoint'd core
(mesm_tpu/models/attention.py:296-319, mesm_tpu/kernels.py:216-254): values
and gradients equal to the plain core's at dropout 0.1 from one torch seed
(the checkpoint replays the forward's dropout mask), equal to JAX's at
dropout 0 (1e-5), and the gate over a grid of lengths."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu import kernels as jkernels
from mesm_tpu.models.attention import _attention_core_remat
from mesm_tpu_torch import kernels as tkernels
from mesm_tpu_torch.models import attention as tattention

B, LQ, LK, E, H = 2, 128, 130, 32, 4


@pytest.fixture(autouse=True)
def grad_mode_on():
    """Gradients on, whatever grad mode an earlier test in the process left."""
    with torch.enable_grad():
        yield


def _inputs(seed: int = 31):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, LQ, E), (B, LK, E), (B, LK, E)))
    mask = np.ones((B, LK), bool)
    mask[1, 100:] = False
    return q, k, v, mask


def _torch_value_and_grads(remat: bool, dropout: float, monkeypatch, seed: int = 7):
    monkeypatch.setattr(tkernels, "ATTN_REMAT", remat)
    q, k, v, mask = _inputs()
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.manual_seed(seed)
    before = tattention.remat_calls
    out = tattention.dispatch_attention_core(*args, H, key_valid_mask=torch.from_numpy(mask),
                                             dropout_rate=dropout, training=True)
    loss = (out ** 2).sum()
    loss.backward()
    return loss.detach(), [a.grad for a in args], tattention.remat_calls - before


def test_remat_equals_plain_core_with_dropout(monkeypatch):
    loss0, g0, n0 = _torch_value_and_grads(False, 0.1, monkeypatch)
    loss1, g1, n1 = _torch_value_and_grads(True, 0.1, monkeypatch)
    assert (n0, n1) == (0, 1)
    torch.testing.assert_close(loss1, loss0, atol=1e-6, rtol=1e-6)
    for a, b, name in zip(g1, g0, "qkv"):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=f"grad d{name}")


def test_remat_matches_jax_at_dropout_0(monkeypatch):
    q, k, v, mask = _inputs()
    loss_t, grads_t, n = _torch_value_and_grads(True, 0.0, monkeypatch)
    assert n == 1

    def loss(q, k, v):
        out = _attention_core_remat(q, k, v, num_heads=H, key_valid_mask=jnp.asarray(mask),
                                    dropout_rate=0.0, deterministic=False)
        return jnp.sum(out ** 2)

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for a, b, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0,
                                   err_msg=f"grad d{name}")


def test_eval_never_remats(monkeypatch):
    monkeypatch.setattr(tkernels, "ATTN_REMAT", True)
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs())
    before = tattention.remat_calls
    tattention.dispatch_attention_core(q, k, v, H, key_valid_mask=mask, dropout_rate=0.1,
                                       training=False)
    assert tattention.remat_calls == before


@pytest.mark.parametrize("enabled", [False, True])
def test_gate_matches_jax(enabled, monkeypatch):
    monkeypatch.setattr(tkernels, "ATTN_REMAT", enabled)
    monkeypatch.setattr(jkernels, "ATTN_REMAT", enabled)
    for training in (False, True):
        for lq in (1, 10, 127, 128, 195, 601):
            for lk in (1, 17, 127, 128, 195):
                assert (tkernels.use_attn_remat(lq, lk, training)
                        == jkernels.use_attn_remat(lq, lk, deterministic=not training)), (lq, lk)
