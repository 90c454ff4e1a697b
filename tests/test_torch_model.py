"""The port's MESM inference forward against the JAX package's, and the ways
weights reach it.

One JAX init of a small charades config (tests/test_torch_harness.py) is carried
across with state_dict_from_jax_params and loaded strictly. The forward is
the deduplicated-video inference route (video_feat_g / video_slot,
compute_neg=False). fp32, JAX at matmul precision "highest"; every output
key within 1e-4 abs, with the JAX package's kernels off and on (its Pallas
kernels in interpret mode).
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import pytest
import torch

from mesm_tpu.convert import params_to_torch_state_dict, stack_scanned
from mesm_tpu_torch import kernels as tkernels
from mesm_tpu_torch.convert import load_mesm_checkpoint, state_dict_from_jax_params
from mesm_tpu_torch.models.mesm import MESM as TorchMESM
from mesm_tpu_torch.models.mesm import MESMConfig as TorchConfig

from test_torch_harness import SMALL, build_pair, jax_forward, jax_kernels, torch_forward

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    with jax.default_matmul_precision("highest"):
        yield build_pair()


@pytest.mark.parametrize("mode", ["off", "on"])
def test_mesm_forward_matches_jax(pair, mode):
    jcfg, params, tmodel, batch = pair
    with jax.default_matmul_precision("highest"), jax_kernels(mode), tkernels.pallas_scope(mode):
        want = jax_forward(jcfg, params, batch)
        got = torch_forward(tmodel, batch)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0, err_msg=key)


def test_mesm_forward_per_row_route_matches_dedup(pair):
    """Replicated per-row video_feat gives the same outputs as the
    deduplicated video_feat_g route."""
    _, _, tmodel, batch = pair
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        rows = tmodel(t["video_mask"], t["words_feat"], t["words_mask"], t["sentence_feat"],
                      video_feat=t["video_feat"], ss_sent_idx=t["ss_sent_idx"],
                      ss_sent_mask=t["ss_sent_mask"], ss_own_pos=t["ss_own_pos"])
    dedup = torch_forward(tmodel, batch)
    for key, v in dedup.items():
        np.testing.assert_allclose(rows[key].numpy(), v, atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_mesm_bf16_forward_matches_jax(pair, mode):
    """bf16, the serving dtype on the GPU: features staged in bf16, f32
    weights cast at use, on both sides. Under "on" both run the packed
    attention's bf16 softmax (JAX's Pallas kernel in interpret mode, the
    port's plain version of its CUDA kernel). Tolerance 0.05 abs: bf16 keeps
    8 mantissa bits, the outputs are O(1), and the two sides round at some
    different points (LayerNorm, bias adds, sums in another order)."""
    jcfg, params, tmodel, batch = pair
    with jax_kernels(mode), tkernels.pallas_scope(mode):
        want = jax_forward(jcfg, params, batch, bf16=True)
        got = torch_forward(tmodel, batch, bf16=True)
    for key in want:
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], atol=0.05, rtol=0, err_msg=key)


def test_upstream_layout_checkpoint_loads_strictly(pair, tmp_path):
    """An upstream-layout .ckpt ({model, optimizer, lr_scheduler, epoch,
    opt}, a module the config never runs left in) loads with no conversion."""
    jcfg, params, tmodel, _ = pair
    sd = {k: torch.from_numpy(np.array(v)) for k, v in params_to_torch_state_dict(params, jcfg).items()}
    sd["vid_position_embed.dummy"] = torch.zeros(1)
    path = tmp_path / "model_test_best.ckpt"
    torch.save({"model": sd, "optimizer": {}, "lr_scheduler": {}, "epoch": 7,
                "opt": argparse.Namespace(hidden_dim=SMALL["hidden_dim"])}, path)
    state, epoch = load_mesm_checkpoint(str(path), tmodel.cfg)
    assert epoch == 7
    fresh = TorchMESM(tmodel.cfg)
    fresh.load_state_dict(state, strict=True)
    for key, value in tmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("overrides", [
    {"share_mlp": False, "use_txt_pos": True},
    {"rec_fw": False, "rec_ss": False},
])
def test_state_dict_from_jax_params_covers_variants(overrides):
    """TwoMLP + trainable text positions, and a config without the
    FW/SS branches: every key of the port's model is filled, and the
    scan-layout tree converts to the same state dict."""
    jcfg, params, tmodel, _ = build_pair(**overrides)
    sd = state_dict_from_jax_params(params, tmodel.cfg)
    assert set(sd) == set(tmodel.state_dict())
    scanned = stack_scanned(jax.tree.map(np.array, params), jcfg)
    for key, value in state_dict_from_jax_params(scanned, tmodel.cfg).items():
        torch.testing.assert_close(value, sd[key], rtol=0, atol=0)
    assert isinstance(tmodel.cfg, TorchConfig)
