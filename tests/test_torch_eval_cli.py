"""End to end on the CPU: the port's `inference` entry point against the JAX
package's on the same synthetic charades root and the same checkpoint.

The checkpoint is an upstream-layout torch file made from a JAX init with
mesm_tpu.convert.params_to_torch_state_dict; mesm_tpu.evaluate converts it
to flax params, the port loads it as it is. fp32, one length bucket, one
device (so both batchers pick the same row capacity, which the scrambled
T2V pair mask depends on). Every brief metric key must be equal, with and
without NMS.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_batch, sample_neg_rows
from synth_root import make_charades_root


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A synthetic charades root and a 'trained' run dir holding opt.json
    and model_test_best.ckpt from a seeded JAX init."""
    from mesm_tpu.config import BaseOptions
    from mesm_tpu.convert import params_to_torch_state_dict
    from mesm_tpu.models.mesm import MESM
    from mesm_tpu.runner import build_model_config

    root = str(tmp_path_factory.mktemp("torch_cli"))
    cfg_path = make_charades_root(root)
    opt = BaseOptions().parse(["--config_file", cfg_path])  # writes opt.json
    cfg = build_model_config(opt)
    batch = make_batch(np.random.default_rng(0), B=4, Lv=12, Dv=cfg.v_feat_dim,
                       Lw=cfg.max_words_l, Dt=cfg.t_feat_dim, G=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    neg = jnp.asarray(sample_neg_rows(np.random.default_rng(1), batch["group_id"]))
    params = MESM(cfg).init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(1),
         "mask_words": jax.random.PRNGKey(2)},
        jb["video_feat"], jb["video_mask"], jb["words_feat"], jb["words_mask"],
        jb["sentence_feat"], neg, is_training=True, deterministic=True,
        clip_mask=jb["clip_mask"], words_weight=jb["words_weight"],
        unknown_mask=jb["unknown_mask"], ss_sent_idx=jb["ss_sent_idx"],
        ss_sent_mask=jb["ss_sent_mask"], ss_own_pos=jb["ss_own_pos"],
    )["params"]
    sd = params_to_torch_state_dict(jax.device_get(params), cfg)
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, "epoch": 0},
               os.path.join(opt.result_dir, "model_test_best.ckpt"))
    with open(cfg_path) as f:
        base = json.load(f)
    eval_cfg = {
        "is_inference": True,
        "trained_result_dir": opt.result_dir,
        "num_workers": 2,
        "resume_all": False,
        "sort_results": True,
        "max_ts_val": 150,
        "compute_dtype": "float32",
        "eval_len_buckets": 1,
        "n_devices": 1,
        "ann_path": base["ann_path"],
        "feat_files": base["feat_files"],
        "bpe_path": "",
        "text_model_path": base["text_model_path"],
    }
    return root, eval_cfg


def _write_cfg(root, eval_cfg, name, **extra):
    path = os.path.join(root, f"{name}.json")
    cfg = dict(eval_cfg, inference_id=name, inference_result_dir=os.path.join(root, name), **extra)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("nms_thd", [-1, 0.7])
def test_inference_matches_jax(run_dir, nms_thd):
    from mesm_tpu.evaluate import inference as jax_inference
    from mesm_tpu_torch.evaluate import inference as torch_inference

    root, eval_cfg = run_dir
    with jax.default_matmul_precision("highest"):
        want, want_nms = jax_inference(
            ["--config_file", _write_cfg(root, eval_cfg, f"jax{nms_thd}", nms_thd=nms_thd)]
        )
    got, got_nms = torch_inference(
        ["--config_file", _write_cfg(root, eval_cfg, f"torch{nms_thd}", nms_thd=nms_thd),
         "--device", "cpu"]
    )
    assert got["brief"] and set(got["brief"]) == set(want["brief"])
    for key, value in want["brief"].items():
        assert got["brief"][key] == value, f"{key}: port {got['brief'][key]} vs jax {value}"
    if nms_thd == -1:
        assert got_nms is None and want_nms is None
    else:
        assert got_nms["brief"] == want_nms["brief"]
