"""The row capacity at the default `--n_devices`, the port against the JAX
package, on the CPU (JAX on the 8 virtual devices of tests/conftest.py).

The JAX package rounds the auto row capacity up to a multiple of
`len(jax.devices())` when `--n_devices` is 0 (mesm_tpu/runner.py:75-94);
the port runs on one card and rounds to a multiple of 1. The row capacity
enters the values through the scrambled T2V pair mask, which reads row
(b*H + h) % B. So a checkpoint scored by the JAX package on an 8-device host
is scored the same way by the port only with `--n_devices 8`.

The synthetic charades root here has an eval batch size of 3: 8 videos of
1-3 sentences give an auto row capacity of 6 rows, which the JAX package
pads to 8 on 8 devices. At the port's default (6 rows) the brief metrics on
this root equal the 8-device JAX run's, and only the raw predictions differ
(window scores by about 1e-3 against the port at 8 rows): on a root this
small the ranking survives. `test_port_default_moves_raw_predictions` pins
that, so the difference the flag removes stays visible.
"""
from __future__ import annotations

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_batch, sample_neg_rows
from synth_root import make_charades_root

EVAL_BATCH_SIZE = 3


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A synthetic charades root whose auto row capacity is not a multiple
    of 8, and a 'trained' run dir with opt.json and model_test_best.ckpt
    from a seeded JAX init (as tests/test_torch_eval_cli.py makes it)."""
    from mesm_tpu.config import BaseOptions
    from mesm_tpu.convert import params_to_torch_state_dict
    from mesm_tpu.models.mesm import MESM
    from mesm_tpu.runner import build_model_config

    root = str(tmp_path_factory.mktemp("torch_n_devices"))
    cfg_path = make_charades_root(root)
    with open(cfg_path) as f:
        base = json.load(f)
    base["eval_batch_size"] = EVAL_BATCH_SIZE
    with open(cfg_path, "w") as f:
        json.dump(base, f)
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
    eval_cfg = {
        "is_inference": True, "trained_result_dir": opt.result_dir, "num_workers": 2,
        "resume_all": False, "sort_results": True, "max_ts_val": 150,
        "compute_dtype": "float32", "eval_len_buckets": 1, "ann_path": base["ann_path"],
        "feat_files": base["feat_files"], "bpe_path": "",
        "text_model_path": base["text_model_path"],
    }
    return root, opt, eval_cfg


def _write_cfg(root, eval_cfg, name, **extra):
    path = os.path.join(root, f"{name}.json")
    cfg = dict(eval_cfg, inference_id=name, inference_result_dir=os.path.join(root, name), **extra)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _row_capacity(runner, opt, n_devices: int) -> int:
    opt = type(opt)(**dict(vars(opt), n_devices=n_devices))
    ds = runner.build_dataset(opt, "test", recfw=False, vocab=runner.get_vocab(opt))
    return runner.make_batch_spec(opt, ds, for_eval=True).row_capacity


def test_row_capacity_follows_n_devices(run_dir):
    """(a) JAX at its default (every visible device, 8 here) and the port at
    --n_devices 8 pick one row capacity; JAX at 1 and the port at its default
    pick another, and the auto capacity is not a multiple of 8."""
    from mesm_tpu import runner as jax_runner
    from mesm_tpu_torch import runner as torch_runner

    _, opt, _ = run_dir
    assert len(jax.devices()) == 8
    jax_default = _row_capacity(jax_runner, opt, 0)
    port_default = _row_capacity(torch_runner, opt, 0)
    assert port_default % 8 != 0
    assert jax_default == _row_capacity(torch_runner, opt, 8) == 8
    assert _row_capacity(jax_runner, opt, 1) == port_default


def _torch_brief(root, eval_cfg, name, *extra):
    from mesm_tpu_torch.evaluate import inference as torch_inference

    got, _ = torch_inference(["--config_file", _write_cfg(root, eval_cfg, name), "--device", "cpu",
                              *extra])
    return got["brief"]


@pytest.fixture(scope="module")
def jax_brief(run_dir):
    """mesm_tpu.evaluate at its default --n_devices on the 8-device host."""
    from mesm_tpu.evaluate import inference as jax_inference

    root, _, eval_cfg = run_dir
    with jax.default_matmul_precision("highest"):
        want, _ = jax_inference(["--config_file", _write_cfg(root, eval_cfg, "jax_default")])
    return want["brief"]


def test_port_at_n_devices_8_matches_jax_default(run_dir, jax_brief):
    """(b) The port's inference with --n_devices 8 gives every brief metric
    key of the JAX package's default 8-device run, equal."""
    root, _, eval_cfg = run_dir
    got = _torch_brief(root, eval_cfg, "torch_n8", "--n_devices", "8")
    assert got and set(got) == set(jax_brief)
    for key, value in jax_brief.items():
        assert got[key] == value, f"{key}: port {got[key]} vs jax {value}"


def _raw_windows(root, name):
    [path] = glob.glob(os.path.join(root, name, "*", "*_submission.jsonl"))
    with open(path) as f:
        return [json.loads(line)["pred_relevant_windows"] for line in f]


def test_port_default_moves_raw_predictions(run_dir, jax_brief):
    """At the port's default (one device, 6 rows) the raw predictions are
    not those of the port at 8 rows, while the brief metrics on this root
    still equal the 8-device JAX run's."""
    root, _, eval_cfg = run_dir
    got = _torch_brief(root, eval_cfg, "torch_default")
    assert got == jax_brief
    _torch_brief(root, eval_cfg, "torch_n8_raw", "--n_devices", "8")
    one, eight = _raw_windows(root, "torch_default"), _raw_windows(root, "torch_n8_raw")
    assert len(one) == len(eight)
    assert not np.array_equal(np.asarray(one), np.asarray(eight))
