"""The port's QVHighlights entry points on the CPU, on the synthetic qvh root
of tests/test_e2e_qvh.py (multi-window targets, 3-annotator saliency, each
group's concatenated clips as the SS-MESM video).

- `mesm_tpu_torch.evaluate.inference` against `mesm_tpu.evaluate.inference`
  on the same root and the same checkpoint (an upstream-layout torch file
  made from a seeded JAX init): every brief metric key equal, fp32, one
  device; the submission rows carry `pred_relevant_windows` and
  `pred_saliency_scores`.
- `mesm_tpu_torch.train.train` runs one epoch (Hungarian matching, the
  multi-clip losses) with `--device cpu` and writes checkpoints that the
  evaluate entry point scores.
"""
from __future__ import annotations

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_batch, sample_neg_rows
from test_e2e_qvh import make_qvh_root


@pytest.fixture(scope="module")
def qvh_run(tmp_path_factory):
    """A synthetic qvh root and a run dir holding opt.json and
    model_val_best.ckpt from a seeded JAX init."""
    from mesm_tpu.config import BaseOptions
    from mesm_tpu.convert import params_to_torch_state_dict
    from mesm_tpu.models.mesm import MESM
    from mesm_tpu.runner import build_model_config

    root = str(tmp_path_factory.mktemp("torch_qvh_cli"))
    cfg_path = make_qvh_root(root)
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
               os.path.join(opt.result_dir, "model_val_best.ckpt"))
    with open(cfg_path) as f:
        base = json.load(f)
    eval_cfg = {
        "is_inference": True, "trained_result_dir": opt.result_dir, "num_workers": 2,
        "resume_all": False, "sort_results": True, "compute_dtype": "float32",
        "eval_len_buckets": 1, "n_devices": 1, "ann_path": base["ann_path"],
        "feat_files": base["feat_files"], "bpe_path": "", "text_model_path": base["text_model_path"],
    }
    return root, cfg_path, eval_cfg


def _write_cfg(root, eval_cfg, name, **extra):
    path = os.path.join(root, f"{name}.json")
    cfg = dict(eval_cfg, inference_id=name, inference_result_dir=os.path.join(root, name), **extra)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _submission(inference_dir):
    (path,) = glob.glob(os.path.join(inference_dir, "*", "qvhighlights_val_test_submission.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_qvh_inference_matches_jax(qvh_run):
    from mesm_tpu.evaluate import inference as jax_inference
    from mesm_tpu_torch.evaluate import inference as torch_inference

    root, _, eval_cfg = qvh_run
    with jax.default_matmul_precision("highest"):
        want, _ = jax_inference(["--config_file", _write_cfg(root, eval_cfg, "jax")])
    got, got_nms = torch_inference(
        ["--config_file", _write_cfg(root, eval_cfg, "torch"), "--device", "cpu"]
    )
    assert got_nms is None
    assert got["brief"] and set(got["brief"]) == set(want["brief"])
    for key, value in want["brief"].items():
        assert got["brief"][key] == value, f"{key}: port {got['brief'][key]} vs jax {value}"
    rows = _submission(os.path.join(root, "torch"))
    assert rows and len(rows) == len(_submission(os.path.join(root, "jax")))
    for row in rows:
        assert {"qid", "vid", "pred_relevant_windows", "pred_saliency_scores"} <= set(row)
        assert np.isfinite(np.asarray(row["pred_relevant_windows"])).all()
        assert len(row["pred_saliency_scores"]) > 0


def test_qvh_train_one_epoch_then_evaluate(qvh_run):
    from mesm_tpu_torch.convert import load_mesm_checkpoint
    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.train import train

    root, cfg_path, _ = qvh_run
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(exp_id="torch_train", n_epoch=1)
    train_cfg = os.path.join(root, "train_one.json")
    with open(train_cfg, "w") as f:
        json.dump(cfg, f)
    res = train(["--config_file", train_cfg, "--device", "cpu"])
    run_dir = res["opt"].result_dir
    assert res["step"] > 0 and res["epoch"] == 0
    with open(res["opt"].train_log_filepath) as f:
        line = [l for l in f if "loss_overall" in l][-1]
    toks = line.split()
    assert np.isfinite(float(toks[toks.index("loss_overall") + 1]))
    assert "loss_rec_ss" in line and "loss_saliency" in line and "loss_span_0" in line
    latest = os.path.join(run_dir, "model_latest.ckpt")
    state, epoch = load_mesm_checkpoint(latest, res["model"].cfg)
    assert epoch == 0
    for key, value in res["model"].state_dict().items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    # a random model's scores may never improve on 0, and then the run
    # writes no best checkpoint: evaluate reads the latest one in its place
    scored = os.path.join(root, "scored_run")
    os.makedirs(scored)
    shutil.copy(os.path.join(run_dir, "opt.json"), scored)
    shutil.copy(latest, os.path.join(scored, "model_val_best.ckpt"))
    opt = res["opt"]
    eval_cfg = os.path.join(root, "eval_trained.json")
    with open(eval_cfg, "w") as f:
        json.dump({"trained_result_dir": scored, "inference_id": "trained",
                   "inference_result_dir": os.path.join(root, "trained"), "eval_len_buckets": 1,
                   "ann_path": opt.ann_path, "feat_files": opt.feat_files,
                   "text_model_path": opt.text_model_path, "bpe_path": ""}, f)
    metrics, _ = inference(["--config_file", eval_cfg, "--device", "cpu"])
    assert metrics["brief"]["MR-full-mAP"] is not None
