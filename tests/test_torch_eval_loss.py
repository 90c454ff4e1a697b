"""The trainer's eval loss, on the CPU: the port's eval step built with_loss
against the JAX package's `make_eval_step(..., with_loss=True)`.

Both families of tests/test_torch_train.py (charades; TACoS-style with the
TwoMLP enhance encoder and the saliency triplet), one JAX init carried into
the port, fp32 (JAX at matmul precision "highest", torch without TF32), the
deduplicated-video eval batch with its targets. The JAX step draws its
negatives from `fold_in(rng, 0)`; the same draw is injected into the port.
Every loss term, loss_overall and the predictions: 1e-4 in units of
max(1, max |JAX|). Then the train entry point: its eval log carries the
loss line, and a run where torch.utils.tensorboard does not import warns
and goes on.
"""
from __future__ import annotations

import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.models.mesm import MESM as JaxMESM
from mesm_tpu.parallel.step import make_eval_step as jax_make_eval_step
from mesm_tpu.parallel.step import sample_out_of_group as jax_sample_out_of_group
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.parallel.step import make_eval_step

from synth_root import make_charades_root
from test_torch_harness import build_pair, torch_batch, train_batch
from test_torch_train import CRITERIA, MODELS

TOL = 1e-4


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def _eval_batch():
    """The train harness batch as the eval collate stages it: unique videos
    (video_feat_g, video_slot) and no per-row video."""
    batch = train_batch()
    batch.pop("video_feat")
    return batch


_PAIRS = {}


def _pair(name):
    """(jax config, params, port model) of a family, built once."""
    if name not in _PAIRS:
        with jax.default_matmul_precision("highest"):
            _PAIRS[name] = build_pair(**MODELS[name])[:3]
    return _PAIRS[name]


@pytest.mark.parametrize("name", ["charades", "tacos"])
def test_eval_losses_match_jax(name):
    jcfg, params, tmodel = _pair(name)
    with jax.default_matmul_precision("highest"):
        batch = _eval_batch()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        rng = jax.random.PRNGKey(7)
        step = jax_make_eval_step(JaxMESM(jcfg), JaxCriterionConfig(**CRITERIA[name]),
                                  lambda frozen, b: (b["words_feat"], b["words_mask"],
                                                     b["sentence_feat"]), with_loss=True)
        jpreds, jlosses = step(params, {}, jb, rng)
        neg = jax_sample_out_of_group(jax.random.fold_in(rng, 0), jb["group_id"], jb["row_mask"])
    neg = np.asarray(neg)
    assert (batch["group_id"][neg] != batch["group_id"]).all()
    eval_step = make_eval_step(tmodel, _encode, torch.float32, CriterionConfig(**CRITERIA[name]),
                               with_loss=True)
    preds, losses = eval_step(torch_batch(batch), neg_idx_rows=torch.from_numpy(neg))
    jlosses = jax.tree.map(np.asarray, jlosses)
    assert set(losses) == set(jlosses) and "loss_overall" in losses
    assert not any(k.startswith("loss_rec_fw") for k in losses)  # MLM is train-only
    for key, want in jlosses.items():
        assert _err(losses[key].numpy(), want) <= TOL, (key, float(losses[key]), float(want))
    for key, want in jpreds.items():
        assert _err(preds[key].float().numpy(), np.asarray(want, np.float32)) <= TOL, key


def test_eval_step_draws_its_negatives_from_its_seed():
    """Without injected negatives, every call draws the same out-of-group
    rows from the step's seed (the JAX step uses one key for every batch),
    and the predictions are those of the step built without the loss (the
    positive rows of the stacked pass, to fp32 rounding)."""
    tmodel = _pair("charades")[2]
    batch = torch_batch(_eval_batch())
    ccfg = CriterionConfig(**CRITERIA["charades"])
    a = make_eval_step(tmodel, _encode, torch.float32, ccfg, with_loss=True, seed=3)
    b = make_eval_step(tmodel, _encode, torch.float32, ccfg, with_loss=True, seed=4)
    (pa, la), (pa2, la2), (_, lb) = a(batch), a(batch), b(batch)
    assert all(torch.equal(la[k], la2[k]) for k in la)
    assert any(not torch.equal(la[k], lb[k]) for k in ("loss_saliency", "loss_overall"))
    plain = make_eval_step(tmodel, _encode, torch.float32)(batch)
    assert set(plain) == set(pa)
    for key in plain:
        assert _err(pa[key].numpy(), plain[key].numpy()) <= 1e-5, key


def test_train_logs_the_eval_loss_and_runs_without_tensorboard(tmp_path, monkeypatch, caplog):
    """`train` writes the eval loss beside the metrics (mesm_tpu/train.py:
    334-354); with torch.utils.tensorboard unimportable it warns and goes on."""
    from mesm_tpu_torch.train import train

    cfg_path = make_charades_root(str(tmp_path))
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(n_epoch=1, stop_score="miou", exp_id="eval_loss")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING, logger="mesm_tpu_torch.train"):
        res = train(["--config_file", cfg_path, "--device", "cpu"])
    assert any("tensorboard unavailable" in r.getMessage() for r in caplog.records)
    opt = res["opt"]
    assert not os.path.exists(opt.tensorboard_log_dir)
    with open(opt.eval_log_filepath) as f:
        line = f.read().strip().splitlines()[-1]
    assert "[Loss]" in line and "[Metrics]" in line
    loss_str = line.split("[Loss]")[1].split("[Metrics]")[0].split()
    terms = dict(zip(loss_str[::2], map(float, loss_str[1::2])))
    assert "loss_overall" in terms and "loss_saliency" in terms and "loss_rec_ss" in terms
    assert all(np.isfinite(v) for v in terms.values())
