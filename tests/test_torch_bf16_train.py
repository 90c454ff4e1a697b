"""bf16 training (`--compute_dtype bfloat16`) in the port, on the CPU.

Parameters and AdamW state stay float32; activations run in bf16, as in the
JAX model at dtype=bfloat16 (tests/test_bf16_train.py). Held here:

- the train-mode forward's loss terms against the JAX package's bf16
  forward from one init, the negatives and MLM masks injected: each term
  within 5e-2 in units of max(1, |JAX|), the relative bound
  tests/test_bf16_train.py:85 puts on the step-0 loss against fp32 (forward
  only: a JAX bf16 train-step compile takes minutes here);
- six steps keep float32 parameters and optimizer state, with finite,
  decreasing losses; the step-0 loss within 5e-2 relative of the fp32 one;
- the bf16 eval metric gate of tests/test_e2e.py:97 on the port: a
  checkpoint trained a few steps by `train`, scored by `evaluate` in bf16
  and in fp32, every brief metric within one sample (100 / queries points).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.losses import compute_losses as jax_compute_losses
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.parallel.step import build_optimizer, make_micro_grads, make_train_step

from synth import make_batch, sample_neg_rows
from synth_root import make_charades_root
from test_torch_harness import TRAIN, build_pair, jax_train_forward, torch_batch, train_batch
from test_torch_train import CRITERIA

BF16_TOL = 5e-2


@pytest.fixture(autouse=True)
def grad_mode_on():
    with torch.enable_grad():
        yield


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


@pytest.fixture(scope="module")
def setup():
    jcfg, params, tmodel, _ = build_pair(**TRAIN)
    batch = train_batch()
    for key in ("video_feat_g", "video_mask_g", "video_slot"):  # eval-only fields
        batch.pop(key)
    neg = sample_neg_rows(np.random.default_rng(1), batch["group_id"])
    return jcfg, params, tmodel, batch, neg


def _fresh(tmodel):
    model = type(tmodel)(tmodel.cfg)
    model.load_state_dict(tmodel.state_dict())
    return model


def test_bf16_train_forward_losses_match_jax_bf16(setup):
    jcfg, params, tmodel, batch, neg = setup
    ccfg = JaxCriterionConfig(**CRITERIA["charades"])
    bcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def forward(p):
        out = jax_train_forward(bcfg, p, batch, neg)
        losses, total = jax_compute_losses(out, jb, ccfg, is_training=True)
        return dict(losses, loss_overall=total), out["masked_words_loc"]

    want, masks = forward(jax.tree.map(jnp.asarray, params))
    want = {k: float(v) for k, v in want.items()}
    model = _fresh(tmodel)
    micro = make_micro_grads(model, CriterionConfig(**CRITERIA["charades"]), _encode,
                             torch.bfloat16)
    total, losses = micro(torch_batch(batch), neg_idx_rows=torch.from_numpy(neg),
                          masked_words_loc=torch.from_numpy(np.array(masks)))
    got = {k: float(v) for k, v in losses.items()}
    got["loss_overall"] = float(total)
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= BF16_TOL * max(1.0, abs(value)), (key, got[key], value)
    for p in model.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or (p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all())


def test_six_bf16_steps_keep_fp32_state_and_decrease_the_loss(setup):
    """As tests/test_bf16_train.py holds the JAX step: lr 2e-3, the same
    8-row batch of 16-clip videos six times, the draws of each step from
    (seed, step)."""
    tmodel = setup[2]
    ccfg = CriterionConfig(**CRITERIA["charades"])
    # 16 clips a video, as tests/test_bf16_train.py's batch (bf16 runs slowly on the CPU)
    batch = make_batch(np.random.default_rng(0), B=8, Lv=16, Dv=TRAIN["v_feat_dim"],
                       Lw=TRAIN["max_words_l"], Dt=TRAIN["t_feat_dim"], G=3)
    batch["words_label"] = batch["words_label"] % TRAIN["num_classes"]
    batch["row_mask"] = np.ones(8, bool)
    for key in ("video_feat_g", "video_mask_g", "video_slot"):
        batch.pop(key)
    tb = torch_batch(batch)
    losses = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = _fresh(tmodel)
        optimizer = build_optimizer(model, 2e-3, 1e-4)
        step = make_train_step(model, ccfg, _encode, optimizer, 0.1, seed=7, compute_dtype=dtype)
        losses[name] = [float(step(tb, i)["loss_overall"]) for i in range(6 if name == "bf16" else 1)]
        if name == "bf16":
            assert {p.dtype for p in model.parameters()} == {torch.float32}
            for st in optimizer.state.values():
                assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    bf = losses["bf16"]
    assert all(np.isfinite(bf)) and bf[-1] < bf[0], bf
    assert abs(bf[0] - losses["fp32"][0]) / abs(losses["fp32"][0]) < BF16_TOL, losses


def test_bf16_eval_metric_parity(tmp_path):
    """tests/test_e2e.py:97 on the port: a checkpoint trained by `train`
    (one epoch on the synthetic charades root), scored in fp32 and in bf16."""
    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.train import train

    cfg_path = make_charades_root(str(tmp_path))
    with open(cfg_path) as f:
        base = json.load(f)
    base.update(n_epoch=1, stop_score="miou", exp_id="bf16_gate")
    with open(cfg_path, "w") as f:
        json.dump(base, f)
    run = train(["--config_file", cfg_path, "--device", "cpu"])
    assert run["step"] > 0
    briefs, n_queries = {}, {}
    for dt in ("float32", "bfloat16"):
        path = str(tmp_path / f"eval_{dt}.json")
        with open(path, "w") as f:
            json.dump({
                "inference_id": f"gate_{dt}", "inference_result_dir": str(tmp_path / dt),
                "trained_result_dir": run["opt"].result_dir, "num_workers": 2,
                "resume_all": False, "max_ts_val": 150, "compute_dtype": dt,
                "ann_path": base["ann_path"], "feat_files": base["feat_files"],
                "bpe_path": "", "text_model_path": base["text_model_path"],
            }, f)
        metrics, _ = inference(["--config_file", path, "--device", "cpu"])
        briefs[dt] = metrics["brief"]
        (sub,) = glob.glob(os.path.join(str(tmp_path / dt), "*", "*submission*.jsonl"))
        with open(sub) as f:
            n_queries[dt] = sum(1 for line in f if line.strip())
    assert n_queries["float32"] == n_queries["bfloat16"] > 0
    one_sample = 100.0 / n_queries["float32"]
    assert set(briefs["float32"]) == set(briefs["bfloat16"])
    for key, a in briefs["float32"].items():
        b = briefs["bfloat16"][key]
        if a is None or b is None:  # a metric this split does not define
            assert a is b, key
            continue
        assert abs(a - b) <= one_sample + 1e-9, f"{key}: fp32 {a} vs bf16 {b}"
