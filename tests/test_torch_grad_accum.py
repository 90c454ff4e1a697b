"""`--grad_accum k` in the port's train step against the JAX package's
semantics (mesm_tpu/parallel/step.py:141-230), on the CPU.

The oracle is the harness of tests/test_torch_train.py: one JAX init of the
small charades config carried into the port, fp32 (JAX at matmul precision
"highest", torch without TF32), dropout 0. The batch of 8 rows is cut into
k = 2 microbatches of 4 as the JAX step reshapes it; each microbatch's
negatives and MLM masks are injected into both sides. The JAX gradients of
the two microbatches are averaged in f32 and go through one optax update;
the port's parameters after its one step must match within 1e-6 and its
loss terms must be the mean of the microbatches' (1e-4 in units of
max(1, max |JAX|)).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.losses import compute_losses as jax_compute_losses
from mesm_tpu.parallel.step import build_optimizer as jax_build_optimizer
from mesm_tpu_torch.convert import state_dict_from_jax_params
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step, split_micro

from synth import sample_neg_rows
from test_torch_harness import TRAIN, build_pair, jax_train_forward, torch_batch, train_batch
from test_torch_train import CRITERIA

K = 2
LR, WD, CLIP = 2e-4, 1e-4, 0.1


@pytest.fixture(autouse=True)
def grad_mode_on():
    with torch.enable_grad():
        yield


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    with jax.default_matmul_precision("highest"):
        jcfg, params, tmodel, _ = build_pair(**TRAIN)
    batch = train_batch()
    for key in ("video_feat_g", "video_mask_g", "video_slot"):  # eval-only fields
        batch.pop(key)
    # the JAX step's split: every leaf reshaped to (K, B/K, ...)
    micro = [{k: np.asarray(v).reshape((K, -1) + np.shape(v)[1:])[i] for k, v in batch.items()}
             for i in range(K)]
    negs = [sample_neg_rows(np.random.default_rng(10 + i), mb["group_id"]) for i, mb in
            enumerate(micro)]
    return jcfg, params, tmodel, batch, micro, negs


def test_grad_accum_update_matches_optax_on_the_mean_gradient(setup):
    jcfg, params, tmodel, batch, micro, negs = setup
    ccfg = JaxCriterionConfig(**CRITERIA["charades"])

    def loss_fn(p, mb, neg):
        out = jax_train_forward(jcfg, p, mb, neg)
        losses, total = jax_compute_losses(out, {k: jnp.asarray(v) for k, v in mb.items()}, ccfg,
                                           is_training=True)
        return total, (losses, out["masked_words_loc"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    jparams = jax.tree.map(jnp.asarray, params)
    acc, totals, terms, masks = None, [], [], []
    with jax.default_matmul_precision("highest"):
        for mb, neg in zip(micro, negs):
            (total, (losses, mask)), g = grad_fn(jparams, mb, jnp.asarray(neg))
            g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
            totals.append(float(total))
            terms.append(jax.tree.map(float, losses))
            masks.append(np.array(mask))
    grads = jax.tree.map(lambda a: a / K, acc)
    tx = jax_build_optimizer(lr=LR, weight_decay=WD, grad_clip=CLIP)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    want = state_dict_from_jax_params(
        jax.tree.map(np.asarray, optax.apply_updates(jparams, updates)), tmodel.cfg)

    model = type(tmodel)(tmodel.cfg)
    model.load_state_dict(tmodel.state_dict())
    optimizer = build_optimizer(model, LR, WD)
    step = make_train_step(model, CriterionConfig(**CRITERIA["charades"]), _encode, optimizer,
                           CLIP, seed=0, grad_accum=K)
    metrics = step(torch_batch(batch), 0, neg_idx_rows=[torch.from_numpy(n) for n in negs],
                   masked_words_loc=[torch.from_numpy(m) for m in masks])
    assert abs(float(metrics["loss_overall"]) - np.mean(totals)) <= 1e-4 * max(1.0, abs(np.mean(totals)))
    for key in terms[0]:
        assert _err(float(metrics[key]), np.mean([t[key] for t in terms])) <= 1e-4, key
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_split_micro_cuts_every_leaf_and_keeps_the_reference_row_gather(setup):
    """Consecutive slices of B/k rows; `ss_sent_idx` (rows of the whole
    batch) read as the reference's clamped gather reads it; a batch whose
    rows are not divisible by k raises the JAX step's ValueError."""
    _, _, _, batch, micro, _ = setup
    tb = torch_batch(batch)
    got = split_micro(tb, K)
    for i in range(K):
        assert set(got[i]) == set(micro[i])
        for key, want in micro[i].items():
            want = np.minimum(want, len(want) - 1) if key == "ss_sent_idx" else want
            np.testing.assert_array_equal(got[i][key].numpy(), want, err_msg=key)
    sent = jnp.asarray(batch["sentence_feat"][: len(batch["sentence_feat"]) // K])
    for i in range(K):  # jnp's gather clamps: the same rows the port's split reads
        np.testing.assert_array_equal(np.asarray(sent[jnp.asarray(micro[i]["ss_sent_idx"])]),
                                      sent[got[i]["ss_sent_idx"].numpy()])
    with pytest.raises(ValueError, match="divisible"):
        split_micro(tb, 3)


def test_grad_accum_step_raises_for_indivisible_batches_and_repeats_its_draws(setup):
    """make_train_step(grad_accum=3) on 8 rows raises as the JAX step does;
    at k = 2 with nothing injected two models from one init take the same
    step at the same (seed, step), the microbatches' draws folded in."""
    _, _, tmodel, batch, _, _ = setup
    ccfg = CriterionConfig(**CRITERIA["charades"])
    tb = torch_batch(batch)
    model = type(tmodel)(tmodel.cfg)
    bad = make_train_step(model, ccfg, _encode, build_optimizer(model, LR, WD), CLIP, seed=0,
                          grad_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        bad(tb, 0)
    runs = []
    for _ in range(2):
        model = type(tmodel)(tmodel.cfg)
        model.load_state_dict(tmodel.state_dict())
        step = make_train_step(model, ccfg, _encode, build_optimizer(model, LR, WD), CLIP,
                               seed=5, grad_accum=K)
        runs.append(float(step(tb, 3)["loss_overall"]))
    assert runs[0] == runs[1] and np.isfinite(runs[0])


def test_train_entry_point_takes_grad_accum_and_bf16(tmp_path):
    """`train --grad_accum 2 --compute_dtype bfloat16` for one epoch on the
    synthetic charades root (8-row batches): finite losses, float32
    parameters in the checkpoint."""
    import json

    from mesm_tpu_torch.train import train

    from synth_root import make_charades_root

    cfg_path = make_charades_root(str(tmp_path))
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(n_epoch=1, stop_score="miou", exp_id="accum_bf16", row_capacity=8)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    run = train(["--config_file", cfg_path, "--device", "cpu", "--grad_accum", "2",
                 "--compute_dtype", "bfloat16"])
    assert run["step"] > 0 and run["opt"].grad_accum == 2
    with open(run["opt"].train_log_filepath) as f:
        line = f.read().strip().splitlines()[-1]
    toks = line.split()
    assert np.isfinite(float(toks[toks.index("loss_overall") + 1]))
    payload = torch.load(os.path.join(run["opt"].result_dir, "model_latest.ckpt"),
                         weights_only=False)
    assert {v.dtype for v in payload["model"].values()} == {torch.float32}
