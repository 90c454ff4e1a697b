"""The JAX package's `mesm_tpu.v1` checkpoints read by the port, on the CPU.

A checkpoint is written by `mesm_tpu.utils.checkpoint.save_checkpoint` from a
JAX init of the small charades config of tests/test_torch_harness.py and a
real `build_optimizer(...).init` state advanced by two optax updates, in the
per-layer layout and in the `scan_layers` one. The port must read back the
parameters (equal to `convert.state_dict_from_jax_params`, exactly), the
AdamW moments, step and learning rate (equal to optax's mu, nu, count and
injected learning rate, exactly), and take the next update as optax does
(1e-6 on the parameters, the negatives and MLM masks injected, fp32, JAX at
matmul precision "highest"). `convert.jax_params_from_state_dict` must
round-trip and agree with `mesm_tpu.convert.torch_state_dict_to_params`.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mesm_tpu.convert import stack_scanned, torch_state_dict_to_params
from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.losses import compute_losses as jax_compute_losses
from mesm_tpu.parallel.step import build_optimizer as jax_build_optimizer
from mesm_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mesm_tpu_torch.convert import (
    jax_params_from_state_dict,
    load_mesm_checkpoint,
    state_dict_from_jax_params,
)
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step
from mesm_tpu_torch.train import load_optax_state
from mesm_tpu_torch.utils.checkpoint import (
    is_torch_checkpoint,
    load_checkpoint,
    save_v1_checkpoint,
)

from synth import sample_neg_rows
from test_torch_harness import TRAIN, build_pair, jax_train_forward, torch_batch, train_batch

LR, WD, CLIP = 2e-4, 1e-4, 0.1
CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=4.0,
                 recfw_coef=0.1, recss_coef=0.1, cost_class=4.0, rank_coef=12.0)


@pytest.fixture(autouse=True)
def grad_mode_on():
    with torch.enable_grad():
        yield


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=np.shape(x)).astype(np.float32)),
                        tree)


@pytest.fixture(scope="module")
def base():
    jcfg, params, tmodel, _ = build_pair(**TRAIN)
    return jcfg, params, tmodel


def _write_v1(layout, base, directory):
    """(layout, jax config, params, optax state, path) of a v1 file after
    two optax updates."""
    jcfg, params, _ = base
    if layout == "scan_layers":
        jcfg = dataclasses.replace(jcfg, scan_layers=True)
        params = stack_scanned(jax.tree.map(np.array, params), jcfg)
    params = jax.tree.map(jnp.asarray, params)
    tx = jax_build_optimizer(lr=LR, weight_decay=WD, grad_clip=CLIP)
    state, update = tx.init(params), jax.jit(tx.update)
    for seed in (5, 6):
        updates, state = update(_random_like(params, seed), state, params)
        params = optax.apply_updates(params, updates)
    path = str(directory / f"model_{layout}.ckpt")
    jax_save_checkpoint(path, params, state, epoch=3, opt={"lr": LR})
    return layout, jcfg, jax.tree.map(np.asarray, params), state, path


@pytest.fixture(scope="module", params=["per_layer", "scan_layers"])
def v1(request, base, tmp_path_factory):
    return _write_v1(request.param, base, tmp_path_factory.mktemp("v1"))


def test_parameters_and_adamw_state_read_back(v1, base):
    layout, jcfg, params, state, path = v1
    tmodel = base[2]
    payload = load_checkpoint(path)
    assert payload["format"] == "mesm_tpu.v1" and payload["epoch"] == 3
    got, epoch = load_mesm_checkpoint(path, tmodel.cfg)
    assert epoch == 3
    want = state_dict_from_jax_params(params, tmodel.cfg)
    assert set(got) == set(tmodel.state_dict()) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)

    model = type(tmodel)(tmodel.cfg)
    optimizer = build_optimizer(model, 1.0, WD)
    assert load_optax_state(optimizer, model, payload["optimizer"]) == 2
    adam = state[1].inner_state[0]
    mu = state_dict_from_jax_params(jax.tree.map(np.asarray, adam.mu), tmodel.cfg)
    nu = state_dict_from_jax_params(jax.tree.map(np.asarray, adam.nu), tmodel.cfg)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(LR, rel=1e-7)
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        assert float(st["step"]) == float(adam.count) == 2.0
        torch.testing.assert_close(st["exp_avg"], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(st["exp_avg_sq"], nu[name], rtol=0, atol=0)
        assert st["exp_avg"].shape == p.shape


def test_resumed_step_matches_optax(base, tmp_path):
    """One port train step from a v1 file (parameters and optimizer state)
    equals optax's next update on the JAX gradients of the same batch,
    negatives and MLM masks."""
    _, jcfg, params, state, path = _write_v1("per_layer", base, tmp_path)
    tmodel = base[2]
    batch = train_batch()
    neg = sample_neg_rows(np.random.default_rng(1), batch["group_id"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ccfg = JaxCriterionConfig(**CRITERION)
    with jax.default_matmul_precision("highest"):

        def loss_fn(p):
            out = jax_train_forward(jcfg, p, batch, neg)
            _, total = jax_compute_losses(out, jb, ccfg, is_training=True)
            return total, out["masked_words_loc"]

        grads, masks = jax.jit(jax.grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
    masks = np.array(masks)
    tx = jax_build_optimizer(lr=LR, weight_decay=WD, grad_clip=CLIP)
    updates, _ = tx.update(grads, state, jax.tree.map(jnp.asarray, params))
    want = state_dict_from_jax_params(
        jax.tree.map(np.asarray, optax.apply_updates(params, updates)), tmodel.cfg)

    model = type(tmodel)(tmodel.cfg)
    payload = load_checkpoint(path)
    got_state, _ = load_mesm_checkpoint(path, model.cfg)
    model.load_state_dict(got_state, strict=True)
    optimizer = build_optimizer(model, 1.0, WD)
    step = load_optax_state(optimizer, model, payload["optimizer"])
    train_step = make_train_step(model, CriterionConfig(**CRITERION),
                                 lambda b: (b["words_feat"], b["words_mask"], b["sentence_feat"]),
                                 optimizer, CLIP, seed=0)
    train_step(torch_batch(batch), step, neg_idx_rows=torch.from_numpy(neg),
               masked_words_loc=torch.from_numpy(masks))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_jax_params_from_state_dict_round_trips(base):
    """The inverse mapping: the port's state dict -> the JAX tree equal to
    mesm_tpu's torch_state_dict_to_params and to the init it came from."""
    jcfg, params, tmodel = base
    sd = tmodel.state_dict()
    got = jax_params_from_state_dict(sd, tmodel.cfg)
    want = torch_state_dict_to_params(sd, jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    back = state_dict_from_jax_params(got, tmodel.cfg)
    for key, value in sd.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)


def test_format_sniffing(base, tmp_path):
    """Torch zip files and v1 pickles (the JAX package's writer and the
    port's) are told apart; a v1 file with no optimizer reads back."""
    jcfg, params, tmodel = base
    torch_path, jax_path, port_path = (str(tmp_path / n) for n in ("t.ckpt", "j.ckpt", "p.ckpt"))
    torch.save({"model": tmodel.state_dict(), "epoch": 1}, torch_path)
    jax_save_checkpoint(jax_path, params, None, epoch=1)
    save_v1_checkpoint(port_path, jax_params_from_state_dict(tmodel.state_dict(), tmodel.cfg),
                       epoch=1)
    assert is_torch_checkpoint(torch_path)
    assert not is_torch_checkpoint(jax_path) and not is_torch_checkpoint(port_path)
    from mesm_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint

    assert jax_load_checkpoint(port_path)["optimizer"] is None
    states = [load_mesm_checkpoint(p, tmodel.cfg) for p in (torch_path, jax_path, port_path)]
    for state, epoch in states:
        assert epoch == 1
        for key, value in tmodel.state_dict().items():
            torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    with open(os.path.join(tmp_path, "bad.ckpt"), "wb") as f:
        f.write(b"\x80\x04not a checkpoint")
    with pytest.raises(Exception):
        load_checkpoint(os.path.join(tmp_path, "bad.ckpt"))


def test_train_resumes_a_v1_checkpoint(tmp_path):
    """`train --resume <v1> --resume_all` on the synthetic charades root: the
    JAX package's checkpoint (parameters and a two-update optax state) is
    loaded, the run continues at epoch + 1 with the Adam count as its step
    count and the checkpoint's learning rate schedule."""
    import json

    from mesm_tpu_torch import runner
    from mesm_tpu_torch.config import BaseOptions
    from mesm_tpu_torch.train import train

    from synth_root import make_charades_root

    cfg_path = make_charades_root(str(tmp_path))
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(n_epoch=2, stop_score="miou", exp_id="from_v1")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    opt = BaseOptions().parse(["--config_file", cfg_path])
    torch.manual_seed(0)
    model = runner.build_model(opt)
    params = jax.tree.map(jnp.asarray, jax_params_from_state_dict(model.state_dict(), model.cfg))
    tx = jax_build_optimizer(lr=opt.lr, weight_decay=opt.weight_decay, grad_clip=opt.grad_clip)
    state, update = tx.init(params), jax.jit(tx.update)
    for seed in (1, 2):
        updates, state = update(_random_like(params, seed), state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax_model_latest.ckpt")
    jax_save_checkpoint(path, params, state, epoch=0, opt=vars(opt))
    run = train(["--config_file", cfg_path, "--device", "cpu", "--resume", path, "--resume_all"])
    assert run["epoch"] == 1 and run["step"] > 2
    with open(run["opt"].train_log_filepath) as f:
        epochs = [line.split()[2] for line in f if "[Epoch]" in line]
    assert epochs == ["002"]
