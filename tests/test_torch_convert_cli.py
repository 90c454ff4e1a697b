"""`python -m mesm_tpu_torch.convert` against `python -m mesm_tpu.convert`
(mesm_tpu/convert.py:310-357), and the process-wide kernel-mode setter
`kernels.set_pallas_attention` (mesm_tpu/kernels.py:271-276).

The upstream checkpoint is the port's small charades model (the config of
tests/test_torch_harness.py) saved as {"model", "epoch"}, with an opt.json
that defines it before the TEF bump (use_tef on: v_feat_dim 68 + 2 TEF
channels), in the per-layer layout and with scan_layers on (the
stacks of more than one layer in the scan layout, as
tests/test_torch_checkpoint_v1.py writes both). Each subcommand's output
equals the JAX CLI's on the same input: the v1 payload's keys, epoch, opt,
and every parameter array (values, shapes and dtypes); the torch file's
state dict and epoch. The port's v1 file loads through
mesm_tpu.utils.checkpoint.load_checkpoint into the JAX model, whose forward
equals the port's on the original weights within 1e-4. A TwoMLP v1 file
whose two PReLU slopes of one layer differ converts as the JAX CLI converts
it (the last mapped slope wins)."""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu import convert as jax_convert
from mesm_tpu.models.mesm import MESMConfig as JaxConfig
from mesm_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from mesm_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mesm_tpu_torch import kernels
from mesm_tpu_torch.models.mesm import MESM, MESMConfig

from test_torch_harness import SMALL, TACOS, build_pair, jax_forward, small_batch, torch_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 7
LAYOUTS = ("per_layer", "scan_layers")


def _opt(cfg: dict, scan: bool) -> dict:
    """The opt.json of a run whose model is `cfg` (v_feat_dim before the TEF bump)."""
    return dict(hidden_dim=cfg["hidden_dim"], v_feat_dim=cfg["v_feat_dim"] - 2, use_tef=True,
                t_feat_dim=cfg["t_feat_dim"], nheads=cfg["nheads"],
                dim_feedforward=cfg["dim_feedforward"], num_recfw_layers=cfg["num_recfw_layers"],
                t2v_layers=cfg["t2v_layers"], enc_layers=cfg["enc_layers"],
                dec_layers=cfg["dec_layers"], num_recss_layers=cfg["num_recss_layers"],
                num_queries=cfg["num_queries"], dropout=0.1, input_dropout=0.5, n_input_proj=2,
                use_txt_pos=False, max_words_l=cfg["max_words_l"],
                max_video_l=cfg["max_video_l"], rec_fw=True, rec_ss=True,
                share_MLP=cfg.get("share_mlp", True), aux_loss=True,
                vocab_size=cfg["num_classes"] - 1, tokenizer_type="GloVeSimple",
                scan_layers="on" if scan else "off")


def _port_cli(*args) -> None:
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "mesm_tpu_torch.convert", *map(str, args)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wrote" in proc.stdout


def _jax_cli(monkeypatch, *args) -> None:
    monkeypatch.setattr(sys, "argv", ["python -m mesm_tpu.convert", *map(str, args)])
    jax_convert._main()


def _v1(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_trees_equal(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """(directory, the port's model) with model.ckpt and one opt.json per layout."""
    d = tmp_path_factory.mktemp("convert")
    torch.manual_seed(3)
    model = MESM(MESMConfig(**SMALL))
    torch.save({"model": model.state_dict(), "epoch": EPOCH, "optimizer": None}, d / "model.ckpt")
    for layout in LAYOUTS:
        with open(d / f"opt_{layout}.json", "w") as f:
            json.dump(_opt(SMALL, layout == "scan_layers"), f)
    return d, model


@pytest.fixture(scope="module", params=LAYOUTS)
def native(request, upstream, tmp_path_factory):
    """(layout, the port's v1 file, the JAX CLI's v1 file) of to-native."""
    d, _ = upstream
    layout = request.param
    opt = d / f"opt_{layout}.json"
    port, ref = d / f"port_{layout}.ckpt", d / f"jax_{layout}.ckpt"
    _port_cli("to-native", d / "model.ckpt", port, "--opt_json", opt)
    with pytest.MonkeyPatch.context() as mp:
        _jax_cli(mp, "to-native", d / "model.ckpt", ref, "--opt_json", opt)
    return layout, port, ref


def test_to_native_writes_the_jax_clis_file(native):
    layout, port, ref = native
    got, want = _v1(port), _v1(ref)
    assert set(got) == set(want)
    assert got["format"] == want["format"] == "mesm_tpu.v1"
    assert got["epoch"] == want["epoch"] == EPOCH
    assert got["opt"] == want["opt"] and got["opt"]["v_feat_dim"] == SMALL["v_feat_dim"]
    assert got["optimizer"] is None and want["optimizer"] is None
    assert got["lr"] == want["lr"]
    _assert_trees_equal(got["model"], want["model"])
    stacked = "layers" in got["model"]["transformer"]["encoder"]
    assert stacked == (layout == "scan_layers")


def test_to_native_file_runs_the_jax_model(native, upstream):
    """The port's v1 file through the JAX package's loader: its forward
    equals the port's on the original weights (1e-4)."""
    layout, port, _ = native
    payload = jax_load_checkpoint(str(port))
    jcfg = JaxConfig(**SMALL, scan_layers=layout == "scan_layers")
    params = jax.tree.map(jnp.asarray, payload["model"])
    batch = small_batch(0)
    want = torch_forward(upstream[1].eval(), batch)
    got = jax_forward(jcfg, params, batch)
    for key in ("pred_logits", "pred_spans", "saliency_scores"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0, err_msg=key)


def test_to_torch_writes_the_jax_clis_file(native, monkeypatch, upstream):
    layout, _, ref = native
    d = upstream[0]
    port_out, jax_out = d / f"port_{layout}.pt", d / f"jax_{layout}.pt"
    _port_cli("to-torch", ref, port_out)
    _jax_cli(monkeypatch, "to-torch", ref, jax_out)
    got, want = torch.load(port_out, weights_only=False), torch.load(jax_out, weights_only=False)
    assert set(got) == set(want) == {"model", "epoch"} and got["epoch"] == want["epoch"] == EPOCH
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0)
    # the round trip gives the upstream weights back
    for k, v in upstream[1].state_dict().items():
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("scan", [False, True])
def test_to_torch_takes_the_last_of_two_prelu_slopes(tmp_path, monkeypatch, scan):
    """A JAX-trained TwoMLP tree may hold two slopes for upstream's one."""
    jcfg, params, _, _ = build_pair(**TACOS)
    slope = params["enhance_encoder"]["layer0"]["ffn_mlm"]["PReLU_0"]
    slope["alpha"] = np.asarray(slope["alpha"]) + 0.125
    if scan:
        jcfg = dataclasses.replace(jcfg, scan_layers=True)
        params = jax_convert.stack_scanned(params, jcfg)
    src = tmp_path / "two_mlp.ckpt"
    jax_save_checkpoint(str(src), params, epoch=2,
                        opt=dict(_opt(TACOS, scan), v_feat_dim=TACOS["v_feat_dim"]))
    _port_cli("to-torch", src, tmp_path / "port.pt")
    _jax_cli(monkeypatch, "to-torch", src, tmp_path / "jax.pt")
    got = torch.load(tmp_path / "port.pt", weights_only=False)["model"]
    want = torch.load(tmp_path / "jax.pt", weights_only=False)["model"]
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_to_native_refuses_a_checkpoint_of_another_architecture(upstream, tmp_path):
    d, model = upstream
    state = dict(model.state_dict())
    state.pop("span_embed.layers.0.weight")
    torch.save({"model": state, "epoch": 1}, tmp_path / "short.ckpt")
    proc = subprocess.run([sys.executable, "-m", "mesm_tpu_torch.convert", "to-native",
                           str(tmp_path / "short.ckpt"), str(tmp_path / "out.ckpt"),
                           "--opt_json", str(d / "opt_per_layer.json")], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "missing" in proc.stderr
    assert not (tmp_path / "out.ckpt").exists()


@pytest.fixture
def default_mode():
    yield
    kernels.set_pallas_attention(None)


@pytest.mark.parametrize("value,mode", [("off", "off"), (False, "off"), ("on", "on"),
                                        (True, "on"), (None, "auto"), ("auto", "auto")])
def test_set_pallas_attention_sets_the_process_mode(default_mode, value, mode):
    from mesm_tpu import kernels as jax_kernels

    kernels.set_pallas_attention(value)
    assert kernels.pallas_mode() == mode
    jax_kernels.set_pallas_attention(value)
    try:
        assert jax_kernels.pallas_mode() == mode
    finally:
        jax_kernels.set_pallas_attention(None)


def test_a_scope_overrides_the_process_mode(default_mode):
    import threading

    kernels.set_pallas_attention("off")
    assert not kernels.use_pallas_attention(128, 600, 600, torch.float32, "cuda")
    with kernels.pallas_scope("on"):
        assert kernels.pallas_mode() == "on"
        seen = {}
        thread = threading.Thread(target=lambda: seen.update(mode=kernels.pallas_mode()))
        thread.start()
        thread.join()
        assert seen["mode"] == "off"  # the process default, in another thread
    assert kernels.pallas_mode() == "off"
    kernels.set_pallas_attention("on")
    assert kernels.use_pallas_attention(1, 8, 8, torch.float32, "cpu")
    with kernels.pallas_scope(None):
        assert kernels.pallas_mode() == "auto"
    assert kernels.pallas_mode() == "on"
