"""The port's CLIP text tower against the JAX package's, on the CPU.

One flax init of a small tower (width 32, 2 heads, 2 layers, context 16) is
carried into the port with `convert.clip_state_dict_from_jax_params`; the
independent torch oracle of tests/test_clip_text.py (`TorchClipText`) is a
third opinion. fp32: JAX at matmul precision "highest", torch without TF32,
1e-5 in units of max(1, max |ref|). bf16 (the tower at the run's compute
dtype): against the flax tower at dtype=bfloat16, 3e-2 in the same units.
`build_clip_text_encoder` reads a fabricated fp16 `.pth` in the upstream key layout, as
tests/test_e2e_clip.py writes it; the evaluate entry point runs on that
test's synthetic CLIP root with the text cache on and off.
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

from mesm_tpu.models.attention import attention_core as jax_attention_core
from mesm_tpu.models.text_encoder import CLIPTextEncoder as JaxCLIP
from mesm_tpu.models.text_encoder import clip_encode_text as jax_clip_encode_text
from mesm_tpu.runner import convert_clip_torch_weights as jax_convert_clip_torch_weights
from mesm_tpu_torch.convert import clip_state_dict_from_jax_params
from mesm_tpu_torch.models.attention import attention_core
from mesm_tpu_torch.models.text_encoder import CLIPTextEncoder, clip_encode_text
from mesm_tpu_torch.runner import build_clip_text_encoder, convert_clip_torch_weights

from test_clip_text import CTX, EMBED, HEADS, LAYERS, VOCAB, WIDTH, TorchClipText

ARCH = dict(embed_dim=EMBED, context_length=CTX, vocab_size=VOCAB, width=WIDTH, heads=HEADS,
            layers=LAYERS)
FP32_TOL, BF16_TOL = 1e-5, 3e-2


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _ids(seed: int, n: int) -> np.ndarray:
    """n token rows: sot, words, eot (the largest id: the argmax pools it),
    zero padding."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, CTX), np.int64)
    for b in range(n):
        k = int(rng.integers(3, CTX - 1))
        ids[b, 0] = VOCAB - 2
        ids[b, 1:k] = rng.integers(1, VOCAB - 2, k - 1)
        ids[b, k] = VOCAB - 1
    return ids


@pytest.fixture(scope="module")
def towers():
    """(flax params, the port's tower with the same weights)."""
    params = JaxCLIP(**ARCH).init(jax.random.PRNGKey(0), jnp.asarray(_ids(0, 2)))["params"]
    params = jax.tree.map(np.asarray, params)
    tower = CLIPTextEncoder(**ARCH)
    tower.load_state_dict(clip_state_dict_from_jax_params(params), strict=True)
    return params, tower.eval()


def _jax_tower(params, ids, dtype):
    with jax.default_matmul_precision("highest"):
        out = JaxCLIP(**ARCH, dtype=dtype).apply({"params": params}, jnp.asarray(ids))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _port_tower(tower, ids, dtype):
    with torch.no_grad():
        out = tower(torch.from_numpy(ids), dtype)
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_matches_flax(towers, dtype):
    params, tower = towers
    ids = _ids(1, 5)
    want = _jax_tower(params, ids, jnp.dtype(dtype))
    got = _port_tower(tower, ids, getattr(torch, dtype))
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    for key in ("last_hidden_state", "pooler_output"):
        assert got[key].shape == want[key].shape, key
        assert _err(got[key], want[key]) <= tol, (key, _err(got[key], want[key]))


def test_tower_matches_torch_oracle():
    """The converted tower from the oracle's upstream-named weights against
    the oracle itself (nn.MultiheadAttention with a -inf causal mask)."""
    torch.manual_seed(0)
    oracle = TorchClipText().eval()
    weights, arch = convert_clip_torch_weights(oracle.reference_named_state_dict())
    tower = CLIPTextEncoder(**dict(arch, heads=HEADS))
    tower.load_state_dict(weights, strict=True)
    ids = _ids(2, 4)
    with torch.no_grad():
        hidden, pooled = oracle(torch.from_numpy(ids))
    got = _port_tower(tower.eval(), ids, torch.float32)
    assert _err(got["last_hidden_state"], hidden.numpy()) <= FP32_TOL
    assert _err(got["pooler_output"], pooled.numpy()) <= FP32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_encode_text_matches_jax(towers, dtype):
    """Truncation to max_words_l, padding zeroed, the masked-mean sentence,
    L2 normalisation with eps 1e-5, float32 outputs."""
    params, tower = towers
    ids = _ids(3, 4)
    mask = ids != 0
    with jax.default_matmul_precision("highest"):
        want = jax_clip_encode_text(JaxCLIP(**ARCH, dtype=jnp.dtype(dtype)), params,
                                    jnp.asarray(ids), jnp.asarray(mask), 8, True)
    with torch.no_grad():
        got = clip_encode_text(tower, torch.from_numpy(ids), torch.from_numpy(mask), 8, True,
                               getattr(torch, dtype))
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        if g.dtype == torch.bool or not g.dtype.is_floating_point:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert _err(g.numpy(), np.asarray(w)) <= tol


def test_build_clip_text_encoder_reads_a_fabricated_fp16_pth(tmp_path):
    """An upstream-layout fp16 file at CLIP's vocabulary and context, with
    the keys the reference file carries besides the tower's: the
    architecture and every weight equal JAX's converter's."""
    torch.manual_seed(0)
    sd = TorchClipText().reference_named_state_dict()
    sd["token_embedding.weight"] = torch.randn(49408, WIDTH) * 0.02
    sd["positional_embedding"] = torch.randn(77, WIDTH) * 0.01
    sd = {k: v.to(torch.float16) for k, v in sd.items()}
    path = str(tmp_path / "clip_text_encoder.pth")
    torch.save(dict(sd, input_resolution=224, context_length=77, vocab_size=49408), path)
    jparams, jarch = jax_convert_clip_torch_weights(sd)
    _, arch = convert_clip_torch_weights(sd)
    assert arch == jarch == dict(embed_dim=EMBED, context_length=77, vocab_size=49408,
                                 width=WIDTH, heads=1, layers=LAYERS)
    tower = build_clip_text_encoder(path)
    assert not any(p.requires_grad for p in tower.parameters())
    assert {p.dtype for p in tower.parameters()} == {torch.float32}
    want = clip_state_dict_from_jax_params(jparams)
    got = tower.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_with_logit_bias_matches_jax(dtype):
    """The causal bias in the logits' dtype (in bf16 -1e9 rounds), with a key
    mask beside it."""
    rng = np.random.default_rng(4)
    B, L, E, H = 3, 11, 32, 4
    q, k, v = (rng.normal(size=(B, L, E)).astype(np.float32) for _ in range(3))
    mask = np.arange(L)[None] < np.array([11, 7, 1])[:, None]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    bias = jnp.triu(jnp.full((L, L), -1e9, jdt), k=1)[None, None]
    with jax.default_matmul_precision("highest"):
        want = jax_attention_core(*(jnp.asarray(a, jdt) for a in (q, k, v)), num_heads=H,
                                  key_valid_mask=jnp.asarray(mask), logit_bias=bias)
    tbias = torch.triu(torch.full((L, L), -1e9, dtype=tdt), 1)[None, None]
    got = attention_core(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), H,
                         key_valid_mask=torch.from_numpy(mask), logit_bias=tbias)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    assert _err(got.float().numpy(), want) <= tol


@pytest.fixture(scope="module")
def clip_run(tmp_path_factory):
    """tests/test_e2e_clip.py's synthetic CLIP root (BPE file, fp16 tower,
    keep-vocab) and a run dir with a seeded port checkpoint."""
    from mesm_tpu_torch import runner
    from mesm_tpu_torch.config import BaseOptions

    from test_e2e_clip import make_clip_root

    root = str(tmp_path_factory.mktemp("torch_clip"))
    cfg_path = make_clip_root(root)
    opt = BaseOptions().parse(["--config_file", cfg_path])
    torch.manual_seed(3)
    model = runner.build_model(opt)
    torch.save({"model": model.state_dict(), "epoch": 0},
               os.path.join(opt.result_dir, "model_test_best.ckpt"))
    with open(cfg_path) as f:
        base = json.load(f)
    return root, cfg_path, {
        "trained_result_dir": opt.result_dir, "num_workers": 2, "resume_all": False,
        "compute_dtype": "float32", "eval_len_buckets": 1, "n_devices": 1, "nms_thd": -1,
        "ann_path": base["ann_path"], "feat_files": base["feat_files"],
        "bpe_path": base["bpe_path"], "text_model_path": base["text_model_path"],
    }


def _eval(root, eval_cfg, name, **extra):
    from mesm_tpu_torch.evaluate import inference

    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(dict(eval_cfg, inference_id=name,
                       inference_result_dir=os.path.join(root, name), **extra), f)
    return inference(["--config_file", path, "--device", "cpu"])


def test_evaluate_from_raw_text_with_the_cache_on_and_off(clip_run):
    """`evaluate` on a CLIP config: the tower once over every sentence (cache
    on) and inside every eval step (off) give the same brief metrics and
    the same submission."""
    root, _, eval_cfg = clip_run
    on, _ = _eval(root, eval_cfg, "cache_on", cache_text="on")
    off, _ = _eval(root, eval_cfg, "cache_off", cache_text="off")
    assert on["brief"] and on["brief"] == off["brief"]
    subs = []
    for name in ("cache_on", "cache_off"):
        (path,) = glob.glob(os.path.join(root, name, "*", "*_submission*.jsonl"))
        with open(path) as f:
            subs.append(f.read())
    assert subs[0] and subs[0] == subs[1]
