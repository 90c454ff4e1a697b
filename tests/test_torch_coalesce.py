"""The dispatch-coalesced eval path of the port against the JAX package's, on
the CPU (mesm_tpu/parallel/step.py:233-488, data/pipeline.py:239-300,
evaluate.py:72-326, runner.py:461-488; the JAX package's own tests are
tests/test_coalesce.py).

The small model of tests/test_torch_harness.py (dropout 0), one JAX init
carried into the port, fp32 (JAX at matmul precision "highest", torch
without TF32), two batch families: charades (deduplicated videos,
`video_feat_g`) and QVHighlights (per-row clips and the group's SS video
`ss_video_feat_groups`, expanded when staged). Tolerances: the coalesced
port step against K calls of the port's per-batch step 1e-6 (the same
operations on the same rows; a matrix product over more rows may sum in
another blocking); against JAX's coalesced step 1e-4 in units of max(1,
max |JAX|) (the parity protocol of the other port tests); submissions equal
up to one step of their 4-decimal rounding where two packages' values
meet, exactly where they are the port's own. On the CPU the coalesced step
runs eagerly; the CUDA graph it runs as on the card is tested in
tests/test_torch_coalesce_card.py (no JAX import there, so the card's
machine runs it).
"""
from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesm_tpu.data.pipeline import stage_batch as jax_stage_batch
from mesm_tpu.data.pipeline import stage_superbatch as jax_stage_superbatch
from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.models.mesm import MESM as JaxMESM
from mesm_tpu.parallel.step import make_eval_step as jax_make_eval_step
from mesm_tpu.parallel.step import sample_out_of_group as jax_sample_out_of_group
from mesm_tpu_torch import kernels
from mesm_tpu_torch.data.pipeline import stage_batch, stage_superbatch, staged_signature
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.parallel import step as tstep
from mesm_tpu_torch.parallel.step import make_eval_step

from test_torch_eval_cli import _write_cfg, run_dir  # noqa: F401  (a fixture)
from test_torch_harness import TRAIN, build_pair, train_batch
from test_torch_qvh import QVH_CRITERION, qvh_batch
from test_torch_train import CRITERIA

TOL, SELF_TOL = 1e-4, 1e-6


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def _jax_encode(frozen, b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def charades_batch(seed: int, lv_extra: int = 0) -> dict:
    """The harness's train batch as the eval collate stages it: unique
    videos (video_feat_g, video_slot), no per-row video, targets kept."""
    batch = train_batch(seed)
    batch.pop("video_feat")
    if lv_extra:  # a longer length bucket: zero padding past the videos
        for key in ("video_feat_g", "video_mask_g", "video_mask", "clip_mask"):
            a = batch[key]
            pad = [(0, 0)] * a.ndim
            pad[1] = (0, lv_extra)
            batch[key] = np.pad(a, pad)
    return batch


FAMILIES = {"charades": (charades_batch, CRITERIA["charades"]),
            "qvh": (qvh_batch, QVH_CRITERION)}


@pytest.fixture(scope="module")
def pair():
    """(jax config, params, port model) of the harness's dropout-free model."""
    with jax.default_matmul_precision("highest"):
        return build_pair(**TRAIN)[:3]


def _port_step(model, family, with_loss, coalesce=1):
    ccfg = CriterionConfig(**FAMILIES[family][1])
    return make_eval_step(model, _encode, torch.float32, ccfg, with_loss=with_loss, seed=5,
                          coalesce=coalesce)


def _port_arg(hosts):
    return stage_superbatch(hosts, False, "cpu")


def _jax_neg(hosts, rng):
    """The negatives the JAX step draws for each batch: one key, fold_in(rng, 0)."""
    return np.stack([np.asarray(jax_sample_out_of_group(
        jax.random.fold_in(rng, 0), jnp.asarray(h["group_id"]), jnp.asarray(h["row_mask"])))
        for h in hosts])


# ---------------------------------------------------------------------------
# the capture-safe constants
# ---------------------------------------------------------------------------


def test_capture_safe_constants_keep_their_bits():
    """attention_core's mask fill and the saliency scale are made on the
    device by fill kernels now (a CUDA graph cannot capture a host tensor
    copied over): the same bits as the host-made tensors they replace."""
    from mesm_tpu_torch.models.attention import NEG_INF, attention_core
    from mesm_tpu_torch.models.mesm import saliency_scale

    for dt, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        new = torch.full((), NEG_INF, dtype=dt)
        assert torch.equal(new.view(view), torch.tensor(NEG_INF, dtype=dt).view(view))
    for d in (32, 256, 300, 1000):
        new = torch.full((), saliency_scale(d), dtype=torch.float32)
        old = 1.0 / torch.sqrt(torch.tensor(float(d)))
        assert torch.equal(new.view(torch.int32), old.view(torch.int32))
    # attention_core with a key mask: the masked logits take NEG_INF's bits
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 8, generator=g) for _ in range(3))
    mask = torch.tensor([[1, 1, 0, 0, 1], [1, 0, 1, 1, 1]], dtype=torch.bool)
    out = attention_core(q, k, v, 2, key_valid_mask=mask)
    logits = (q.reshape(2, 5, 2, 4).transpose(1, 2) * torch.tensor(0.5)) @ \
        k.reshape(2, 5, 2, 4).transpose(1, 2).transpose(-1, -2)
    logits = torch.where(mask[:, None, None, :], logits, torch.tensor(NEG_INF))
    want = (torch.softmax(logits, -1) @ v.reshape(2, 5, 2, 4).transpose(1, 2))
    assert torch.equal(out, want.transpose(1, 2).reshape(2, 5, 8))


# ---------------------------------------------------------------------------
# the coalesced step
# ---------------------------------------------------------------------------

def _jax_coalesced(jcfg, family, with_loss, K, superbatch):
    return jax_make_eval_step(JaxMESM(jcfg), JaxCriterionConfig(**FAMILIES[family][1]),
                              _jax_encode, with_loss=with_loss, coalesce=K, superbatch=superbatch)


@pytest.mark.parametrize("with_loss", [False, True])
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("jax_superbatch", [False, True])
@pytest.mark.parametrize("family", ["charades", "qvh"])
def test_coalesced_step_matches_per_batch_and_jax(pair, family, jax_superbatch, K, with_loss):
    """The coalesced step (one superbatch form) at K = 2 and 3, with and
    without the loss, against K calls of the per-batch step; against JAX's
    coalesced step in both of its forms, its tuple form (K staged batches)
    at K = 2 and its superbatch form at K = 3."""
    jcfg, params, tmodel = pair
    make = FAMILIES[family][0]
    hosts = [make(10 + j) for j in range(K)]
    step = _port_step(tmodel, family, with_loss, K)
    assert step.coalesce == K
    got = step(_port_arg(hosts))
    one = _port_step(tmodel, family, with_loss)
    assert one.coalesce == 1
    preds, losses = got if with_loss else (got, {})
    for j, h in enumerate(hosts):
        ref = one(stage_batch(h, False, "cpu"))
        ref_preds, ref_losses = ref if with_loss else (ref, {})
        for key, want in ref_preds.items():
            assert preds[key].shape[0] == K
            assert _err(_np(preds[key][j]), _np(want)) <= SELF_TOL, (key, j)
        for key, want in ref_losses.items():
            assert _err(_np(losses[key][j]), _np(want)) <= SELF_TOL, (key, j)
        assert set(losses) == set(ref_losses)

    if K != (3 if jax_superbatch else 2):  # JAX's compile dominates: each form at one K
        return
    rng = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        jstep = _jax_coalesced(jcfg, family, with_loss, K, jax_superbatch)
        if jax_superbatch:
            jarg = jax_stage_superbatch(hosts, cast_bf16=False)
        else:
            jarg = tuple(jax_stage_batch(h, False) for h in hosts)
        jpreds, jlosses = jstep(params, {}, jarg, rng)
    if with_loss:  # the JAX draw injected, as the other parity tests do
        got = step(_port_arg(hosts), neg_idx_rows=torch.from_numpy(_jax_neg(hosts, rng)))
        preds, losses = got
        assert set(losses) == set(jlosses)
        for key, want in jlosses.items():
            assert _err(_np(losses[key]), want) <= TOL, key
    for key, want in jpreds.items():
        assert _err(_np(preds[key]), np.asarray(want, np.float32)) <= TOL, key


def test_hoist_forms_agree_and_a_mismatched_staging_raises(pair):
    """The forward given its videos projected ahead (`video_proj_g`, the
    coalesced step's hoist) against the forward projecting `video_feat_g`
    itself: the same predictions. The superbatch's unique videos are staged
    as rows (K * NG * Lv, Dv); a superbatch whose rows, leading axis or
    form do not match the step raises."""
    _, _, tmodel = pair
    hosts = [charades_batch(20 + j) for j in range(2)]
    jb = stage_batch(hosts[0], False, "cpu")
    one = _port_step(tmodel, "charades", False)
    inside = one(jb)
    with torch.no_grad():
        proj = tmodel.input_vid_proj(jb["video_feat_g"])
    ahead = one({**{k: v for k, v in jb.items() if k != "video_feat_g"}, "video_proj_g": proj})
    for key, want in inside.items():
        assert _err(_np(ahead[key]), _np(want)) <= SELF_TOL, key
    sb = _port_step(tmodel, "charades", False, 2)
    staged = stage_superbatch(hosts, False, "cpu")
    assert "video_feat_g" not in staged
    K, NG, Lv = staged["video_mask_g"].shape
    assert staged["video_feat_rows"].shape == (K * NG * Lv, TRAIN["v_feat_dim"])
    with pytest.raises(ValueError, match="video_feat_rows expects"):
        sb(dict(staged, video_feat_rows=staged["video_feat_rows"][:-1]))
    with pytest.raises(ValueError, match="leading axis 2"):
        sb(stage_superbatch(hosts + hosts[:1], False, "cpu"))
    with pytest.raises(TypeError, match="one stacked dict"):
        sb(tuple(stage_batch(h, False, "cpu") for h in hosts))


def test_stage_superbatch_expands_the_qvh_group_video():
    """One batched gather per superbatch gives each row its group's SS
    video, as stage_batch does per batch; float32 fields of ndim >= 3 cast
    to bf16 when asked, the others kept."""
    hosts = [qvh_batch(30 + j) for j in range(3)]
    sb = stage_superbatch(hosts, True, "cpu")
    for j, h in enumerate(hosts):
        one = stage_batch(h, True, "cpu")
        assert set(one) == set(sb)
        for key, t in one.items():
            assert sb[key].dtype == t.dtype and torch.equal(sb[key][j], t), key
    assert sb["ss_video_feat"].dtype == torch.bfloat16 and sb["video_mask"].dtype == torch.bool
    sig = staged_signature(sb)
    seen = []
    again = stage_superbatch(hosts, True, "cpu", into=lambda s: seen.append(s))
    assert seen == [sig] and staged_signature(again) == sig
    # `into` names the tensors the fields are written to
    dst = {k: torch.zeros_like(v) for k, v in sb.items()}
    out = stage_superbatch(hosts, True, "cpu", into=lambda s: dst)
    assert all(out[k] is dst[k] and torch.equal(dst[k], sb[k]) for k in sb)


# ---------------------------------------------------------------------------
# compute_mr_results
# ---------------------------------------------------------------------------


def _meta(tag, n):
    return dict(n_rows=n, duration=[10.0 + i for i in range(n)],
                qid=[f"{tag}-q{i}" for i in range(n)], sentence=[f"{tag}-s{i}" for i in range(n)],
                video_id=[f"{tag}-v{i}" for i in range(n)])


# 3 batches at one length, then 2 at a longer one: at K = 2 a signature
# flush and a padded remainder
LOADER_SHAPES = ((1, 0), (2, 0), (3, 0), (4, 8), (5, 8))
EVAL_OPT = types.SimpleNamespace(sort_results=True, clip_len=1, max_ts_val=100,
                                 compute_dtype="float32")


def _loader():
    return [(charades_batch(s, lv), _meta(f"b{s}", 8)) for s, lv in LOADER_SHAPES]


def _same_rows(a, b, atol_windows=0.0, atol_sal=0.0):
    assert [r["qid"] for r in a] == [r["qid"] for r in b]
    for ra, rb in zip(a, b):
        assert ra["vid"] == rb["vid"] and ra["query"] == rb["query"]
        np.testing.assert_allclose(np.asarray(ra["pred_relevant_windows"]),
                                   np.asarray(rb["pred_relevant_windows"]), atol=atol_windows)
        np.testing.assert_allclose(np.asarray(ra["pred_saliency_scores"]),
                                   np.asarray(rb["pred_saliency_scores"]), atol=atol_sal)


class ReusingStep:
    """A coalesced step that writes its outputs into the same tensors at
    every call, as a CUDA graph replay does."""

    def __init__(self, inner):
        self.inner, self.coalesce = inner, inner.coalesce
        self.out = {}  # output shapes -> the tensors returned for them

    def __call__(self, arg):
        got = self.inner(arg)
        key = tuple(tuple(v.shape) for v in got.values())
        if key not in self.out:
            self.out[key] = {k: v.clone() for k, v in got.items()}
        for k, v in got.items():
            self.out[key][k].copy_(v)
        return self.out[key]


@pytest.mark.parametrize("jax_superbatch", [False, True])
def test_compute_mr_results_coalesced_equals_sequential_and_jax(pair, jax_superbatch):
    """The coalesced compute_mr_results against the per-batch one and, on
    the same loader, against JAX's with each of its step forms."""
    from mesm_tpu.evaluate import compute_mr_results as jax_compute_mr_results
    from mesm_tpu_torch.evaluate import compute_mr_results

    jcfg, params, tmodel = pair
    loader = _loader()
    seq = compute_mr_results(_port_step(tmodel, "charades", False), loader, EVAL_OPT, "cpu")
    co_step = _port_step(tmodel, "charades", False, 2)
    co = compute_mr_results(co_step, loader, EVAL_OPT, "cpu")
    assert [r["qid"] for r in seq] == [m["qid"][i] for _, m in loader for i in range(8)]
    _same_rows(seq, co)
    # a step whose outputs the next call overwrites: compute_mr_results copies out
    reused = compute_mr_results(ReusingStep(co_step), loader, EVAL_OPT, "cpu")
    _same_rows(seq, reused)
    with jax.default_matmul_precision("highest"):
        jstep = jax_make_eval_step(JaxMESM(jcfg), None, _jax_encode, with_loss=False,
                                   coalesce=2, superbatch=jax_superbatch)
        want = jax_compute_mr_results(params, {}, jstep, loader, EVAL_OPT, jax.random.PRNGKey(4))
    _same_rows(want, co, atol_windows=1.1e-3, atol_sal=TOL)


def test_compute_mr_results_coalesced_losses_equal_sequential(pair):
    """The trainer's eval: every batch's loss terms reach the meters in the
    same order, the padding's not at all."""
    from mesm_tpu_torch.evaluate import compute_mr_results
    from mesm_tpu_torch.utils import AverageMeter

    _, _, tmodel = pair
    loader = _loader()
    meters = {}
    for k in (1, 2):
        m = meters[k] = __import__("collections").defaultdict(AverageMeter)
        compute_mr_results(_port_step(tmodel, "charades", True, k), loader,
                           EVAL_OPT, "cpu", m)
    assert set(meters[1]) == set(meters[2]) and "loss_overall" in meters[1]
    for key, m in meters[1].items():
        assert meters[2][key].count == m.count == len(loader)
        assert abs(meters[2][key].avg - m.avg) <= SELF_TOL * max(1.0, abs(m.avg)), key


# ---------------------------------------------------------------------------
# the warm-up, K, and the graph key
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bucket_root(tmp_path_factory):
    """A synthetic charades root with videos of 15-40 clips (max_video_l 40)
    and 4 length buckets; (config path, row capacity)."""
    from synth_root import make_charades_root

    root = str(tmp_path_factory.mktemp("coalesce_buckets"))
    cfg_path = make_charades_root(root, n_videos=16)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(max_video_l=40, eval_len_buckets=4, n_devices=1)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg_path


def _loaders(cfg_path):
    from mesm_tpu import runner as jax_runner
    from mesm_tpu.config import BaseOptions as JaxOptions
    from mesm_tpu_torch import runner
    from mesm_tpu_torch.config import BaseOptions

    jopt = JaxOptions().parse(["--config_file", cfg_path])
    topt = BaseOptions().parse(["--config_file", cfg_path, "--device", "cpu"])
    jl = jax_runner.build_loaders(jopt, jax_runner.get_vocab(jopt), splits="val")[2]
    tl = runner.build_loaders(topt, runner.get_vocab(topt))[0]
    return topt, jl, tl


def test_planned_bucket_batches_equal_jax(bucket_root):
    from mesm_tpu.evaluate import planned_bucket_batches as jax_planned
    from mesm_tpu_torch.evaluate import planned_bucket_batches

    _, jl, tl = _loaders(bucket_root)
    assert set(jl) == set(tl)
    for split in tl:
        got, want = planned_bucket_batches(tl[split]), jax_planned(jl[split])
        assert got == want and len(got) > 1
    assert planned_bucket_batches(_loader()) is None


def test_warm_eval_step_restores_visit_counts(pair, bucket_root):
    from mesm_tpu_torch import runner
    from mesm_tpu_torch.evaluate import compute_mr_results, warm_eval_step

    opt, _, loaders = _loaders(bucket_root)
    loader = next(iter(loaders.values()))
    model = runner.build_model(opt).eval()
    encode = runner.build_text_encoder(opt, runner.get_vocab(opt), "cpu")
    step = make_eval_step(model, encode, torch.float32, coalesce=2)
    base = compute_mr_results(step, loader, opt, "cpu")
    ds = loader.dataset
    ds._visit_counts = {0: 3, 5: 1}
    before = dict(ds._visit_counts)
    assert warm_eval_step(step, loader, opt, "cpu") > 1
    assert ds._visit_counts == before
    assert warm_eval_step(make_eval_step(model, encode, torch.float32), loader, opt, "cpu") == 0
    _same_rows(base, compute_mr_results(step, loader, opt, "cpu"))


def test_eval_coalesce_from_opt_matches_jax():
    from mesm_tpu.runner import eval_coalesce_from_opt as jax_k
    from mesm_tpu_torch.runner import eval_coalesce_from_opt

    for k in (-1, 0, 1, 2, 8, 32, 64):
        for n in (None, 0, 1, 5, 31, 124):
            for buckets in (1, 4):
                opt = types.SimpleNamespace(eval_coalesce=k, eval_len_buckets=buckets)
                assert eval_coalesce_from_opt(opt, n, "cpu") == jax_k(opt, n), (k, n, buckets)
    # on a CUDA device auto is 32, then capped at the batches per bucket
    for k, n, buckets, want in ((-1, None, 4, 32), (-1, 124, 4, 31), (-1, 3, 4, 1),
                                (-1, 4000, 1, 32), (8, 124, 4, 8), (1, 124, 4, 1)):
        opt = types.SimpleNamespace(eval_coalesce=k, eval_len_buckets=buckets)
        assert eval_coalesce_from_opt(opt, n, torch.device("cuda")) == want


def test_graph_key_follows_parameters_and_dispatch_state(pair, monkeypatch):
    """A graph records one version of the derived weights and one set of
    dispatch decisions: an in-place parameter update drops every graph, and
    any switch of kernels.dispatch_state() gives another key."""
    _, _, tmodel = pair
    step = _port_step(tmodel, "charades", False, 2)
    staged = stage_superbatch([charades_batch(40 + j) for j in range(2)], False, "cpu")
    sig = staged_signature(staged)
    key = step._key(sig)
    step._refresh()
    step._graphs[key] = tstep._Graph(None, staged, None, None)
    assert step.static_inputs(sig) is staged
    states = {kernels.dispatch_state()}
    with kernels.pallas_scope("off"):
        assert step._key(sig) != key and step.static_inputs(sig) is None
        states.add(kernels.dispatch_state())
    for name, value in (("SHORTKEY_VARIANT", "kernel"), ("INT8_FFN", True),
                        ("DOT_STATS_LN", True), ("ATTN_REMAT", True)):
        with monkeypatch.context() as m:
            m.setattr(kernels, name, value)
            assert step._key(sig) != key, name
            states.add(kernels.dispatch_state())
    with monkeypatch.context() as m:
        m.setenv(kernels.ATTN_VARIANT_ENV, "per_head")
        assert step._key(sig) != key
        states.add(kernels.dispatch_state())
    assert len(states) == 7 and step._key(sig) == key
    assert step.static_inputs(sig) is staged  # nothing changed: the graph stays
    p = next(tmodel.parameters())
    with torch.no_grad():
        p.add_(0.0)  # a new _version, the same data_ptr: an optimizer step's stamp
    assert step.static_inputs(sig) is None and not step._graphs


def test_optimizer_step_moves_the_parameters_stamps(pair):
    """The trainer's AdamW updates in place: data_ptr stays, _version moves
    (the stamp the graphs and ops/_weight_cache.py key on)."""
    from mesm_tpu_torch.parallel.step import build_optimizer

    model = torch.nn.Linear(4, 3)
    opt = build_optimizer(model, 1e-3)
    before = [(p.data_ptr(), p._version) for p in model.parameters()]
    with torch.enable_grad():
        model(torch.randn(2, 4)).sum().backward()
    opt.step()
    after = [(p.data_ptr(), p._version) for p in model.parameters()]
    assert [a[0] for a in after] == [b[0] for b in before]
    assert all(a[1] > b[1] for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


# eval batches of 4 rows: the synthetic root's test split then takes several
# groups of 3 batches, the last one padded
ROWS = dict(row_capacity=4)


def test_inference_at_eval_coalesce_3_matches_jax_and_per_batch(run_dir, caplog):  # noqa: F811
    import logging

    from mesm_tpu.evaluate import inference as jax_inference
    from mesm_tpu_torch.evaluate import inference as torch_inference

    root, eval_cfg = run_dir
    with jax.default_matmul_precision("highest"):
        want, _ = jax_inference(["--config_file", _write_cfg(root, eval_cfg, "jax_k3", **ROWS),
                                 "--eval_coalesce", "3"])
    with caplog.at_level(logging.INFO, logger="mesm_tpu_torch.evaluate"):
        got, _ = torch_inference(["--config_file", _write_cfg(root, eval_cfg, "torch_k3", **ROWS),
                                  "--device", "cpu", "--eval_coalesce", "3"])
    assert any("(K = 3)" in r.getMessage() for r in caplog.records)
    one, _ = torch_inference(["--config_file", _write_cfg(root, eval_cfg, "torch_k1", **ROWS),
                              "--device", "cpu", "--eval_coalesce", "1"])
    assert got["brief"] and set(got["brief"]) == set(want["brief"]) == set(one["brief"])
    for key, value in want["brief"].items():
        assert got["brief"][key] == value == one["brief"][key], key
