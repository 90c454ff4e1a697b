"""Training batches that carry each video once (`--dedup_video on`, the
default): the train collate stages each video of a batch once
(`video_feat_g`, `video_slot`), and the train step builds the rows' videos
on the device (parallel/step.expand_video_rows) before the microbatch split,
the shards and the model.

- The port's train step, two steps on one host batch in the per-row and in
  the per-video layout, for the charades and TACoS families of
  tests/torch_seq_cases.py and TACoS at --grad_accum 2: losses, every
  gradient, AdamW's moments and the weights bit for bit; once more at the
  shipped dropouts (0.1 / 0.5), whose masks each row draws from the step's
  seeded generators.
- The counters: one step adds its videos and rows.
- The collate on the synthetic charades root: the training spec emits the
  batch's videos once and its rows point at them (padded rows at row 0's),
  `--dedup_video off` and list-valued (QVHighlights) entries keep the
  per-row layout, and the eval spec is the JAX package's.

The data-parallel case (a per-video batch over two gloo ranks) is in
tests/test_torch_distributed.py."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_seq_cases as C
from mesm_tpu_torch import kernels
from mesm_tpu_torch.data.pipeline import stage_batch
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.models.mesm import MESM, MESMConfig
from mesm_tpu_torch.parallel import step as step_lib
from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step

from synth import per_video_layout

STEPS = 2
SHIPPED_DROPOUT = dict(dropout=0.1, input_dropout=0.5)


@pytest.fixture(autouse=True)
def _grad_mode():
    # tests/test_transformer_oracle.py turns grad mode off at import
    with torch.enable_grad():
        yield


def _train(case: str, host: dict, **cfg):
    """STEPS steps of the case's model from its torch seed on `host`, staged
    as the train loop stages it: (each step's metrics, the last gradients,
    AdamW's moments, the weights), by parameter name."""
    family, k = C.CASES[case]
    spec = C.FAMILIES[family]
    torch.manual_seed(0)
    m = MESM(MESMConfig(**dict(spec["cfg"], **cfg)))
    opt = build_optimizer(m, C.LR, C.WD)
    step = make_train_step(m, CriterionConfig(**spec["criterion"]), C.encode, opt, C.CLIP,
                           C.SEED, grad_accum=k)
    metrics = []
    with kernels.pallas_scope(spec["mode"]):
        for i in range(STEPS):
            out = step(stage_batch(host, False, "cpu"), i)
            metrics.append({key: v.detach().clone() for key, v in out.items()})
    named = list(m.named_parameters())
    grads = {n: p.grad.detach().clone() for n, p in named}
    moments = {n: (opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone())
               for n, p in named}
    weights = {n: p.detach().clone() for n, p in named}
    return metrics, grads, moments, weights


def _assert_identical(a, b):
    for got, want in zip(a, b):
        if isinstance(want, list):
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for key in w:
                    assert torch.equal(g[key], w[key]), key
            continue
        assert set(got) == set(want)
        for name, w in want.items():
            if isinstance(w, tuple):
                assert all(torch.equal(x, y) for x, y in zip(got[name], w)), name
            else:
                assert torch.equal(got[name], w), name


@pytest.mark.parametrize("case", ["charades", "tacos", "tacos_accum2"])
def test_per_video_batch_trains_as_the_per_row_batch(case):
    host = C.host_batch(C.CASES[case][0])
    _assert_identical(_train(case, per_video_layout(host)), _train(case, host))


def test_per_video_batch_keeps_the_dropout_draws():
    """At the shipped dropouts each row draws its own masks from the step's
    seeded generators: the two layouts draw the same, and the draws are
    there (the losses are not those at dropout 0)."""
    host = C.host_batch("tacos")
    per_row = _train("tacos", host, **SHIPPED_DROPOUT)
    _assert_identical(_train("tacos", per_video_layout(host), **SHIPPED_DROPOUT), per_row)
    plain = _train("tacos", host)
    assert not torch.equal(per_row[0][0]["loss_overall"], plain[0][0]["loss_overall"])


def test_counters_count_a_steps_videos_and_rows():
    host = C.host_batch("charades")
    video = per_video_layout(host)
    step_lib.video_groups_staged = step_lib.video_rows_expanded = 0
    torch.manual_seed(0)
    m = MESM(MESMConfig(**C.FAMILIES["charades"]["cfg"]))
    step = make_train_step(m, CriterionConfig(**C.FAMILIES["charades"]["criterion"]), C.encode,
                           build_optimizer(m, C.LR, C.WD), C.CLIP, C.SEED)
    step(stage_batch(host, False, "cpu"), 0)
    assert (step_lib.video_groups_staged, step_lib.video_rows_expanded) == (0, 0)
    step(stage_batch(video, False, "cpu"), 1)
    assert step_lib.video_groups_staged == len(video["video_feat_g"]) < C.B
    assert step_lib.video_rows_expanded == C.B


def test_expansion_drops_the_per_video_fields_and_casts_the_videos_first():
    video = {k: torch.from_numpy(v) for k, v in
             per_video_layout(C.host_batch("charades")).items()}
    out = step_lib.expand_video_rows(video, torch.bfloat16)
    assert "video_feat_g" not in out and "video_mask_g" not in out
    assert out["video_feat"].dtype == torch.bfloat16
    assert torch.equal(out["video_feat"],
                       video["video_feat_g"].to(torch.bfloat16)[video["video_slot"].long()])
    per_row = {"video_feat": out["video_feat"], "video_mask": video["video_mask"]}
    assert step_lib.expand_video_rows(per_row, torch.float32) is per_row


# -- the collate ----------------------------------------------------------------


@pytest.fixture(scope="module")
def charades(tmp_path_factory):
    """(options, train dataset, test dataset) of the synthetic charades root."""
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.config import BaseOptions

    from synth_root import make_charades_root

    root = str(tmp_path_factory.mktemp("video_rows"))
    make_charades_root(root)
    opt = BaseOptions().parse(["--config_file", os.path.join(root, "config.json"),
                               "--device", "cpu"])
    vocab = R.get_vocab(opt)
    train = R.build_dataset(opt, "train", recfw=opt.rec_fw, vocab=vocab)
    test = R.build_dataset(opt, "test", recfw=False, vocab=vocab)
    return opt, train, test


def _options(opt, **changes):
    return type(opt)(**dict(vars(opt), **changes))


def _train_entries(opt, ds, spec):
    """Each train batch's indices and entries (an entry's draws change at
    every read, so both layouts collate the same read)."""
    from mesm_tpu_torch.data.sampler import RowBudgetBatcher

    return [(idx, [ds[i] for i in idx])
            for idx in RowBudgetBatcher(ds, spec.row_capacity, shuffle=True, seed=opt.seed)]


def test_train_collate_stages_each_video_once(charades):
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.data.collate import make_collate

    opt, ds, _ = charades
    spec = R.make_batch_spec(opt, ds, for_eval=False)
    assert spec.video_groups_cap > 0 and spec.video_groups_exact
    collate = make_collate(spec)
    per_row = make_collate(dataclasses.replace(spec, video_groups_cap=0))
    batches = _train_entries(opt, ds, spec)
    assert batches
    sizes, padded = set(), 0
    for idx, entries in batches:
        (b, meta), (want, _) = collate(entries), per_row(entries)
        assert "video_feat" not in b
        videos = {ds.merged_data[i]["video_id"][0] for i in idx}
        assert b["video_feat_g"].shape[0] == len(idx) == len(videos)
        sizes.add(len(idx))
        n = meta["n_rows"]
        padded += n < spec.row_capacity
        assert (b["video_slot"][n:] == b["video_slot"][0]).all()  # padded rows: row 0's video
        np.testing.assert_array_equal(b["video_feat_g"][b["video_slot"]], want["video_feat"])
        np.testing.assert_array_equal(b["video_mask_g"][b["video_slot"]], want["video_mask"])
        assert set(b) - {"video_feat_g", "video_mask_g", "video_slot"} == set(want) - {"video_feat"}
        for key in want:
            if key != "video_feat":
                np.testing.assert_array_equal(b[key], want[key], err_msg=key)
    assert padded and len(sizes) > 1  # the number of videos varies from batch to batch


def test_train_collate_keeps_the_per_row_layout(charades):
    """--dedup_video off; a QVHighlights spec; entries whose video is a list
    of one array a row (QVHighlights' multi-clip entries)."""
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.data.collate import make_collate

    opt, ds, _ = charades
    off = R.make_batch_spec(_options(opt, dedup_video="off"), ds, for_eval=False)
    qvh = R.make_batch_spec(_options(opt, dataset_name="qvhighlights"), ds, for_eval=False)
    assert off.video_groups_cap == 0 and qvh.video_groups_cap == 0
    _, entries = _train_entries(opt, ds, off)[0]
    b, _ = make_collate(off)(entries)
    assert "video_feat" in b and "video_feat_g" not in b and "video_slot" not in b
    listed = [dict(e, video_feat=[e["video_feat"]] * e["num_clips"]) for e in entries]
    spec = R.make_batch_spec(opt, ds, for_eval=False)
    got, _ = make_collate(spec)(listed)
    assert "video_feat" in got and "video_feat_g" not in got
    np.testing.assert_array_equal(got["video_feat"], b["video_feat"])


def test_eval_spec_is_the_jax_packages(charades):
    """The eval spec's per-video cap (padded slots, for the eval step's
    graphs) is the JAX package's, and its batches keep the padded slots."""
    from mesm_tpu import runner as jax_runner
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.data.collate import make_collate
    from mesm_tpu_torch.data.sampler import RowBudgetBatcher

    opt, _, ds = charades
    spec = R.make_batch_spec(opt, ds, for_eval=True)
    jax_ds = jax_runner.build_dataset(opt, "test", recfw=False, vocab=jax_runner.get_vocab(opt))
    want = dataclasses.asdict(jax_runner.make_batch_spec(opt, jax_ds, for_eval=True))
    got = dataclasses.asdict(spec)
    assert not got.pop("video_groups_exact")
    assert got == want and spec.video_groups_cap > 0
    collate = make_collate(spec)
    for idx in RowBudgetBatcher(ds, spec.row_capacity, shuffle=False, drop_single_group=False,
                                max_entries=spec.video_groups_cap):
        b, _ = collate([ds[i] for i in idx])
        assert b["video_feat_g"].shape[0] == spec.video_groups_cap
