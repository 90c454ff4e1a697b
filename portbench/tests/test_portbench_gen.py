"""The generator: one seed gives one data set, and every seed serves the
same sizes in another order; the mixes give the stated passes."""
from collections import Counter

import numpy as np
import pytest
import torch

from portbench import gen, harness


def _plan(cell: str, seed: int):
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.data.sampler import GroupAwareBatcher, RowBudgetBatcher

    h = harness.Run(cell, seed, 1.0, False, device="cpu")
    opt = h.options()
    ds = gen.Dataset(h.mix, h.cfg, seed, "cpu", features=False)
    if h.cell["driver"] == "train":
        spec = R.make_batch_spec(opt, ds, for_eval=False)
        b = GroupAwareBatcher(ds, spec.row_capacity, shuffle=True, seed=seed)
        plan = []
        for idx in b:
            plan.append(idx)
            if len(plan) == h.mix["batches"]:
                break
        return ds, spec, plan, None
    spec = R.make_batch_spec(opt, ds, for_eval=True)
    b = RowBudgetBatcher(ds, spec.row_capacity, shuffle=False, drop_single_group=False,
                         max_entries=spec.video_groups_cap)
    b.sort_by_length = len(spec.video_buckets) > 1
    plan = list(b)
    return ds, spec, plan, R.eval_coalesce_from_opt(opt, len(plan), torch.device("cuda"))


def _bucket(ds, spec, idx):
    vmax = max(ds.exact_length(i) for i in idx)
    return next(x for x in spec.video_buckets if x >= vmax) if spec.video_buckets else spec.max_video_l


@pytest.mark.parametrize("cell", ["tacos-eval", "charades-eval"])
def test_eval_mixes(cell):
    """The test splits' sizes, batch geometry, buckets and K."""
    want = {"tacos-eval": dict(videos=25, rows=4083, rowcap=49, ded=7, buckets=(600,), K=25,
                               batches=100),
            "charades-eval": dict(videos=1334, rows=3720, rowcap=84, ded=40,
                                  buckets=(24, 32, 40, 194), K=11, batches=45)}[cell]
    for seed in (1, 98765432109):
        ds, spec, plan, K = _plan(cell, seed)
        rows = sum(len(ds.merged_data[i]["qid"]) for idx in plan for i in idx)
        assert len(set(ds.clips.tolist()) | set()) > 0 and len(ds.clips) == want["videos"]
        assert rows == want["rows"]
        assert (spec.row_capacity, spec.video_groups_cap, spec.video_buckets) == (
            want["rowcap"], want["ded"], want["buckets"])
        assert K == want["K"]
        assert abs(len(plan) - want["batches"]) <= 1
        if cell == "tacos-eval":
            assert all(len({ds.merged_data[i]["video_id"][0] for i in idx}) <= 7 for idx in plan)


def test_seeds_share_sizes():
    """Two seeds: the same multiset of clip counts, sentences a video and
    words, in another order; the same bucket counts within one batch."""
    a, spec, plan_a, _ = _plan("charades-eval", 5)
    b, _, plan_b, _ = _plan("charades-eval", 6)
    assert sorted(a.clips.tolist()) == sorted(b.clips.tolist())
    assert a.clips.tolist() != b.clips.tolist()
    ca = Counter(_bucket(a, spec, idx) for idx in plan_a)
    cb = Counter(_bucket(b, spec, idx) for idx in plan_b)
    assert all(abs(ca[k] - cb[k]) <= 1 for k in set(ca) | set(cb))


def test_train_mix():
    ds, spec, plan, _ = _plan("tacos-train", 77)
    assert spec.row_capacity == 64 and len(plan) == 6
    for idx in plan:
        vids = [ds.merged_data[i]["video_id"][0] for i in idx]
        assert len(vids) == len(set(vids))  # one chunk of a video a batch
        assert 50 <= sum(len(ds.merged_data[i]["qid"]) for i in idx) <= 64


def test_same_seed_same_batches():
    from mesm_tpu_torch.data.collate import make_collate

    from portbench.tests import tiny

    h = harness.Run("charades-eval", 424242424242, 1.0, False, device="cpu",
                    overrides={"config": tiny.TINY_CONFIG,
                               "traffic": tiny.OVERRIDES["charades-eval"]["traffic"]})
    from mesm_tpu_torch import runner as R

    opt = h.options()
    out = []
    for _ in range(2):
        ds = gen.Dataset(h.mix, h.cfg, h.seed, "cpu")
        spec = R.make_batch_spec(opt, ds, for_eval=True)
        out.append(make_collate(spec)([ds[i] for i in range(1)])[0])
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k])
    ds = gen.Dataset(h.mix, h.cfg, h.seed + 1, "cpu")
    other = make_collate(spec)([ds[i] for i in range(1)])[0]
    assert not np.array_equal(other["cached_words_feat"], out[0]["cached_words_feat"])
    # features as the program's store gives them: unit clips and the TEF
    feat = ds[0]["video_feat"]
    np.testing.assert_allclose(np.linalg.norm(feat[:, :-2], axis=1), 1.0, rtol=1e-5)
    L = feat.shape[0]
    np.testing.assert_allclose(feat[:, -2], np.arange(L) / L, rtol=1e-6)


@pytest.mark.parametrize("cell", ["tacos-eval", "tacos-train"])
def test_tacos_clips_follow_durations(cell):
    """TACoS: each video's clips from its duration at one C3D feature a
    16-frame clip of 29.4 fps video, mean-pooled to the cap; the
    durations' lognormal has the published mean, and its longest video
    over the data set's 127 lasts the 1,402-clip maximum."""
    from statistics import NormalDist

    h = harness.Run(cell, 1, 1.0, False, device="cpu")
    clips, durations, *_ = gen._layout(h.mix, h.cfg)
    want = np.clip(np.floor(durations * 29.4 / 16), 1, 600).astype(int)
    np.testing.assert_array_equal(clips, want)
    longest = 1402 * 16 / 29.4
    median, sigma = gen.lognormal_from_mean_and_longest(286.59, longest, 127)
    assert abs(median * np.exp(sigma ** 2 / 2) - 286.59) < 1e-9
    z = NormalDist().inv_cdf((127 - 0.375) / 127.25)
    assert abs(median * np.exp(sigma * z) - longest) < 1e-6
    assert durations.max() <= longest + 1e-9
    assert 0 < (clips == 600).mean() < 1
