"""Sequence sharding of the port's train step (mesm_tpu_torch/parallel/
{mesh,seq,step}.py): the video-length axis over the mesh's `model` ranks,
the counterpart of the JAX package's shard_batch_seq step
(mesm_tpu/parallel/mesh.py:55-78, tests/test_seq_sharding.py).

Two gloo clusters on the CPU, started together (tests/torch_seq_worker.py,
cases in tests/torch_seq_cases.py): 1 data x 2 seq ranks and 2 data x 2
seq ranks. Each runs one fp32 train step of the three config families
(charades C+SF, TACoS TwoMLP + triplet under the kernel dispatch "on", QVH
with its SS video), and of TACoS at grad_accum 2, on its block of the
batch, against one process on the
whole batch: every loss term, loss_overall and grad_norm within 1e-5 of
max(1, |x|), every gradient (unclipped) within 1e-5 of max(1, max |g|), the
same kernel-dispatch decisions (taken on the whole batch's lengths), and
every rank's parameters equal after the update. The JAX case holds the
port's step on tests/test_seq_sharding.py's geometry against JAX's own
shard_batch_seq step (2 x 2 mesh of virtual CPU devices) from one converted
init and the JAX step's draws, at that test's rtol 2e-5 (loss) and 2e-4
(grad_norm). The placements of mesh.seq_batch_sharding equal JAX's
seq_batch_sharding's, and the refusals: a video axis that does not divide,
and sequence sharding with the FFN tensor-parallel split."""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_seq_cases as C
from mesm_tpu_torch import parallel
from mesm_tpu_torch.parallel import mesh as M
from mesm_tpu_torch.parallel import seq
from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
LAYOUTS = {"1x2": 2, "2x2": 4}  # layout -> processes
TIMEOUT_S = 120
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """JAX's shard_batch_seq step on JAX_CASE (dropout 0) on a 2 x 2 mesh:
    (its metrics, the directory holding the converted init and its draws)."""
    import jax
    import jax.numpy as jnp

    from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
    from mesm_tpu.models.mesm import MESM as JaxMESM
    from mesm_tpu.models.mesm import MESMConfig as JaxConfig
    from mesm_tpu.parallel import (TrainState, build_optimizer as jax_build_optimizer,
                                   make_mesh, make_train_step as jax_make_train_step,
                                   replicated_sharding, sample_out_of_group, shard_batch_seq)
    from mesm_tpu_torch.convert import state_dict_from_jax_params
    from mesm_tpu_torch.models.mesm import MESMConfig

    c = C.JAX_CASE
    model = JaxMESM(JaxConfig(**c["cfg"]))
    jb = {k: jnp.asarray(v) for k, v in C.jax_case_batch().items()}
    B = c["batch"]["B"]
    args = (jb["video_feat"], jb["video_mask"], jb["words_feat"], jb["words_mask"],
            jb["sentence_feat"])
    kw = dict(clip_mask=jb["clip_mask"], words_weight=jb["words_weight"],
              unknown_mask=jb["unknown_mask"], ss_sent_idx=jb["ss_sent_idx"],
              ss_sent_mask=jb["ss_sent_mask"], ss_own_pos=jb["ss_own_pos"])
    with jax.default_matmul_precision("highest"):
        params = jax.jit(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
             "mask_words": jax.random.PRNGKey(2)},
            *args, (jnp.arange(B, dtype=jnp.int32) + 1) % B, is_training=True,
            deterministic=True, **kw)["params"])()
        params = jax.tree.map(np.asarray, params)
        # the draws of the step's first call: split3(fold_in(key, 0)) =
        # (dropout, mask_words, negatives), parallel/step.py:173-176
        rng_drop, rng_mask, rng_neg = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(c["key"]), 0), 3)
        neg = sample_out_of_group(rng_neg, jb["group_id"], jb["row_mask"])
        out = model.apply({"params": params}, *args, neg, is_training=True, deterministic=False,
                          rngs={"dropout": rng_drop, "mask_words": rng_mask}, **kw)
        masks = np.array(out["masked_words_loc"])
        mesh = make_mesh(4, model_parallel=2)
        tx = jax_build_optimizer(lr=c["lr"], weight_decay=c["wd"], grad_clip=c["clip"])
        with mesh:
            repl = replicated_sharding(mesh)
            p = jax.device_put(jax.tree.map(jnp.asarray, params), repl)
            state = TrainState(step=jax.device_put(jnp.zeros((), jnp.int32), repl), params=p,
                               opt_state=jax.device_put(tx.init(p), repl))
            step = jax_make_train_step(model, JaxCriterionConfig(**c["criterion"]),
                                       lambda frozen, b: (b["words_feat"],
                                                          b["words_mask"].astype(bool),
                                                          b["sentence_feat"]), tx)
            _, metrics = step(state, {}, shard_batch_seq(jb, mesh), jax.random.PRNGKey(c["key"]))
            metrics = {k: float(v) for k, v in metrics.items()}
    out_dir = tmp_path_factory.mktemp("seq")
    torch.save({"state": state_dict_from_jax_params(params, MESMConfig(**c["cfg"])),
                "neg": torch.from_numpy(np.asarray(neg).astype(np.int64)),
                "masks": torch.from_numpy(masks)}, out_dir / "jax_case.pt")
    return metrics, out_dir


@pytest.fixture(scope="module")
def clusters(jax_case):
    """Runs both clusters once, side by side; {layout: out_dir}."""
    base = jax_case[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE]),
               OMP_NUM_THREADS="1")
    dirs, procs = {}, []
    for layout, world in LAYOUTS.items():
        out = base / layout
        out.mkdir()
        (out / "jax_case.pt").write_bytes((base / "jax_case.pt").read_bytes())
        port = _free_port()
        dirs[layout] = out
        procs += [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_seq_worker.py"),
                                    str(r), str(world), str(port), str(out)], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                  for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return dirs


@pytest.fixture(scope="module")
def single():
    """{case: (metrics, gradients, dispatch decisions)} of one process on
    the whole batch."""
    return {case: C.run_step(family, C.model(family), C.staged(family), grad_accum=k)
            for case, (family, k) in C.CASES.items()}


def _metrics(npz) -> dict:
    return dict(zip([str(n) for n in npz["metric_names"]], npz["metrics"].tolist()))


def _unclipped(grads, norm: float) -> dict:
    """The gradients before optax's clip_by_global_norm(CLIP) scaled them."""
    scale = max(norm, C.CLIP) / C.CLIP
    return {k: np.asarray(v, np.float64) * scale for k, v in grads.items()}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", C.CASES)
def test_losses_and_grad_norm_equal_single_process(clusters, single, case, layout):
    got = _metrics(np.load(clusters[layout] / f"{case}_{layout}.npz"))
    want = single[case][0]
    assert set(got) == set(want)
    for key, w in want.items():
        assert abs(got[key] - w) <= TOL * max(1.0, abs(w)), (key, got[key], w)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", C.CASES)
def test_gradients_equal_single_process(clusters, single, case, layout):
    npz = np.load(clusters[layout] / f"{case}_{layout}.npz")
    want_metrics, want_grads, _ = single[case]
    got = _unclipped({k[len("grad/"):]: npz[k] for k in npz.files if k.startswith("grad/")},
                     _metrics(npz)["grad_norm"])
    want = _unclipped({k: v.numpy() for k, v in want_grads.items()}, want_metrics["grad_norm"])
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= TOL * max(1.0, float(np.abs(w).max())), (name, err)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", C.CASES)
def test_dispatch_decides_on_the_whole_lengths(clusters, single, case, layout):
    """Every attention call's (B, Lq, Lk, pair, training, route) under the
    shard is the single process's: the DETR encoder's local queries (33 of
    65) keep the route of the whole sample, TACoS's "batched" (kernel 6,
    and kernel 9's backward)."""
    got = [tuple(c) for c in np.load(clusters[layout] / f"{case}_{layout}.npz")["calls"]]
    want = [tuple(str(x) for x in c) for c in single[case][2]]
    assert got == want
    family, k = C.CASES[case]
    if family == "tacos":  # the two encoder layers of each microbatch
        assert sum(c[-1] == "batched" for c in got) == 2 * k


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", C.CASES)
def test_every_rank_applies_the_same_update(clusters, case, layout):
    assert bool(np.load(clusters[layout] / f"{case}_{layout}.npz")["params_same"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_matches_jax_shard_batch_seq_step(clusters, jax_case, layout):
    """tests/test_seq_sharding.py's tolerances: loss rtol 2e-5, grad_norm
    rtol 2e-4."""
    want = jax_case[0]
    got = _metrics(np.load(clusters[layout] / f"jax_{layout}.npz"))
    assert np.isfinite(got["loss_overall"])
    np.testing.assert_allclose(got["loss_overall"], want["loss_overall"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-4)


class _Mesh:
    """The two DeviceMesh queries the placement reads, at mesh coordinates
    (d, m) of a (data, model) shape."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, name: str) -> int:
        return self.coords[0 if name == M.DATA_AXIS else 1]


def _jax_blocks(n_devices: int, model_parallel: int, key: str, shape) -> list:
    """JAX's seq_batch_sharding placement of `key` on each device of
    make_mesh(n, model_parallel), in device order: [(start, stop) per dim]."""
    from mesm_tpu.parallel import make_mesh, seq_batch_sharding

    jmesh = make_mesh(n_devices, model_parallel=model_parallel)
    index = seq_batch_sharding(jmesh, key).devices_indices_map(tuple(shape))
    return [[list(s.indices(n)[:2]) for s, n in zip(index[d], shape)]
            for d in jmesh.devices.reshape(-1)]


def _port_block(mesh, key: str, shape) -> list:
    block = M.seq_batch_sharding(mesh, key, shape)
    block = block + (slice(None),) * (len(shape) - len(block))
    return [list(s.indices(n)[:2]) for s, n in zip(block, shape)]


@pytest.mark.parametrize("layout", [(1, 2), (2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("key", ["video_feat", "video_mask", "ss_video_feat", "words_feat",
                                 "group_id"])
def test_placement_equals_jax_seq_batch_sharding(layout, key):
    d, m = layout
    shape = (8, 32, 3)[:1 if key == "group_id" else (2 if key == "video_mask" else 3)]
    want = _jax_blocks(d * m, m, key, shape)
    got = [_port_block(_Mesh(layout, (i // m, i % m)), key, shape) for i in range(d * m)]
    assert got == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_hold_the_blocks_jax_places_on_their_devices(clusters, layout):
    """Rank r of the cluster's mesh holds the block JAX's make_mesh places
    on device r, for a video-length key, its mask and a row-only key."""
    world = LAYOUTS[layout]
    shape = (C.B, C.LV, 3)
    for key in ("video_feat", "clip_mask", "words_feat"):
        want = _jax_blocks(world, 2, key, shape)
        for r in range(world):
            with open(clusters[layout] / f"placement_{r}.json") as f:
                got = json.load(f)
            assert (got["data"], got["model"]) == (r // 2, r % 2)
            block = got["blocks"][key] + [[0, n] for n in shape[len(got["blocks"][key]):]]
            assert block == want[r], (key, r)


def test_shard_batch_seq_slices_rows_and_video():
    batch = {"video_feat": np.arange(8 * 32 * 2).reshape(8, 32, 2), "group_id": np.arange(8),
             "video_feat_g": np.zeros((3, 32, 2)), "words_feat": np.zeros((8, 5, 2))}
    got = M.shard_batch_seq(batch, _Mesh((2, 4), (1, 2)))
    np.testing.assert_array_equal(got["video_feat"], batch["video_feat"][4:8, 16:24])
    np.testing.assert_array_equal(got["group_id"], [4, 5, 6, 7])
    assert got["video_feat_g"].shape == (3, 8, 2)  # a per-group leaf keeps its rows
    assert got["words_feat"].shape == (4, 5, 2)


def test_exports():
    assert parallel.SEQ_AXIS_KEYS == M.SEQ_AXIS_KEYS
    assert parallel.seq_batch_sharding is M.seq_batch_sharding
    assert parallel.shard_batch_seq is M.shard_batch_seq
    from mesm_tpu.parallel.mesh import _SEQ_AXIS_KEYS

    assert M.SEQ_AXIS_KEYS == _SEQ_AXIS_KEYS


def test_a_video_axis_that_does_not_divide_is_refused():
    mesh = _Mesh((1, 4), (0, 1))
    with pytest.raises(ValueError, match="does not divide"):
        M.seq_batch_sharding(mesh, "video_feat", (8, 30, 3))
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_batch_seq({"video_mask": np.zeros((8, 30), bool)}, mesh)
    assert M.seq_batch_sharding(mesh, "words_feat", (8, 30, 3)) == (slice(0, 8),)


def test_sequence_sharding_with_tp_is_refused():
    m = C.model("charades")
    m.transformer.encoder.layers[0].linear1.weight.tp_group = object()  # as tp_shard_params marks it
    opt = build_optimizer(m, C.LR, C.WD)
    with pytest.raises(ValueError, match="tensor-parallel"):
        make_train_step(m, C.CriterionConfig(), C.encode, opt, C.CLIP, C.SEED, seq_parallel=True)


def test_seq_is_the_identity_outside_a_shard():
    x = torch.arange(6.0).reshape(1, 3, 2)
    assert seq.current() is None and seq.world() == 1 and seq.whole_len(5, 1) == 5
    assert seq.gather(x) is x and seq.gather(x, start=1) is x and seq.all_sum(x) is x
    count = x[:, -1:, 0]
    before, total = seq.scan_counts(count)
    assert seq.sum_grad(x) is x and before is None and total is count
