"""Data- and tensor-parallel training of the port on torch.distributed
(mesm_tpu_torch/parallel/{multihost,mesh,tp,rows}.py), on 2-process gloo
clusters on the CPU, against one process on the whole batch: the
counterparts of the JAX package's multi-device train step
(mesm_tpu/train.py:202-204, __graft_entry__.py:141 dryrun_multichip legs 1,
2 and 4) and its tests (tests/test_multihost.py, tests/test_tp.py).

One cluster run (tests/torch_dist_worker.py, cases in
tests/torch_dist_cases.py) trains, from one torch seed with dropout 0, two
steps of each case: data parallel with the first step's negatives and MLM
masks injected, data parallel with them drawn from the step's seed,
--grad_accum 2 under data parallelism, both on a batch that carries each
video once as well, and the FFN tensor-parallel split on
a (data 1, model 2) mesh. Losses within 1e-6 of the single-process step's
(in units of max(1, |loss|)), parameters after AdamW within 1e-6; the TP
split's losses within rtol 2e-5, as tests/test_tp.py holds the JAX one.
`local_rows` / `local_view` against mesm_tpu.parallel.multihost's."""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_cases as C
from mesm_tpu.parallel import multihost as jmh
from mesm_tpu_torch.parallel import multihost as tmh
from mesm_tpu_torch.parallel import rows, tp
from mesm_tpu_torch.parallel.step import make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Runs the 2-process cluster once; {case: npz}."""
    out = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
                               str(r), str(WORLD), str(port), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {case: np.load(out / f"{case}.npz")
            for case in ("global_batch", "dp", "dp_drawn", "dp_accum2", "dp_video",
                         "dp_video_accum2", "tp")}


def _single(k: int, inject: bool):
    m = C.model()
    batch = {key: torch.from_numpy(np.asarray(v)) for key, v in C.host_batch().items()}
    return C.run_steps(m, batch, k, inject), m.state_dict()


def _metrics(npz) -> list:
    names = [str(n) for n in npz["metric_names"]]
    return [dict(zip(names, row)) for row in npz["metrics"]]


def _check(npz, want_metrics, want_state, loss_tol=1e-6, param_tol=1e-6, rtol=None):
    got = _metrics(npz)
    assert len(got) == len(want_metrics)
    for g, w in zip(got, want_metrics):
        assert set(g) == set(w)
        for key in w:
            if key == "grad_norm" or key.startswith("loss"):
                if rtol is None:
                    assert abs(g[key] - w[key]) <= loss_tol * max(1.0, abs(w[key])), (key, g[key], w[key])
                else:
                    np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=key)
    for name, t in want_state.items():
        np.testing.assert_allclose(npz[f"param/{name}"], t.numpy(), atol=param_tol, rtol=0,
                                   err_msg=name)


def test_global_batch_assembles_the_ranks_rows(cluster):
    host = C.host_batch()
    got = cluster["global_batch"]
    assert sorted(got.files) == sorted(host)
    for key, v in host.items():
        np.testing.assert_array_equal(got[key], np.asarray(v), err_msg=key)


def test_data_parallel_step_equals_single_process(cluster):
    _check(cluster["dp"], *_single(1, True))


def test_data_parallel_draws_equal_single_process(cluster):
    """The negatives and MLM masks drawn for the whole batch from the step's
    seed on each rank, each keeping its rows: the single-process draws."""
    _check(cluster["dp_drawn"], *_single(1, False))


def test_data_parallel_grad_accum_equals_single_process(cluster):
    _check(cluster["dp_accum2"], *_single(C.K, True))


@pytest.mark.parametrize("k", [1, C.K])
def test_data_parallel_per_video_batch_equals_single_process(cluster, k):
    """A batch that carries each video once (the train collate's layout with
    --dedup_video on): each rank keeps every video and its rows' slots
    (multihost.local_view), builds its rows on the device, and the update is
    the single process's on the per-row batch. Rank 0's counters: each step
    its videos once a step and its rows of the batch."""
    npz = cluster["dp_video" if k == 1 else "dp_video_accum2"]
    _check(npz, *_single(k, True))
    n_videos = len(np.unique(C.host_batch()["group_id"]))
    np.testing.assert_array_equal(npz["counters"], [C.STEPS * n_videos, C.STEPS * C.B // WORLD])


def test_tp_ffn_split_equals_replicated(cluster):
    """Losses within rtol 2e-5, as tests/test_tp.py holds the JAX split.
    Parameters within 1e-5: the keys' in-projection bias has a gradient of
    zero up to rounding (the softmax does not see it), and AdamW's first
    step moves such an entry by up to lr whichever way the rounding of the
    split sums points it."""
    metrics, state = _single(1, False)
    _check(cluster["tp"], metrics, state, param_tol=1e-5, rtol=2e-5)


def test_tp_layout_shards_every_ffn():
    m = C.model()
    n = tp.count_tp_sharded(m)
    # per FFN: linear1 weight and bias, linear2 weight; the TwoMLP enhance
    # layer has two FFNs
    ffns = sum(1 for name, _ in m.named_modules() if name.endswith(("linear1", "linear1_1")))
    assert n == 3 * ffns and n >= 10
    assert tp.tp_param_spec("transformer.encoder.layers.0.linear2.bias", torch.zeros(3)) is None
    assert tp.tp_param_spec("t2v_encoder.t2v_encoder.layers.0.self_attn.in_proj_weight",
                            torch.zeros(3, 3)) is None


def test_rows_are_the_identity_outside_a_shard():
    x = torch.arange(6.0).reshape(3, 2)
    assert rows.current() is None
    assert rows.gather(x) is x and rows.local(x) is x and rows.all_sum(x) is x


def test_local_rows_and_view_match_jax():
    for n_rows, count in ((16, 4), (8, 2), (6, 1)):
        for p in range(count):
            assert tmh.local_rows(n_rows, p, count) == jmh.local_rows(n_rows, p, count)
    with pytest.raises(ValueError):
        tmh.local_rows(10, 0, 4)
    full = C.host_batch()
    for p in range(2):
        got, want = tmh.local_view(full, p, 2), jmh.local_view(full, p, 2)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_local_view_takes_the_rows_of_each_microbatch():
    full = {"x": np.arange(16).reshape(8, 2), "ss_video_feat_groups": np.zeros((3, 4))}
    got = tmh.local_view(full, 1, 2, micro=2)
    np.testing.assert_array_equal(got["x"][:, 0], [4, 6, 12, 14])
    assert got["ss_video_feat_groups"].shape == (3, 4)


def test_train_step_without_data_parallel_opens_no_shard():
    m = C.model()
    opt = torch.optim.SGD(m.parameters(), lr=0.0)
    seen = []

    def encode(b):
        seen.append(rows.current())
        return C.encode(b)

    step = make_train_step(m, C.CRITERION, encode, opt, C.CLIP, C.SEED)
    batch = {key: torch.from_numpy(np.asarray(v)) for key, v in C.host_batch().items()}
    with torch.enable_grad():
        step(batch, 0)
    assert seen == [None]


def test_nccl_is_the_only_cuda_backend():
    assert tmh.backend_for("cuda") == "nccl"
    assert tmh.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        tmh.backend_for("meta")


def _train_config(root: str, name: str) -> str:
    import json

    path = os.path.join(root, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(exp_id=name, n_epoch=1, dropout=0.0, input_dropout=0.0, stop_score="miou",
               num_workers=0)
    out = os.path.join(root, f"{name}.json")
    with open(out, "w") as f:
        json.dump(cfg, f)
    return out


def test_train_entry_point_on_two_processes_equals_one(tmp_path):
    """`torchrun --nproc_per_node 2 -m mesm_tpu_torch.train --device cpu` on
    the synthetic charades root (dropout 0) against the single-process
    entry point: the same epoch losses in the train log, parameters after
    the epoch within 1e-6, and rank 0 alone wrote the run directory."""
    import glob
    import signal

    from mesm_tpu_torch.train import train

    from synth_root import make_charades_root

    root = str(tmp_path)
    make_charades_root(root)
    one = train(["--config_file", _train_config(root, "one"), "--device", "cpu"])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(WORLD), "-m", "mesm_tpu_torch.train", "--config_file", _train_config(root, "two"),
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log = proc.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    assert "backend gloo, world 2" in log
    two_dirs = glob.glob(os.path.join(os.path.dirname(one["opt"].result_dir), "*-two-*"))
    assert len(two_dirs) == 1, two_dirs

    def losses(run_dir):
        with open(os.path.join(run_dir, "train.log.txt")) as f:
            return [line.split("[Loss]")[1].strip() for line in f if "[Loss]" in line]

    assert losses(two_dirs[0]) == losses(one["opt"].result_dir)
    two = torch.load(os.path.join(two_dirs[0], "model_latest.ckpt"), weights_only=False)["model"]
    for name, value in one["model"].state_dict().items():
        np.testing.assert_allclose(two[name].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
