"""One process of the gloo clusters of tests/test_torch_seq_sharding.py:

    python tests/torch_seq_worker.py <rank> <world> <port> <out_dir>

joins a localhost gloo group and lays the processes out as a (data, model)
mesh of 2 model ranks each (world 2: 1 data x 2 seq, world 4: 2 data x 2
seq). It writes its block's placement (mesh.seq_batch_sharding) to
<out_dir>/placement_<rank>.json, then runs one sequence-sharded train step
of each case of torch_seq_cases.py on its block of the family's batch
(mesh.shard_batch_seq, its rows of each microbatch) and, from the converted init and the draws the test
process left in <out_dir>/jax_case.pt, the JAX case. Rank 0 writes each
case's metrics, gradients and dispatch decisions to <out_dir>/<case>.npz;
every rank checks that the update left its parameters equal to rank 0's."""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_seq_cases as C  # noqa: E402
from mesm_tpu_torch.parallel import mesh as M  # noqa: E402
from mesm_tpu_torch.parallel import multihost  # noqa: E402


def params_equal_everywhere(m) -> bool:
    flat = torch.cat([p.detach().reshape(-1) for p in m.parameters()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(p, parts[0]) for p in parts)


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    multihost.init_distributed("cpu", f"localhost:{port}", world, rank)
    mesh = M.make_mesh(world, model_parallel=2)
    dp = mesh.size(0) > 1
    shards = dict(data_parallel=dp, data_group=M.data_group(mesh) if dp else None,
                  seq_parallel=True, seq_group=M.model_group(mesh))
    layout = f"{mesh.size(0)}x{mesh.size(1)}"
    with open(os.path.join(out_dir, f"placement_{rank}.json"), "w") as f:
        json.dump({"data": mesh.get_local_rank(M.DATA_AXIS),
                   "model": mesh.get_local_rank(M.MODEL_AXIS),
                   "blocks": {key: [[s.start, s.stop] for s in
                                    M.seq_batch_sharding(mesh, key, (C.B, C.LV, 3))]
                              for key in ("video_feat", "clip_mask", "words_feat")}}, f)
    for case, (family, k) in C.CASES.items():
        m = C.model(family)
        batch = M.shard_batch_seq(C.staged(family), mesh, micro=k)
        assert batch["video_feat"].shape[:2] == (C.B // mesh.size(0), C.LV // 2)
        metrics, grads, calls = C.run_step(family, m, batch, grad_accum=k, **shards)
        same = params_equal_everywhere(m)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{case}_{layout}.npz"),
                     metric_names=np.array(sorted(metrics)),
                     metrics=np.array([metrics[k] for k in sorted(metrics)]),
                     calls=np.array([[str(x) for x in c] for c in calls]).reshape(-1, 6),
                     params_same=np.array(same),
                     **{f"grad/{k}": v.numpy() for k, v in grads.items()})
    case = torch.load(os.path.join(out_dir, "jax_case.pt"))
    rows = M.batch_sharding(mesh, C.JAX_CASE["batch"]["B"])
    batch = M.shard_batch_seq({k: torch.from_numpy(np.asarray(v)) for k, v in
                               C.jax_case_batch().items()}, mesh)
    metrics = C.run_jax_case(case["state"], batch, case["neg"][rows], case["masks"][rows],
                             **shards)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"jax_{layout}.npz"),
                 metric_names=np.array(sorted(metrics)),
                 metrics=np.array([metrics[k] for k in sorted(metrics)]))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
