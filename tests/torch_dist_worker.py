"""One process of the gloo clusters of tests/test_torch_distributed.py:

    python tests/torch_dist_worker.py <rank> <world> <port> <out_dir>

joins a localhost gloo group, assembles the whole batch from the ranks'
rows (multihost.global_batch), runs each case of torch_dist_cases.py on its
rows of the batch (data parallel, with and without gradient accumulation,
the negatives and MLM masks injected or drawn, the batch in the per-row and
in the per-video layout), then the FFN tensor-parallel
split on a (data 1, model 2) mesh, and rank 0 writes every case's metrics
and whole parameters to <out_dir>/<case>.npz."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_dist_cases as C  # noqa: E402
from mesm_tpu_torch.parallel import mesh as M  # noqa: E402
from mesm_tpu_torch.parallel import multihost, tp  # noqa: E402
from mesm_tpu_torch.parallel import step as step_lib  # noqa: E402
from synth import per_video_layout  # noqa: E402


def save(out_dir: str, case: str, metrics, state, **extra) -> None:
    np.savez(os.path.join(out_dir, f"{case}.npz"),
             metrics=np.array([[m[k] for k in sorted(m)] for m in metrics]),
             metric_names=np.array(sorted(metrics[0])),
             **{f"param/{k}": v.detach().numpy() for k, v in state.items()}, **extra)


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    multihost.init_distributed("cpu", f"localhost:{port}", world, rank)
    host = C.host_batch()
    local = {key: torch.from_numpy(np.asarray(v)) for key, v in multihost.local_view(host).items()}
    whole = multihost.global_batch(local)
    if rank == 0:
        np.savez(os.path.join(out_dir, "global_batch.npz"),
                 **{key: v.numpy() for key, v in whole.items()})
    video = per_video_layout(host)
    for case, k, inject, whole in (("dp", 1, True, host), ("dp_drawn", 1, False, host),
                                   ("dp_accum2", C.K, True, host), ("dp_video", 1, True, video),
                                   ("dp_video_accum2", C.K, True, video)):
        local = multihost.local_view(whole, micro=k)
        batch = {key: torch.from_numpy(np.asarray(v)) for key, v in local.items()}
        m = C.model()
        rows = multihost.local_rows(C.B // k)
        step_lib.video_groups_staged = step_lib.video_rows_expanded = 0
        metrics = C.run_steps(m, batch, k, inject, rows=rows, data_parallel=True)
        if rank == 0:
            save(out_dir, case, metrics, m.state_dict(),
                 counters=np.array([step_lib.video_groups_staged, step_lib.video_rows_expanded]))
    dp_mesh = M.make_mesh()
    assert M.batch_sharding(dp_mesh, C.B) == multihost.local_rows(C.B)
    assert M.replicated_sharding(dp_mesh) is None
    mesh = M.make_mesh(world, model_parallel=world)
    m = tp.tp_shard_params(C.model(), mesh)
    batch = {key: torch.from_numpy(np.asarray(v)) for key, v in M.shard_batch(host, mesh).items()}
    metrics = C.run_steps(m, batch, 1, False, data_parallel=True, data_group=M.data_group(mesh))
    full = tp.tp_full_state_dict(m)
    if rank == 0:
        save(out_dir, "tp", metrics, full)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
