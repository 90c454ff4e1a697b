"""The sequence-sharded TACoS train step (parallel/seq.py) on one process
per card, or on one process alone as its reference:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m mesm_tpu_torch.scripts.seq_step [--data D] [--out run.json]
    python -m mesm_tpu_torch.scripts.seq_step [--out run.json]

Under torchrun the N processes form a (data D, model N / D) mesh
(parallel/mesh.make_mesh): each holds its rows over `data` and its slice
of the 600-clip video axis over `model` (mesh.shard_batch_seq), and runs
make_train_step(seq_parallel=True) (data_parallel too where D > 1) over
NCCL. The step is the kernel-engaged TACoS C3D_GloVe fp32 step of
bench.py:780-795 (B = 16, Lv = 600, full width and depth), with attention
and input dropout 0 so that it is the single process's step: its DETR
encoder runs kernel 6 (the fp32 batched forward) and kernel 9's backward
on the local queries (1 + 600 / k) against the gathered 601 keys. Weights
and the batch come from seed 0 (scripts/synthetic.py).

It runs STEPS steps and reports the first step's loss terms and
grad_norm, the attention kernels' launches over the steps, ms a step (each
step synchronised; the first, which starts the card's libraries, apart)
and each rank's peak device memory.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from .. import kernels
from ..losses import CriterionConfig
from ..models.mesm import MESM
from ..ops import attention_backward, attention_batched, attention_trainable
from ..parallel import mesh as M
from ..parallel import multihost
from ..parallel.step import build_optimizer, make_train_step
from . import synthetic

SEED = 2019
STEPS = 4


def _launches() -> dict:
    return {"attention_batched": attention_batched.launches,
            "attention_trainable": attention_trainable.launches,
            "attention_backward": attention_backward.backward_launches}


def _reset_launches() -> None:
    attention_batched.launches = attention_trainable.launches = 0
    attention_backward.backward_launches = 0


def run(data: int = 1) -> dict:
    """STEPS train steps on this process's block of the batch (the whole
    batch outside a process group). Returns this rank's report; under a
    process group with every rank's launches, ms and peak memory."""
    T = synthetic.TACOS
    dev = torch.device("cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    torch.manual_seed(0)
    model = MESM(synthetic.tacos_config(dropout=0.0, input_dropout=0.0,
                                        max_video_l=T["Lv"])).to(dev)
    batch = synthetic.make_train_batch(0, T["B"], T["Lv"], T["Dv"], T["Lw"], T["Dt"],
                                       model.cfg.num_classes, device=dev)
    shards = {}
    if world > 1:
        mesh = M.make_mesh(world, model_parallel=world // data)
        # this rank's block alone stays on the card
        batch = {k: v.clone() for k, v in M.shard_batch_seq(batch, mesh).items()}
        shards = dict(seq_parallel=True, seq_group=M.model_group(mesh), data_parallel=data > 1,
                      data_group=M.data_group(mesh) if data > 1 else None)
    optimizer = build_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, CriterionConfig(**synthetic.TACOS_CRITERION),
                           synthetic.encode_cached, optimizer, 0.1, SEED, **shards)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    ms, first = [], None
    with kernels.pallas_scope("auto"):
        for i in range(STEPS):
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in step(batch, i).items()}  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
            first = first or metrics
    later = ms[1:] or ms
    rank = {"launches": _launches(), "first_step_ms": ms[0],
            "ms_per_step": {"max": max(later), "min": min(later), "mean": sum(later) / len(later)},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "video_axis": int(batch["video_mask"].shape[1]), "rows": int(batch["video_mask"].shape[0])}
    out = {"world": world, "data": data if world > 1 else 1,
           "seq": world // data if world > 1 else 1, "steps": STEPS, "B": T["B"], "Lv": T["Lv"],
           "first_step": first, "last_loss": metrics["loss_overall"]}
    if world > 1:
        ranks = [None] * world
        dist.all_gather_object(ranks, rank)
        out.update(ranks=ranks, backend=dist.get_backend())
    else:
        out["ranks"] = [rank]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", type=int, default=1, help="data ranks (the rest split the video)")
    ap.add_argument("--out", default=None, help="rank 0 writes the report here as JSON")
    args = ap.parse_args(argv)
    multihost.init_distributed("cuda")
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        res = run(args.data)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(res), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
