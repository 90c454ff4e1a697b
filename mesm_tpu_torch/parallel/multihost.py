"""Multi-process data parallelism on torch.distributed: joining the process
group and each process's rows of every batch.

Counterpart of mesm_tpu/parallel/multihost.py. The feeding contract is the
JAX package's:

1. Every process builds the same epoch order (the samplers are
   deterministic in (seed, epoch), data/sampler.py), so batch boundaries
   agree without any coordination traffic.
2. Each process keeps only its own row slice of every global batch
   (`local_rows`, `local_view`): rows [p*B/P, (p+1)*B/P) of a B-row batch
   on process p. With gradient accumulation the slice is taken in each of
   the k microbatches, so a process holds its rows of each.
3. `global_batch` assembles the processes' rows into the whole batch on
   every process (an all_gather), where the JAX package assembles one
   sharded jax.Array.

`init_distributed` reads torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK). It joins with NCCL for CUDA and with gloo
only for the CPU (`--device cpu`); on CUDA it never falls back to gloo.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# batch keys whose leading axis is not the row axis (per-group tensors the
# rows index through `ss_group_slot` / `video_slot`): kept whole
GROUP_KEYS = frozenset({"ss_video_feat_groups", "ss_video_mask_groups", "video_feat_g",
                        "video_mask_g"})


def backend_for(device) -> str:
    """NCCL for CUDA, gloo for the CPU; nothing else."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def init_distributed(device, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None) -> bool:
    """Join the default process group for `device`. Returns whether this
    process is part of one.

    Under torchrun every argument comes from the environment: call with the
    device alone. Explicit arguments are for launchers that set no
    environment (tests): `coordinator_address` is "host:port" of rank 0.
    No-op when num_processes == 1, when no launcher set WORLD_SIZE and no
    arguments are given, or when the group is already up. On CUDA each
    process takes the card of its LOCAL_RANK before joining."""
    if dist.is_initialized():
        return True
    if num_processes == 1 or (num_processes is None and "WORLD_SIZE" not in os.environ):
        return False
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL was asked for, but no CUDA device is available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend)
    logger.info(f"joined the process group: backend {dist.get_backend()}, "
                f"world {dist.get_world_size()}, rank {dist.get_rank()}")
    return True


def _index_count(process_index, process_count):
    p = process_index if process_index is not None else (dist.get_rank() if dist.is_initialized() else 0)
    n = process_count if process_count is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return p, n


def local_rows(n_rows: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """This process's row slice of every n_rows-row global batch. n_rows
    must divide by the process count (a config choice: the collate's
    row-budget packs have a fixed row capacity, rounded to --n_devices)."""
    p, n = _index_count(process_index, process_count)
    if n_rows % n != 0:
        raise ValueError(
            f"global batch of {n_rows} rows does not divide over {n} processes; "
            f"pick batch_size as a multiple of the process count"
        )
    per = n_rows // n
    return slice(p * per, (p + 1) * per)


def local_view(batch: Dict, process_index: Optional[int] = None,
               process_count: Optional[int] = None, micro: int = 1) -> Dict:
    """A batch dict (numpy arrays or tensors) cut to this process's rows.
    With `micro` = k > 1 the rows are cut into k microbatches first and the
    process keeps its rows of each, in order (what parallel/step.split_micro
    then splits again). GROUP_KEYS stay whole."""
    n_rows = next(v for k, v in batch.items() if k not in GROUP_KEYS).shape[0]
    if n_rows % micro != 0:
        raise ValueError(f"grad_accum={micro} needs the batch's {n_rows} rows divisible by it")
    sl = local_rows(n_rows // micro, process_index, process_count)
    out = {}
    for k, v in batch.items():
        if k in GROUP_KEYS:
            out[k] = v
            continue
        a = v if isinstance(v, torch.Tensor) else np.asarray(v)
        parts = a.reshape((micro, n_rows // micro) + tuple(a.shape[1:]))[:, sl]
        out[k] = parts.reshape((-1,) + tuple(a.shape[1:]))
    return out


def global_batch(local: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Every process's rows of each row-leading tensor, concatenated in rank
    order: the whole batch on every process."""
    world = dist.get_world_size(group)
    out = {}
    for k, v in local.items():
        parts = [torch.empty_like(v) for _ in range(world)]
        dist.all_gather(parts, v.contiguous(), group=group)
        out[k] = torch.cat(parts, 0)
    return out
