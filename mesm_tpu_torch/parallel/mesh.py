"""The process mesh of a multi-card run, and each rank's rows of a batch.

Counterpart of mesm_tpu/parallel/mesh.py on torch.distributed's DeviceMesh.
The mesh has two named dims, `data` (the batch's rows are split over it;
parameters and optimizer state are replicated) and `model` (the FFN
tensor-parallel split of parallel/tp.py; size 1 unless asked for). Where
the JAX package device_puts a batch with its rows sharded and lets XLA
insert the collectives, each rank here keeps its rows (`shard_batch`) and
the train step reads the rest of the batch through parallel/rows.py.

The JAX package's sequence sharding (`seq_batch_sharding`,
`shard_batch_seq`: video length over `model`) has no counterpart yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .multihost import local_rows, local_view

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the processes of the default group: n / mp
    data ranks of `model_parallel` model ranks each. `n_devices` (default:
    the world size) must be the world size; the device type follows the
    group's backend (NCCL: cuda, gloo: cpu)."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices over {world} processes: run one process per card")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: DeviceMesh, n_rows: int) -> slice:
    """This rank's rows of an n_rows-row batch: rows split over `data`,
    the same rows on every rank of `model`."""
    return local_rows(n_rows, mesh.get_local_rank(DATA_AXIS), mesh.size(0))


def replicated_sharding(mesh: DeviceMesh) -> None:
    """Replicated tensors need no placement: every rank holds them whole."""
    return None


def shard_batch(batch: Dict, mesh: DeviceMesh, micro: int = 1) -> Dict:
    """This rank's rows of every row-leading leaf of `batch`
    (multihost.local_view over the data dim)."""
    return local_view(batch, mesh.get_local_rank(DATA_AXIS), mesh.size(0), micro)


def data_group(mesh: DeviceMesh):
    """The process group of this rank's `data` dim (for parallel/rows.py)."""
    return mesh.get_group(DATA_AXIS)
