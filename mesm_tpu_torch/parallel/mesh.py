"""The process mesh of a multi-card run, and each rank's rows of a batch.

Counterpart of mesm_tpu/parallel/mesh.py on torch.distributed's DeviceMesh.
The mesh has two named dims, `data` (the batch's rows are split over it;
parameters and optimizer state are replicated) and `model` (the FFN
tensor-parallel split of parallel/tp.py; size 1 unless asked for). Where
the JAX package device_puts a batch with its rows sharded and lets XLA
insert the collectives, each rank here keeps its rows (`shard_batch`) and
the train step reads the rest of the batch through parallel/rows.py.

The JAX package's sequence sharding (mesh.py:55-78: the video-length axis
of `SEQ_AXIS_KEYS` over `model` as well) is `shard_batch_seq`: each rank
keeps its rows over `data` and its contiguous slice of axis 1 of those keys
over `model`, and the train step reads the rest of the video through
parallel/seq.py. The `model` dim then carries the sequence, never the FFN
split of parallel/tp.py in the same step (the JAX package runs them as
separate layouts too, __graft_entry__.py:270-300).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .multihost import GROUP_KEYS, local_rows, local_view

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


# batch keys whose second axis is the video-length axis (mesm_tpu/parallel/
# mesh.py:59-62)
SEQ_AXIS_KEYS = frozenset({
    "video_feat", "video_mask", "clip_mask", "saliency_label",
    "video_feat_g", "video_mask_g", "ss_video_feat", "ss_video_mask",
})


def seq_batch_sharding(mesh: DeviceMesh, key: str, shape) -> Tuple[slice, ...]:
    """This rank's index into a batch leaf `key` of `shape`: its rows over
    `data` (a per-group leaf, multihost.GROUP_KEYS, keeps every row) and,
    for SEQ_AXIS_KEYS, its contiguous slice of axis 1 over `model`: the
    block the JAX package's seq_batch_sharding places on this device. A
    video-length axis that does not divide over the model ranks raises."""
    rows = (slice(None) if key in GROUP_KEYS
            else local_rows(shape[0], mesh.get_local_rank(DATA_AXIS), mesh.size(0)))
    if key not in SEQ_AXIS_KEYS:
        return (rows,)
    k, L = mesh.size(1), shape[1]
    if L % k != 0:
        raise ValueError(f"{key}: video length {L} does not divide over {k} model ranks; "
                         f"sequence sharding needs every video-length axis divisible by {k}")
    per = L // k
    r = mesh.get_local_rank(MODEL_AXIS)
    return rows, slice(r * per, (r + 1) * per)


def shard_batch_seq(batch: Dict, mesh: DeviceMesh, micro: int = 1) -> Dict:
    """This rank's block of every leaf of `batch` (numpy arrays or tensors):
    shard_batch's rows, and of SEQ_AXIS_KEYS also this rank's slice of the
    video-length axis (seq_batch_sharding). With micro = k > 1 the rows are
    those of each of the k microbatches, as shard_batch takes them."""
    seq = {key: seq_batch_sharding(mesh, key, tuple(v.shape))[1]
           for key, v in batch.items() if key in SEQ_AXIS_KEYS}
    out = shard_batch(batch, mesh, micro)
    for key, sl in seq.items():
        out[key] = out[key][:, sl]
    return out


def model_group(mesh: DeviceMesh):
    """The process group of this rank's `model` dim (for parallel/seq.py)."""
    return mesh.get_group(MODEL_AXIS)
