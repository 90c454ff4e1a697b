"""The row shard of a data-parallel train step: what the batch-global parts
of the model and the losses read of the other ranks' rows.

The JAX package writes its train step batch-logically and lets XLA turn the
row gathers of a sharded batch into collectives (mesm_tpu/parallel/mesh.py).
Here each rank runs the forward on its own rows only, and the parts that see
the whole batch read it through this module:

- the out-of-group negatives (parallel/step.sample_out_of_group over B x B,
  and the negative rows' text in models/mesm.py), the SS-MESM group gather
  (`sentence_feat[ss_sent_idx]`), the scrambled pair mask (row (b*H + h) % B,
  models/t2v.scrambled_pair_factors) and the MLM draw gather whole-batch
  tensors (`gather`) and take their own rows back (`local`);
- the batch-wide SS InfoNCE gathers the pooled text with its gradient;
- every normaliser and batch-wide count is summed over the ranks
  (`all_sum`).

With these, rank r's loss is the part of the single-process loss that its
rows contribute, the sum over ranks is the whole, and the sum of the ranks'
gradients (the gathers' backward returns each rank the gradient its rows
received from every other rank's loss) is the single-process gradient.

Outside `row_shard` every function is the identity, so the single-process
path runs the same code with no collective.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RowShard:
    group: object  # the process group of the data axis
    rank: int
    world: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("mesm_torch_row_shard", default=None)


@contextlib.contextmanager
def row_shard(group=None):
    """Within the block, this rank holds rows [rank * b, (rank + 1) * b) of
    every batch of world * b rows, over the data-axis `group` (the default
    group when None)."""
    token = _SHARD.set(RowShard(group, dist.get_rank(group), dist.get_world_size(group)))
    try:
        yield
    finally:
        _SHARD.reset(token)


def current() -> Optional[RowShard]:
    return _SHARD.get()


def _all_gather_rows(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(shard.world)]
    dist.all_gather(parts, x.contiguous(), group=shard.group)
    return torch.cat(parts, dim=0)


class _GatherRows(torch.autograd.Function):
    """all_gather along rows; the backward sums the whole batch's gradient
    over the ranks and returns this rank's rows of it (all_reduce, which
    every backend has, in place of a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        ctx.rows = x.shape[0]
        return _all_gather_rows(x, shard)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.shard.group)
        start = ctx.shard.rank * ctx.rows
        return grad[start:start + ctx.rows], None


def gather(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The whole batch's rows of a row-leading tensor (None stays None),
    with the gradient carried back to the rank that holds each row."""
    shard = current()
    if shard is None or x is None:
        return x
    if x.dtype == torch.bool:
        return _all_gather_rows(x.to(torch.uint8), shard).bool()
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, shard)
    return _all_gather_rows(x, shard)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch row-leading tensor."""
    shard = current()
    if shard is None:
        return x
    rows = x.shape[0] // shard.world
    return x[shard.rank * rows:(shard.rank + 1) * rows]


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of a tensor that needs no gradient (a count, a
    normaliser)."""
    shard = current()
    if shard is None:
        return x
    y = x.detach().reshape(-1).clone()
    dist.all_reduce(y, group=shard.group)
    return y.reshape(x.shape)
