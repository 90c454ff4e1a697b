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
path runs the same code with no collective. The shard of an axis
(`ShardAxis`) and its collectives (`gather_over`, `sum_over`) serve the
video axis of parallel/seq.py too.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shard:
    """One axis of the batch split over the ranks of a process group."""
    group: object
    rank: int
    world: int


class ShardAxis:
    """The shard of one batch axis that the code in a `scope` block runs
    under (None outside one)."""

    def __init__(self, name: str):
        self._var: contextvars.ContextVar = contextvars.ContextVar(name, default=None)

    @contextlib.contextmanager
    def scope(self, group=None):
        token = self._var.set(Shard(group, dist.get_rank(group), dist.get_world_size(group)))
        try:
            yield
        finally:
            self._var.reset(token)

    def current(self) -> Optional[Shard]:
        return self._var.get()

    def world(self) -> int:
        shard = self._var.get()
        return 1 if shard is None else shard.world


def all_gather(x: torch.Tensor, shard: Shard, dim: int = 0) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(shard.world)]
    dist.all_gather(parts, x.contiguous(), group=shard.group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    """all_gather along `dim`; the backward sums the whole axis' gradient
    over the ranks and returns this rank's slice of it (all_reduce, which
    every backend has, in place of a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        return all_gather(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad.narrow(ctx.dim, ctx.shard.rank * ctx.n, ctx.n), None, None


def gather_over(x: Optional[torch.Tensor], shard: Optional[Shard],
                dim: int = 0) -> Optional[torch.Tensor]:
    """Every rank's slice of `dim` of `x`, in rank order (None stays None;
    `x` itself outside a shard), with the gradient carried back to the rank
    that holds each slice."""
    if shard is None or x is None:
        return x
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), shard, dim).bool()
    if x.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(x, shard, dim)
    return all_gather(x, shard, dim)


def sum_over(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The sum over the ranks of a tensor that needs no gradient (a count, a
    normaliser); `x` itself outside a shard."""
    if shard is None:
        return x
    y = x.detach().reshape(-1).clone()
    dist.all_reduce(y, group=shard.group)
    return y.reshape(x.shape)


_ROWS = ShardAxis("mesm_torch_row_shard")
current = _ROWS.current
world = _ROWS.world  # the number of data ranks (1 outside a shard)


def row_shard(group=None):
    """Within the block, this rank holds rows [rank * b, (rank + 1) * b) of
    every batch of world * b rows, over the data-axis `group` (the default
    group when None)."""
    return _ROWS.scope(group)


def gather(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The whole batch's rows of a row-leading tensor (None stays None),
    with the gradient carried back to the rank that holds each row."""
    return gather_over(x, current())


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch row-leading tensor."""
    shard = current()
    if shard is None:
        return x
    rows = x.shape[0] // shard.world
    return x[shard.rank * rows:(shard.rank + 1) * rows]


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data ranks of a tensor that needs no gradient."""
    return sum_over(x, current())
