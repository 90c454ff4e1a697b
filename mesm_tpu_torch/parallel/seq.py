"""The sequence shard of a train step: the video-length axis split over the
mesh's `model` ranks, and what the model and the losses read of the other
ranks' clips.

The JAX package device_puts the batch's video-length keys with
P(data, model) (mesm_tpu/parallel/mesh.py:55-78) and lets GSPMD insert the
collectives. Here each model rank holds a contiguous slice of axis 1 of
those keys (mesh.shard_batch_seq) and runs the per-clip parts of the model
on it: the video projection, the enhance and T2V stacks (video queries,
text keys), the DETR encoder's queries and FFNs, the saliency heads. The
parts that read the whole video axis read it through this module:

- the DETR encoder's keys and values, the decoder's memory, SS-MESM's video
  keys and the MLM's GT-clip compaction gather the whole axis (`gather`,
  with the gradient carried back to the rank that holds each clip);
- the sine positions take the earlier ranks' valid counts and the row's
  total (`scan_counts`);
- the saliency loss gathers the (B, L) scores, the rec_ss clip pooling sums
  its partial sums over the ranks (`sum_grad`), and the counts are summed
  (`all_sum`).

Everything after those collectives (the decoder and its losses, the matcher,
SS-MESM, the MLM, the text side, the global token's query row) is computed
alike on every model rank. The train step (parallel/step.py) therefore
weights each rank's loss by 1 / k and sums the gradients over the model
ranks: every collective's backward sums the ranks' gradients, so the sum is
the single-process gradient, and the replicated terms count once.

Outside `seq_shard` every function is the identity, so the single-process
path runs the same code with no collective.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .rows import ShardAxis, all_gather, gather_over, sum_over

_SEQ = ShardAxis("mesm_torch_seq_shard")
current = _SEQ.current
world = _SEQ.world  # the number of model ranks (1 outside a shard)


def seq_shard(group=None):
    """Within the block, this rank holds slice `rank` of k equal slices of
    axis 1 of every video-length tensor, over the model-axis `group` (the
    default group when None)."""
    return _SEQ.scope(group)


def whole_len(n: int, start: int = 0) -> int:
    """The whole axis' length of a local axis of n entries whose first
    `start` are replicated (the DETR encoder's global token) and the rest
    this rank's slice."""
    return start + (n - start) * world()


def gather(x: Optional[torch.Tensor], dim: int = 1, start: int = 0) -> Optional[torch.Tensor]:
    """The whole video axis of a sequence-sharded tensor (None stays None).
    Entries before `start` along `dim` are replicated and kept once, ahead
    of the ranks' slices."""
    shard = current()
    if shard is None or x is None:
        return x
    if start:
        return torch.cat([x.narrow(dim, 0, start),
                          gather_over(x.narrow(dim, start, x.shape[dim] - start), shard, dim)],
                         dim=dim)
    return gather_over(x, shard, dim)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of a tensor that needs no gradient (a count)."""
    return sum_over(x, current())


class _SumGrad(torch.autograd.Function):
    """all_reduce sum; the backward sums the gradient over the ranks too,
    since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        y = x.clone()
        dist.all_reduce(y, group=shard.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


def sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of partial sums (a pooled feature), with the
    gradient carried back to each rank's part."""
    shard = current()
    if shard is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _SumGrad.apply(x, shard)
    return all_sum(x)


def scan_counts(count: torch.Tensor) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(the sum of the earlier ranks' `count`, the sum over every rank) of a
    per-row count (B, 1) that needs no gradient; (None, count) outside a
    shard."""
    shard = current()
    if shard is None:
        return None, count
    counts = all_gather(count.detach(), shard, dim=1)  # (B, k)
    before = counts[:, :shard.rank].sum(1, keepdim=True)
    return before, counts.sum(1, keepdim=True)
