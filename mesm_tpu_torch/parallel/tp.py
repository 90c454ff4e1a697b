"""Tensor parallelism over the mesh's `model` dim: the Megatron split of
every feed-forward.

Counterpart of mesm_tpu/parallel/tp.py, where GSPMD inserts the collectives
for annotated parameter shardings. Here the split is explicit. In every
transformer layer's FFN (models/layers.ffn: the T2V / enhance layers, the
DETR encoder and decoder layers, the SS-recon stack; `linear1` / `linear2`,
and the TwoMLP's `linear1_1` / `linear2_1`):

    linear1 weight (F, D), bias (F,): rows split over `model`   column-parallel
    linear2 weight (D, F):            columns split over `model` row-parallel
    linear2 bias (D,):                replicated

linear1's input enters through an identity whose backward sums the input's
gradient over the model ranks; linear2's partial products are summed over
them by an all-reduce (autograd-aware: its backward is the identity) before
its bias. The FFN's PReLU slope is replicated but meets only this rank's
hidden columns, so its gradient is summed over the model ranks too. Attention stays replicated, as in the JAX package. The state-dict
names do not change: a sharded parameter is a slice of the whole tensor,
and `tp_full_state_dict` gathers the whole tensors back for a checkpoint,
which rank 0 writes. The train step counts the shards once in the clip's
global norm (parallel/step.apply_update reads `tp_group`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import Linear
from .mesh import MODEL_AXIS

COLUMN_PARALLEL = ("linear1", "linear1_1")
ROW_PARALLEL = ("linear2", "linear2_1")


def tp_param_spec(name: str, param: torch.Tensor) -> Optional[int]:
    """The dim of parameter `name` that the model dim splits, or None for a
    replicated one."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in COLUMN_PARALLEL and ((leaf == "weight" and param.dim() == 2)
                                      or (leaf == "bias" and param.dim() == 1)):
        return 0
    if module in ROW_PARALLEL and leaf == "weight" and param.dim() == 2:
        return 1
    return None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelLinear(Linear):
    """A Linear holding rows [r*F/m, (r+1)*F/m) of the whole weight and bias."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_CopyToModel.apply(x, self.tp_group))


class RowParallelLinear(Linear):
    """A Linear holding columns [r*F/m, (r+1)*F/m) of the whole weight; its
    partial products are summed over the model ranks, then the bias added."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(F.linear(x, self.weight.to(x.dtype)), self.tp_group)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def tp_shard_params(model: nn.Module, mesh) -> nn.Module:
    """Split every FFN of `model` over the mesh's `model` dim, in place: each
    sharded parameter keeps this rank's slice (marked `tp_group`, `tp_dim`),
    linear1 / linear2 become Column / RowParallelLinear. FFN widths must
    divide by the model dim's size. Returns the model."""
    group = mesh.get_group(MODEL_AXIS)
    m, r = mesh.size(1), mesh.get_local_rank(MODEL_AXIS)

    def sum_over_model(grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=group)
        return grad

    for module in model.modules():
        activation = getattr(module, "activation", None)
        if hasattr(module, COLUMN_PARALLEL[0]) and isinstance(activation, nn.Module):
            for p in activation.parameters():
                p.register_hook(sum_over_model)
    for name, module in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in COLUMN_PARALLEL + ROW_PARALLEL and isinstance(module, Linear):
            module.__class__ = ColumnParallelLinear if leaf in COLUMN_PARALLEL else RowParallelLinear
            module.tp_group = group
    for name, p in model.named_parameters():
        dim = tp_param_spec(name, p)
        if dim is None:
            continue
        if p.shape[dim] % m != 0:
            raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does not divide over {m} ranks")
        with torch.no_grad():
            p.data = p.data.chunk(m, dim=dim)[r].contiguous()
        p.tp_group, p.tp_dim = group, dim
    return model


def count_tp_sharded(model: nn.Module) -> int:
    """The number of parameters the layout splits."""
    return sum(tp_param_spec(n, p) is not None for n, p in model.named_parameters())


def tp_full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict with every shard gathered back to its whole tensor (a
    collective: every model rank calls it)."""
    params = dict(model.named_parameters())
    out = {}
    for name, t in model.state_dict().items():
        p = params.get(name)
        group = getattr(p, "tp_group", None)
        if group is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[name] = torch.cat(parts, dim=p.tp_dim)
    return out
