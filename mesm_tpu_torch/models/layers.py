"""Shared building blocks: dtype-following Linear and LayerNorm, LinearBlock,
InputProj, MLP.

Parity targets: mesm_tpu/models/layers.py and the reference model/model.py
(LinearLayer :412, MLP :397). Module and parameter names are the upstream
torch state-dict names (mesm_tpu/convert.py build_mapping), so upstream
checkpoints load with load_state_dict(strict=True).

Parameters stay float32. Under bf16 compute the Dense layers cast their
weights to the activation dtype at use and LayerNorm computes in f32 and
returns the activation dtype, as the JAX package's flax layers do with
`dtype=bfloat16`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..ops.ln_dense import ln_dense


class Linear(nn.Linear):
    """nn.Linear whose weight and bias follow the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32, returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


class PReLU(nn.PReLU):
    """Single-slope PReLU (torch default, init 0.25) in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def make_activation(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "gelu":
        return nn.GELU()
    if name == "prelu":
        return PReLU()
    if name == "selu":
        return nn.SELU()
    raise ValueError(f"unsupported activation {name}")


class LinearBlock(nn.Module):
    """[LayerNorm] -> Dropout -> Linear -> [ReLU], the LayerNorm on the raw
    input (reference LinearLayer, model/model.py:412-434). In eval, where the
    dispatch says so, the whole block is one fused LayerNorm -> Dense kernel
    (ops/ln_dense.py), which reads the wide input once."""

    def __init__(self, in_features: int, out_features: int, layer_norm: bool = True,
                 dropout: float = 0.1, relu: bool = True):
        super().__init__()
        self.layer_norm = layer_norm
        if layer_norm:
            self.LayerNorm = LayerNorm(in_features, eps=1e-5)
        self.net = nn.Sequential(nn.Dropout(dropout), Linear(in_features, out_features))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm:
            if not self.training and kernels.use_fused_ln_dense(x.shape[-1], x.device):
                proj = self.net[1]
                return ln_dense(
                    x, self.LayerNorm.weight, self.LayerNorm.bias, proj.weight, proj.bias,
                    relu=self.relu,
                )
            x = self.LayerNorm(x)
        x = self.net(x)
        return F.relu(x) if self.relu else x


class InputProj(nn.ModuleList):
    """n LinearBlocks; the ReLU flags are [True]*3 with index n-1 set False,
    truncated to n (reference model/model.py:51-62)."""

    def __init__(self, in_features: int, features: int, n_layers: int = 2, dropout: float = 0.5):
        relu_flags = [True, True, True]
        relu_flags[n_layers - 1] = False
        super().__init__(
            LinearBlock(in_features if i == 0 else features, features, True, dropout, relu_flags[i])
            for i in range(n_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self:
            x = block(x)
        return x


class MLP(nn.Module):
    """num_layers Linear layers with ReLU between (none after the last)
    (reference model/model.py:397-409)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims: Sequence[int] = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            Linear(n, k) for n, k in zip([input_dim] + list(dims), list(dims) + [output_dim])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
