"""Shared building blocks: dtype-following Linear and LayerNorm, LinearBlock,
InputProj, MLP, and the transformer layers' feed-forward (`ffn`).

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
from ..ops.ffn_int8 import ffn_int8
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


# calls that took the dot-stats LayerNorm (apply_ln); no kernel is launched
dot_stats_calls = 0


def ln_dot_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """LayerNorm with the statistics of mesm_tpu/models/layers.py:90-123: the
    mean is the f32 sum of x over d, E[x^2] the f32 sum of x * x squared in
    the input dtype (so a bf16 square is rounded to bf16 before the sum, as
    JAX's dot with a ones vector does), the variance clamped at 0 and y
    computed in f32, then returned in the input dtype."""
    d = x.shape[-1]
    mean = x.sum(-1, keepdim=True, dtype=torch.float32) / d
    mean2 = (x * x).sum(-1, keepdim=True, dtype=torch.float32) / d
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((x.float() - mean) * mul + bias.float()).to(x.dtype)


def apply_ln(norm: nn.LayerNorm, x: torch.Tensor, training: bool) -> torch.Tensor:
    """`norm` on x, or, in eval where kernels.use_dot_stats_ln says so, the
    same parameters through ln_dot_stats (mesm_tpu/models/layers.py:126-142).
    The parameters stay the LayerNorm module's, so the state dict is
    unchanged."""
    global dot_stats_calls
    if not training and kernels.use_dot_stats_ln(x.numel() // x.shape[-1], x.shape[-1], x.device):
        dot_stats_calls += 1
        return ln_dot_stats(x, norm.weight, norm.bias, norm.eps)
    return norm(x)


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


def ffn(x: torch.Tensor, linear1: nn.Linear, activation: nn.Module, linear2: nn.Linear,
        dropout: nn.Module, training: bool) -> torch.Tensor:
    """linear1 -> activation -> dropout -> linear2, the feed-forward of every
    transformer layer (mesm_tpu/models/layers.py FFN, :266-331). In eval, a
    PReLU FFN over at least kernels.INT8_FFN_MIN_ROWS rows runs as the fused
    int8 kernel (ops/ffn_int8.py) where kernels.use_int8_ffn says so; the
    layers keep their upstream parameter names either way."""
    if (not training and isinstance(activation, PReLU)
            and getattr(linear2, "tp_group", None) is None  # not split (parallel/tp.py)
            and x.numel() // x.shape[-1] >= kernels.INT8_FFN_MIN_ROWS
            and kernels.use_int8_ffn(x.device)):
        return ffn_int8(x, linear1.weight, linear1.bias, activation.weight, linear2.weight,
                        linear2.bias)
    return linear2(dropout(activation(linear1(x))))


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
            x = apply_ln(self.LayerNorm, x, self.training)
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
