"""The benchmark's weights: drawn from the run's seed on the device, the same
for the measured program's model and the reference's.

Parameters are taken in the order of their names (the upstream state-dict
names, which both models carry), and one draw of a torch.Generator seeded
by the run's seed fills them all: LayerNorm scales 1 + 0.1 z, PReLU slopes
0.25, biases 0.02 z, matrices z / sqrt(fan_in), the learned tokens z.
"""
from __future__ import annotations

import torch
from torch import nn


def _kind(model: nn.Module, name: str, p: torch.Tensor) -> str:
    owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(owner, nn.LayerNorm):
        return "ln_weight" if leaf == "weight" else "bias"
    if isinstance(owner, nn.PReLU):
        return "prelu"
    if p.dim() >= 2:
        return "matrix"
    return "bias" if leaf.endswith("bias") else "token"


@torch.no_grad()
def fill_from_seed(model: nn.Module, seed: int) -> None:
    params = sorted(model.named_parameters(), key=lambda kv: kv[0])
    device = params[0][1].device
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 17) % (2**63))
    z = torch.randn(sum(p.numel() for _, p in params), generator=gen, device=device)
    off = 0
    for name, p in params:
        v = z[off:off + p.numel()].view(p.shape)
        off += p.numel()
        kind = _kind(model, name, p)
        if kind == "ln_weight":
            p.copy_(1.0 + 0.1 * v)
        elif kind == "prelu":
            p.fill_(0.25)
        elif kind == "bias":
            p.copy_(0.02 * v)
        elif kind == "matrix":
            p.copy_(v / p.shape[-1] ** 0.5)
        else:
            p.copy_(v)
