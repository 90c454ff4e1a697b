"""Checkpoints of the trainer, in the upstream torch layout.

The reference saves {model, optimizer, lr_scheduler, epoch, opt} with
torch.save (reference train.py:185-223); convert.load_mesm_checkpoint reads
that layout, so `mesm_tpu_torch.evaluate` scores what the trainer writes.
The model state holds no text encoder (it lives outside the model). Two keys
the reference does not write ride along for --resume_all: `step` (train
steps taken, which seed the draws of the next step) and `lr`. The JAX
package's own `mesm_tpu.v1` pickle format is not read here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, model, optimizer, epoch: int, opt: Dict, step: int, lr: float,
                    lr_drop: int, gamma: float) -> None:
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        # torch StepLR's state after `epoch` scheduler steps
        "lr_scheduler": {"step_size": lr_drop, "gamma": gamma, "base_lrs": [opt["lr"]],
                         "last_epoch": epoch + 1, "_last_lr": [lr]},
        "epoch": epoch,
        "opt": opt,
        "step": step,
        "lr": lr,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def count_parameters(model, verbose: bool = True) -> int:
    n = sum(p.numel() for p in model.parameters())
    if verbose:
        print(f"Parameter Count: trainable {n:,d}")
    return n
