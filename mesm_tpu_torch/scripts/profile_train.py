"""Trace the port's train step and print where the device's time goes:
per kernel (utils/trace_report.report) and per module, the backward's
kernels as "<backward>" (utils/trace_report.module_report).

    python -m mesm_tpu_torch.scripts.profile_train [--trace-dir traces/train]
        [--iters 4] [--geometry tacos|charades] [--B N] [--dtype float32|bfloat16]
        [--dropout D] [--grad-accum K] [--kernels auto|on|off] [--attn-remat]
        [--device cuda|cpu]

The port of scripts/profile_train.py. tacos (the default) is the
kernel-engaged TACoS C3D_GloVe step of bench.py:780-795: B = 16, 600-clip
videos, fp32, attention dropout 0, so the trainable attention kernel and
its backward run in the DETR encoder; charades is C+SF_C as shipped
(B = 32, dropout 0.1). Weights and batches come from a seed
(scripts/synthetic.py). One warm-up step, then `--iters` steps under
utils/profiling.maybe_trace with the model's module ranges.
"""
from __future__ import annotations

import argparse

import torch

from .. import kernels
from ..losses import CriterionConfig
from ..models.mesm import MESM
from ..parallel.step import build_optimizer, make_train_step
from ..utils.profiling import maybe_trace, step_annotation
from ..utils.trace_report import module_report, report
from . import synthetic

SEED = 2019


def build(geometry: str, B: int, dropout: float, dtype: torch.dtype, grad_accum: int, device):
    """(model, train step, batch) of a geometry, from seed 0."""
    torch.manual_seed(0)
    if geometry == "tacos":
        T = synthetic.TACOS
        model = MESM(synthetic.tacos_config(dropout=dropout)).to(device)
        ccfg = CriterionConfig(**synthetic.TACOS_CRITERION)
        batch = synthetic.make_train_batch(0, B, T["Lv"], T["Dv"], T["Lw"], T["Dt"],
                                           model.cfg.num_classes, device=device)
    else:
        model = MESM(synthetic.charades_config(dropout=dropout)).to(device)
        ccfg = CriterionConfig(**synthetic.CHARADES_CRITERION)
        batch = synthetic.make_train_batch(1, B, 194, 2818, 16, 512, model.cfg.num_classes,
                                           device=device)
    optimizer = build_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, ccfg, synthetic.encode_cached, optimizer, 0.1, SEED, dtype,
                           grad_accum=grad_accum)
    return model, step, batch


def run(trace_dir: str, iters: int = 4, geometry: str = "tacos", B: int = None,
        dropout: float = None, dtype: str = "float32", grad_accum: int = 1,
        device: str = "cuda", depth: int = 3, top: int = 30) -> dict:
    B = B or (synthetic.TACOS["B"] if geometry == "tacos" else 32)
    dropout = (0.0 if geometry == "tacos" else 0.1) if dropout is None else dropout
    model, step, batch = build(geometry, B, dropout, getattr(torch, dtype), grad_accum,
                               torch.device(device))
    step(batch, 0)
    with maybe_trace(trace_dir, model=model):
        for i in range(1, iters + 1):
            with step_annotation(f"train_step_{i}"):
                metrics = step(batch, i)
            float(metrics["loss_overall"])
    return {"report": report(trace_dir, top), "module_report": module_report(trace_dir, depth),
            "loss": float(metrics["loss_overall"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace-dir", default="traces/train")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--geometry", default="tacos", choices=["tacos", "charades"])
    ap.add_argument("--B", type=int, default=None, help="rows a batch (16 tacos, 32 charades)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--dropout", type=float, default=None,
                    help="attention dropout (0 tacos, 0.1 charades)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--kernels", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--attn-remat", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but no CUDA device is available")
    saved = kernels.ATTN_REMAT
    kernels.ATTN_REMAT = args.attn_remat
    try:
        with kernels.pallas_scope(args.kernels):
            out = run(args.trace_dir, args.iters, args.geometry, args.B, args.dropout, args.dtype,
                      args.grad_accum, args.device, args.depth, args.top)
    finally:
        kernels.ATTN_REMAT = saved
    print(out["report"])
    print(out["module_report"])
    return out


if __name__ == "__main__":
    main()
