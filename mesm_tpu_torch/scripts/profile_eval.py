"""Trace the port's eval step at the bench geometry and print where the
device's time goes: per kernel (utils/trace_report.report) and per module
(utils/trace_report.module_report).

    python -m mesm_tpu_torch.scripts.profile_eval [--trace-dir traces/eval]
        [--iters 4] [--geometry charades|tacos] [--kernels auto|on|off]
        [--dtype bfloat16|float32] [--B 128] [--shortkey-variant kernel]
        [--int8-ffn] [--dot-stats-ln] [--device cuda|cpu]

The port of scripts/profile_eval.py. charades is C+SF_C at full width and
depth on the deduplicated-video eval batch of the bench geometry (B = 128,
53 unique 194-clip videos, 2818 video and 512 text channels), bf16 by
default; tacos is the TACoS C3D_GloVe model on 600-clip videos (B = 16,
one video a row), fp32 by default. Weights and features come from a seed
(scripts/synthetic.py). One warm-up step, then `--iters` steps under
utils/profiling.maybe_trace with the model's module ranges; the trace is
written under --trace-dir.
"""
from __future__ import annotations

import argparse

import torch

from .. import kernels
from ..models.mesm import MESM
from ..parallel.step import make_eval_step
from ..utils.profiling import maybe_trace, step_annotation
from ..utils.trace_report import module_report, report
from . import synthetic


def build(geometry: str, B: int, dtype: torch.dtype, device):
    """(model in eval, eval step, batch) of a geometry, from seed 0."""
    torch.manual_seed(0)
    if geometry == "charades":
        model = MESM(synthetic.charades_config())
        batch = synthetic.make_eval_batch(0, B=B, NG=max(1, round(B * 53 / 128)), device=device)
    else:
        T = synthetic.TACOS
        model = MESM(synthetic.tacos_config())
        tb = synthetic.make_train_batch(0, B, T["Lv"], T["Dv"], T["Lw"], T["Dt"], 1112,
                                        device=device)
        batch = {"video_feat": tb["video_feat"], "video_mask": tb["video_mask"],
                 "cached_words_feat": tb["words_feat"], "cached_words_mask": tb["words_mask"],
                 "cached_sentence_feat": tb["sentence_feat"], "group_id": tb["group_id"],
                 **{k: tb[k] for k in ("ss_sent_idx", "ss_sent_mask", "ss_own_pos")}}
    model = model.to(device).eval()
    return model, make_eval_step(model, synthetic.encode_cached, dtype), batch


def run(trace_dir: str, iters: int = 4, geometry: str = "charades", B: int = None,
        dtype: str = None, device: str = "cuda", depth: int = 3, top: int = 30) -> dict:
    dtype = dtype or ("bfloat16" if geometry == "charades" else "float32")
    B = B or (128 if geometry == "charades" else synthetic.TACOS["B"])
    model, step, batch = build(geometry, B, getattr(torch, dtype), torch.device(device))
    step(batch)
    with maybe_trace(trace_dir, model=model):
        for i in range(iters):
            with step_annotation(f"eval_step_{i}"):
                step(batch)
    return {"report": report(trace_dir, top), "module_report": module_report(trace_dir, depth)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace-dir", default="traces/eval")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--geometry", default="charades", choices=["charades", "tacos"])
    ap.add_argument("--kernels", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="default bfloat16 for charades, float32 for tacos")
    ap.add_argument("--B", type=int, default=None, help="rows a batch (128 charades, 16 tacos)")
    ap.add_argument("--shortkey-variant", default=None, choices=["segmm", "kernel"])
    ap.add_argument("--int8-ffn", action="store_true")
    ap.add_argument("--dot-stats-ln", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but no CUDA device is available")
    saved = (kernels.SHORTKEY_VARIANT, kernels.INT8_FFN, kernels.DOT_STATS_LN)
    if args.shortkey_variant:
        kernels.SHORTKEY_VARIANT = args.shortkey_variant
    kernels.set_int8_ffn(args.int8_ffn)
    kernels.set_dot_stats_ln(args.dot_stats_ln)
    try:
        with kernels.pallas_scope(args.kernels):
            out = run(args.trace_dir, args.iters, args.geometry, args.B, args.dtype, args.device,
                      args.depth, args.top)
    finally:
        kernels.SHORTKEY_VARIANT = saved[0]
        kernels.set_int8_ffn(saved[1])
        kernels.set_dot_stats_ln(saved[2])
    print(out["report"])
    print(out["module_report"])
    return out


if __name__ == "__main__":
    main()
