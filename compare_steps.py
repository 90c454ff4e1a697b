#!/usr/bin/env python3
"""Device time per step of the port's main paths, for checkouts compared on
one GPU.

    python3 compare_steps.py [CHECKOUT ...]

Each checkout (a directory that holds chip_smoke.py and mesm_tpu_torch/;
default: the one this script sits in) is measured in a process of its own,
in the order given, so `python3 compare_steps.py parent . . parent` compares
two commits on one card in turns. In each it builds the kernels (all but the
stream layer's, which no step runs), then takes torch.profiler's device
time over 8 steps (chip_smoke.profile_step) of the charades C+SF_C bf16 eval
step at B = 128 in the dispatch modes "auto+kernel" and "auto", and of the
kernel-engaged TACoS fp32 train step (B = 16, attention dropout 0) in
"auto", all with that checkout's own model, batches and helpers. It prints
the card's name and power limit, then one JSON line a checkout. Needs a GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def brief(prof: dict) -> dict:
    keep = ("device_ms_per_step", "kernel_launches_per_step", "busy_share", "wall_ms_per_step")
    return {k: prof[k] for k in keep} | {
        "top": [[t["name"][:60], t["ms_per_step"], t["calls_per_step"]] for t in prof["top"][:8]]}


def measure(tree: str) -> dict:
    """The step profiles of one checkout, in this process."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from mesm_tpu_torch.kernels import build
    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise SystemExit(f"compare_steps: imported {cs.__file__}, not the checkout {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_steps: torch.cuda.is_available() is False; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all([n for n in build.KERNELS if n != "stream_layer"])
    out = {"checkout": tree}
    torch.manual_seed(0)
    model = MESM(cs._model_config()).cuda().eval()
    step = make_eval_step(model, cs._encode_batch, torch.bfloat16)
    batches = [cs.make_eval_batch(s) for s in range(2)]
    for mode in ("auto+kernel", "auto"):
        with cs.dispatch_mode(mode):
            out[f"charades_{mode}"] = brief(cs.profile_step(step, batches, iters=8))
    del model, step, batches
    cfg = cs._tacos_config(dropout=0.0)
    torch.manual_seed(0)
    model = MESM(cfg).cuda()
    batch = cs.make_train_batch(0, cs.TACOS["B"], cs.TACOS["Lv"], cs.TACOS["Dv"], cs.TACOS["Lw"],
                                cs.TACOS["Dt"], cfg.num_classes)
    ms, _, loss, prof = cs._train_ms_per_step(model, CriterionConfig(**cs.TACOS_CRITERION), batch,
                                              "auto", 4, count=False, profile=True)
    out["tacos_train"] = {"ms_per_step": ms, "loss": loss} | brief(prof)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_steps: torch.cuda.is_available() is False; this needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in sys.argv[1:] or [HERE]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        lines = [line for line in res.stdout.splitlines() if line.startswith("{")]
        if res.returncode != 0 or not lines:
            sys.stderr.write(res.stdout[-3000:] + res.stderr[-3000:])
            raise SystemExit(f"compare_steps: {tree} failed ({res.returncode})")
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
