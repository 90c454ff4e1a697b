#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (mesm_tpu_torch) on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the CUDA kernels from
mesm_tpu_torch/kernels/csrc with nvcc, holds each kernel against its plain
torch version at the main paths' shapes (the fp32 short-key kernels at
the TACoS, charades and QVHighlights sites; the encoder attention kernels
also at the edges of their tiles, the fused LayerNorm -> Dense at the edges
of its tiles and its domain: any N, D and F; the fp32 attention body at 16
and 32 x 601 x 601 and head_dim 16, 32, 128 and 256, timed beside the
register tiles it replaced and SDPA), holds every attention kernel at
head_dim 16, 24 (padded), 64, 128, 192 (padded), 256 and 512 in both
dtypes (the backward against autograd too) and runs the charades bf16 eval
step and the TACoS fp32 train step at --nheads 16 (head_dim 16) and
--nheads 1 (head_dim 256, the wide bodies) on the kernels, drives
charades C+SF_C bf16
inference through the port's eval step and through its
`python -m mesm_tpu_torch.evaluate` entry point (the eval step also in the
"on" mode and with the one-matmul short-key kernel), the TACoS fp32 eval
step (also with the fp32 one-matmul short-key kernel), QVHighlights C+SF_C bf16 inference in every dispatch mode, the
charades model with 64-80-word queries (the pair-masked kernel), the
kernel-engaged TACoS fp32 train step (attention dropout 0: the trainable
attention's forward and backward kernels) with the kernels on and off,
the same TACoS step with --grad_accum 2 and in bf16, the trainer's TACoS
eval step with its loss, the charades C+SF_C fp32 train step as shipped,
the CLIP text tower at the ViT-B/32 text widths (fabricated weights) and
both entry points on a synthetic CLIP charades root, evaluate on a
mesm_tpu.v1 checkpoint, `python -m mesm_tpu_torch.train` on a synthetic
root whose checkpoint the evaluate entry point then scores (its eval loss
logged, tensorboard's import blocked), the QVHighlights fp32 train step and
both entry points on a synthetic QVHighlights root, the charades bf16 and
TACoS fp32 eval steps (and the evaluate entry point) with the fused int8
FFN switched on, the eval steps, one train step and the evaluate entry
point under each MESM_ATTN_VARIANT layout, and the fused stream-layer
kernel through the port of the layer-kernel bench entry point and on the
real charades model's layers (with the layout anchor on its encoder
memory), and checks that each path went through its kernels. Then the JAX
package's last modules: the charades bf16 eval step with the dot-stats
LayerNorm on and off (every site in range named), the charades fp32 train
step with the attention core rematerialised and not (equal losses and
gradients, peak memory) and the TACoS kernel step untouched by it, four
eval steps traced by utils/profiling.maybe_trace and read back by
utils/trace_report (kernels 1 and 2 counted and put in their modules), the
native host module built and held against the numpy paths on the evaluate
entry point's predictions, ops/quant.int8_dense on torch._int_mm against
its plain version, and `torchrun --nproc_per_node 1 -m
mesm_tpu_torch.train` on NCCL against the single-process entry point (its
first step bounded too). Then the sequence-sharded TACoS train step:
kernels 6 and 9's backward at the shard shapes (the local queries of 2 and
4 model ranks against the 601 gathered keys), and with two cards or more
`torchrun` of it on NCCL (1 data x 2 seq ranks) against one process; with
one card the phase's line says that this half did not run. Last, the
dispatch-coalesced eval (phase `coalesce`): the K = 8 superbatch CUDA graph
at the bench geometry against 8 eager per-batch calls (kernel 1 at the
hoisted shape is held in `kernels`), the evaluate entry point at the
Charades-STA test size with
--eval_coalesce 1 and with the default, and the trainer's coalesced eval
across two epochs; the earlier phases that drive an entry point pass
--eval_coalesce 1 (PER_BATCH). Each phase prints one JSON line; the line
before the last is the kernel summary, the last line names the device:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Any failure raises and the script exits non-zero without that line; so does
a host with no GPU. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over the
# peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32": 494.7e12}

# kernel-vs-plain tolerances, each in units of max(1, |plain|):
#   ln_dense bf16: 2**-6, two bf16 steps at 1.0 (the output is rounded to bf16,
#     and a sum of 2818 products taken in another order can move it one step);
#   ln_dense fp32: 1e-4 (2818-term f32 sums in another order);
#   attention bf16: 3e-2 abs (bf16 logits, exp and divide; one-step flips).
#   attention fp32: 1e-5 (f32 sums of 601 terms in another order);
#   trainable fp32 gradients: 1e-5 (the backward kernel's f32 sums in
#     another order than attention_core's autograd);
#   the fp32 backward kernel against its plain version: 1e-5 (the same).
#   pair-masked and short-key attention bf16: 3e-2 abs (f32 softmax, but the
#     probabilities and the output are rounded to bf16: one-step flips);
#   the one-matmul short-key kernel in fp32: 1e-5 (f32 sums in another order).
#   ffn_int8: 2**-7, one bf16 step at 2.0: the integer sums are exact and the
#     kernel rounds where the plain version rounds, so they agree bit for bit
#     unless one rounding of h lands otherwise and moves an hq by one;
#   the per-head, all-heads and bf16 batched kernels: 1e-5 in fp32 (f32 sums
#     in another order), 3e-2 abs in bf16 (p and out rounded to bf16);
#   the packed, pair and short-key kernels in fp32: 1e-5 (every rounding is
#     to f32; sums of up to 601 terms in another order);
#   the fused stream layer: fp32 1e-4 (1024-term sums in another order,
#     through two LayerNorms); bf16 0.05 (one flipped bf16 step in the FFN
#     hidden propagates through LN2);
#   layout_anchor: 0, a copy (bit-equal).
TOL = {"ln_dense_bfloat16": 2.0**-6, "ln_dense_float32": 1e-4,
       "attention_packed_bfloat16": 3e-2, "attention_batched_float32": 1e-5,
       "attention_trainable": 1e-5, "attention_backward": 1e-5,
       "attention_packed_pair_bfloat16": 3e-2,
       "attention_shortkey_bfloat16": 3e-2, "attention_shortkey_onematmul_bfloat16": 3e-2,
       "attention_shortkey_onematmul_float32": 1e-5, "ffn_int8": 2.0**-7,
       "attention_per_head_float32": 1e-5, "attention_per_head_bfloat16": 3e-2,
       "attention_all_heads_float32": 1e-5, "attention_all_heads_bfloat16": 3e-2,
       "attention_batched_bfloat16": 3e-2, "attention_packed_float32": 1e-5,
       "attention_packed_pair_float32": 1e-5, "attention_shortkey_float32": 1e-5,
       "stream_layer_float32": 1e-4, "stream_layer_bfloat16": 0.05, "layout_anchor": 0.0}
# the model's bf16 predictions with the kernels against (a) kernels off in
# bf16 and (b) the fp32 plain path, in units of max(1, max |reference|) per
# output: the packed kernel's bf16 softmax and the fused LayerNorm -> Dense
# round at other points than the plain path, and bf16 keeps 8 mantissa bits.
# Also the fused stream layer against the model's own bf16 layers, in units
# of max(1, |reference|) per element: the modules' bf16 logits, softmax and
# two-pass LayerNorm round at other points than the kernel
MODEL_TOL = 0.05

MAIN_PATH = dict(N=10282, D=2818, F=256, B=128, L=195, E=256, H=8)
# QVHighlights C+SF_C (config/QVHighlights/C+SF_C.json): eval batches of 30
# rows, each row its own clip of up to 75 clips (150 s at 2 s) of 2818-wide
# CLIP + SlowFast + TEF features, 32 words of cached 512-d text; the rows of
# one YouTube video form a group (at most 4 here), whose concatenated clips
# (4 x 75 = 300) are each row's SS-MESM video; the train batch is 12 rows
QVH = dict(B=30, NG=20, G=4, Lv=75, Dv=2818, Lw=32, Dt=512, T=5, train_B=12)
# the short-key attention sites (video queries x text keys, with the
# scrambled pair mask and without), and the long-key pair site that queries
# of 64-80 words give the charades model (80 words + the recon token)
SHORT_KEY_SITES = (("charades", 128, 194, 17, True), ("qvh", 30, 75, 33, True),
                   ("qvh", 30, 75, 33, False))
LONG_KEY_SITE = ("charades_long_query", 128, 194, 81, True)
# the fp32 short-key sites: TACoS (the shipped fp32 config, bench.py:753-754:
# 16 x 600 video queries x 16 words + 1), charades at the bench batch in the
# dtype config/charades/C+SF_C.json ships (128 x 194 x 17) and QVHighlights
# (30 x 75 x 33)
FP32_SHORT_KEY_SITES = (("tacos", 16, 600, 17), ("charades", 128, 194, 17), ("qvh", 30, 75, 33))
# kernel launches per eval batch in each dispatch mode. "auto" keeps the
# measured TPU gates; "on" takes every site a kernel accepts: the 4 T2V /
# enhance cross-attention sites (keys < 64: the packed short-key kernel; 64
# or more with the pair mask: the pair kernel), the DETR encoder's 2
# self-attentions (the packed kernel) and every LayerNorm -> Dense block (8
# in charades: video, text and the SS group sentences, 2 blocks each, and
# the saliency head's; 10 in QVHighlights, whose SS video has its own
# projection); "auto+kernel" sends the 4 short-key sites to the one-matmul
# kernel. The input projection of the raw 2818-wide video is the only
# LayerNorm -> Dense site wide enough for "auto" (once per batch in
# charades, twice in QVHighlights: each row's clip and the group video).
CHARADES_LAUNCHES = {
    "auto": {"ln_dense": 1, "attention_packed": 2},
    "auto+kernel": {"ln_dense": 1, "attention_packed": 2, "attention_shortkey_onematmul": 4},
    "on": {"ln_dense": 8, "attention_packed": 2, "attention_shortkey": 4},
}
QVH_LAUNCHES = {
    "off": {},
    "auto": {"ln_dense": 2},
    "auto+kernel": {"ln_dense": 2, "attention_shortkey_onematmul": 4},
    "on": {"ln_dense": 10, "attention_packed": 2, "attention_shortkey": 4},
}
LONG_QUERY_LAUNCHES = {"on": {"ln_dense": 8, "attention_packed": 2, "attention_packed_pair": 4}}
# kernel launches per eval batch with kernels.set_int8_ffn(True) in "auto":
# the 6 FFNs of >= 4096 rows (2 enhance, 2 T2V and 2 DETR encoder layers)
# take ffn_int8, the decoder's (B x 10 rows) and SS-recon's stay plain
INT8_LAUNCHES = {"charades": dict(CHARADES_LAUNCHES["auto"], ffn_int8=6),
                 "tacos": {"ln_dense": 1, "attention_batched": 2, "ffn_int8": 6}}
# the kernel the DETR encoder's 2 self-attentions launch per eval batch in
# "auto" under each MESM_ATTN_VARIANT, in bf16 (charades) and in fp32 (TACoS)
VARIANT_KERNEL = {"per_head": "attention_per_head", "all_heads": "attention_all_heads",
                  "batched": "attention_batched", "packed": "attention_packed"}
# "on" with MESM_ATTN_VARIANT=packed sends fp32 to the packed family: TACoS's
# 4 T2V / enhance sites (600 queries x 16 keys) to the short-key kernel, and
# with 64-80-word queries the charades sites to the pair kernel
# TACoS fp32 eval: "auto" sends the DETR encoder's 2 self-attentions (601
# keys) to the batched kernel and the raw 4098-wide video projection to
# ln_dense; "auto+kernel" also its 4 short-key sites to the fp32 one-matmul
# kernel
TACOS_LAUNCHES = {"auto": {"ln_dense": 1, "attention_batched": 2},
                  "auto+kernel": {"ln_dense": 1, "attention_batched": 2,
                                  "attention_shortkey_onematmul": 4}}
PACKED_FP32_ON_LAUNCHES = {"tacos": {"ln_dense": 8, "attention_packed": 2, "attention_shortkey": 4},
                           "long_query": LONG_QUERY_LAUNCHES["on"]}
# TACoS (bench.py:753-754, 780-795): 16 rows, 600 clips (601 with the global
# token) of 4098-wide C3D + TEF features, 16 words of 300-d GloVe; the train
# step stacks the negative pass, so its DETR encoder sees 32 rows
TACOS = dict(B=16, Lv=600, Dv=4098, Lw=16, Dt=300, L=601, E=256, H=8)
# the fused stream layer's path (mesm_tpu_torch/scripts/bench_layer_kernel.py
# at the charades widths): 128 samples, the encoder at 195 rows (the global
# token included), T2V at 194 video rows against 17 text keys; N chained
# layers per timed chain, `iters` timed chains after one warm-up chain
STREAM = dict(B=128, L=195, Lv=194, N=32, iters=5)
# the phases that drive an entry point ask for the per-batch eval
# (--eval_coalesce 1): their launch counters count every launch, which a
# CUDA graph replay does not move; phase `coalesce` drives the default
PER_BATCH = ["--eval_coalesce", "1"]
# kernels on vs off in fp32, in units of max(1, max |off|) per output
FP32_MODEL_TOL = 1e-4
# the train step's first loss, kernels "auto" vs "off": relative; its
# gradients in units of max(1, max |g|) over all parameters. Per parameter
# that scale sits below the step's own fp32 noise: a 1e-7 relative change of
# the input features moves the input projection's gradients by ~6e-4 of
# their own scale on an H100, so the phase reports that floor too.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# a grad_accum = 2 update against the update on the mean microbatch gradient
# (parameters, abs); a bf16 train step's first loss against fp32's (relative,
# tests/test_bf16_train.py:85)
GRAD_ACCUM_TOL, BF16_TRAIN_TOL = 1e-5, 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the kernel of torch.cuda._sleep, left out of every profiler sum
SPIN = "spin_kernel"


def open_window() -> None:
    """Opens a torch.profiler window: a spin kernel takes the window's first
    record (the tracer drops the first kernel of a window in some
    processes), the card drains, and the host waits out the lag of the
    card's clock behind its own (utils/profiling.DEVICE_CLOCK_GUARD_S; a
    kernel dated before the window began is dropped too)."""
    import torch

    from mesm_tpu_torch.utils.profiling import DEVICE_CLOCK_GUARD_S

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(DEVICE_CLOCK_GUARD_S)


def device_kernel_ms(fn, key: str, iters: int = 20):
    """Device time per call of the kernels whose name holds `key`, from
    torch.profiler over `iters` calls after a warm-up: the kernel alone,
    without the host's time between launches (which the CUDA events of
    cuda_time_ms include where a call is shorter than its host overhead),
    in a window opened by open_window. None when the profiler sees no such
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_window()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key and SPIN not in e.key)
    return us / iters / 1e3 if us else None


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def ptxas_by_function(log: str) -> dict:
    """Registers and spill bytes of each compiled kernel instance, from
    nvcc's -Xptxas -v log, by demangled name (mangled where c++filt is
    missing); `wgmma_serialized` names the ptxas notes (C75xx) that say an
    instance's wgmma instructions run one at a time."""
    import re
    import shutil

    found, current = {}, None
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\)[^']*serialized[^']*function '([^']+)'", line)
        if m:
            notes = found.setdefault(m.group(2), {}).setdefault("wgmma_serialized", [])
            notes.append(m.group(1))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            found.setdefault(current, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            found[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            found[current]["registers"] = int(m.group(1))
    if found and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(found), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        short = []
        for name in names:
            m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
            short.append(m.group(1) if m else name)
        found = dict(zip(short, found.values()))
    return found


def phase_build() -> dict:
    from mesm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    out = {
        "phase": "build", "seconds": time.perf_counter() - t0,
        "kernels": {
            name: {"seconds": r["seconds"], "compiled": r["compiled"],
                   "ptxas": ptxas_by_function(r["log"])}
            for name, r in report.items()
        },
    }
    emit(out)
    return out


def _rel_err(got, want) -> float:
    import torch

    g, w = got.float(), want.float()
    return float(((g - w).abs() / torch.clamp(w.abs(), min=1.0)).max())


def _ln_inputs(dtype_name: str, N: int, D: int, F: int, seed: int = 0):
    """x (N, D) in the dtype, f32 gamma, beta, the (F, D) weight and bias,
    from a seed, at the scales of the model's input projection."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(N, D, generator=g, device="cuda") * 2 + 0.3).to(dt)
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
    beta = 0.1 * torch.randn(D, generator=g, device="cuda")
    w = torch.randn(F, D, generator=g, device="cuda") / D**0.5
    b = 0.1 * torch.randn(F, generator=g, device="cuda")
    return x, gamma, beta, w, b


def _offset_view(t, offset: int):
    """t's values in a view `offset` elements into a larger buffer of NaNs."""
    import torch

    buf = torch.full((t.numel() + 2 * offset,), float("nan"), dtype=t.dtype, device=t.device)
    buf[offset:offset + t.numel()] = t.flatten()
    return buf[offset:offset + t.numel()].view(t.shape)


def check_ln_dense(dtype_name: str, relu: bool, time_it: bool, N: int = MAIN_PATH["N"],
                   D: int = MAIN_PATH["D"], summary=None, F: int = MAIN_PATH["F"],
                   offset: int = 0) -> dict:
    """ln_dense against its plain version (TOL, in units of max(1, |plain|))
    on its two device kernels, with x, gamma and beta `offset` elements into
    larger buffers of NaNs where offset > 0; timed: CUDA events (ms), the kernels alone
    from the profiler (kernel_ms, the statistics pass and the product), the
    plain version and the library pair F.linear(F.layer_norm(x)) (+ ReLU) in
    the input dtype (TF32 off), the bound by bytes and by operations (fp32:
    also the 3xTF32 bound, three TF32 products)."""
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.ops import ln_dense as ld

    x, gamma, beta, w, b = _ln_inputs(dtype_name, N, D, F)
    if offset:
        x, gamma, beta = (_offset_view(t, offset) for t in (x, gamma, beta))
    got, names = launched_kernels(lambda: ld.ln_dense(x, gamma, beta, w, b, relu))
    want = ld.ln_dense_reference(x, gamma, beta, w, b, relu)
    torch.cuda.synchronize()
    err = _rel_err(got, want)
    tol = TOL[f"ln_dense_{dtype_name}"]
    res = {
        "kernel": "ln_dense", "dtype": dtype_name, "relu": relu, "shape": [N, D, F],
        "offset": offset, "summary_name": summary, "launched": names,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "max_err_rel_to_max1": err, "tol": tol, "finite": bool(torch.isfinite(got).all()),
    }
    kernels_ok = all(any(k in n for n in names) for k in LN_DENSE_KERNELS)
    if not (err <= tol and res["finite"] and kernels_ok):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"ln_dense {dtype_name} {N}x{D}->{F} relu={relu}: {res}")
    if time_it:
        item = x.element_size()
        run = lambda: ld.ln_dense(x, gamma, beta, w, b, relu)  # noqa: E731
        res["ms"] = cuda_time_ms(run)
        res["kernel_ms"] = device_kernel_ms(run, "ln_")
        # the two launches apart: the statistics pass and the product
        res["stats_kernel_ms"] = device_kernel_ms(run, LN_DENSE_KERNELS[0])
        res["product_kernel_ms"] = device_kernel_ms(run, LN_DENSE_KERNELS[1])
        res["plain_ms"] = cuda_time_ms(lambda: ld.ln_dense_reference(x, gamma, beta, w, b, relu))
        dt = x.dtype
        g2, b2, w2, bb2 = gamma.to(dt), beta.to(dt), w.to(dt), b.to(dt)

        def pair():
            y = Fn.linear(Fn.layer_norm(x, (D,), g2, b2, ld.LN_EPS), w2, bb2)
            return torch.relu_(y) if relu else y

        res["library_ms"] = cuda_time_ms(pair)
        res["library_kernel_ms"] = device_kernel_ms(pair, "")
        moved = N * D * item + 2 * D * 4 + F * D * item + F * 4 + N * F * item
        flops = 2.0 * N * D * F
        res["bound_ms"], res["bound_by"] = bound(moved, flops, dtype_name)
        if dtype_name == "float32":
            res["bound_3xtf32_ms"], res["bound_3xtf32_by"] = bound(moved, 3 * flops, "tf32")
    return res


# the device kernels of one ln_dense call: the statistics pass, the product
LN_DENSE_KERNELS = ("ln_stats_kernel", "ln_dense_wgmma_kernel")
# ln_dense at the edges of its tiles and domain, (dtype, N, D, F, relu):
# ragged row tiles (1, 63, 129 rows and one past the charades shape), F
# not a multiple of 16 (40) and above one 256-column tile (512, 300), D of
# one K tile's multiple (256), wide (8192) and odd (2817: element loads)
LN_DENSE_EDGES = tuple(
    (dt, N, D, F, relu)
    for dt in ("bfloat16", "float32")
    for N, D, F in ((1, 2818, 256), (63, 2818, 256), (129, 4098, 256), (10283, 2818, 256),
                    (200, 256, 40), (200, 2818, 512), (130, 8192, 300), (77, 2817, 256),
                    (64, 256, 256))
    for relu in (True, False))


def check_ln_dense_edges() -> list:
    """ln_dense at LN_DENSE_EDGES against its plain version (TOL), untimed;
    then with x, gamma and beta off 16-byte boundaries (one element into
    their buffers) at an odd D."""
    out = []
    for dtype_name, N, D, F, relu in LN_DENSE_EDGES:
        out.append(check_ln_dense(dtype_name, relu, False, N=N, D=D, F=F))
    for dtype_name in ("bfloat16", "float32"):
        out.append(check_ln_dense(dtype_name, True, False, N=77, D=2817, F=256, offset=1))
    return out


def check_ln_dense_alignment() -> dict:
    """ln_dense's rows are the same bits at any address: N rows at each
    element offset of a 16-byte span into a larger buffer (a charades row,
    2818 bf16 = 5,636 bytes, starts on any 4-byte boundary; the coalesced
    eval step projects K batches' rows in one call, where the per-batch
    step projects each batch's rows at the start of its own buffer),
    against the rows at offset 0, both dtypes, an even and an odd D. The
    largest difference must be 0."""
    import torch

    from mesm_tpu_torch.ops import ln_dense as ld

    out = {"kernel": "ln_dense", "check": "alignment", "cases": []}
    for dtype_name in ("bfloat16", "float32"):
        for D in (MAIN_PATH["D"], MAIN_PATH["D"] - 1):
            x, gamma, beta, w, b = _ln_inputs(dtype_name, 77, D, MAIN_PATH["F"], seed=3)
            base = ld.ln_dense(x, gamma, beta, w, b, True)
            per = 16 // x.element_size()
            diff = max(float((ld.ln_dense(_offset_view(x, o), gamma, beta, w, b, True).float()
                              - base.float()).abs().max()) for o in range(1, per))
            out["cases"].append({"dtype": dtype_name, "D": D, "offsets": per - 1,
                                 "max_abs_diff": diff})
    torch.cuda.synchronize()
    out["ok"] = all(c["max_abs_diff"] == 0.0 for c in out["cases"])
    if not out["ok"]:
        emit(dict(out, phase="kernels"))
        raise SystemExit(f"ln_dense rows change with their address: {out}")
    return out


def _encoder_qkv(B: int, L: int, dtype_name: str, seed: int):
    """q, k, v at a DETR encoder shape (L with the global token) in a dtype,
    and a key mask: varied lengths, the global token never a key, sample 3
    with every key masked."""
    import torch

    E = MAIN_PATH["E"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype_name)
    q, k, v = (torch.randn(B, L, E, generator=g, device="cuda").to(dt) for _ in range(3))
    lengths = torch.randint(L // 10, L + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(L, device="cuda")[None] < lengths[:, None]
    mask[:, 0] = False
    mask[3] = False
    return q, k, v, mask


# the device kernel each (B, L, E) encoder attention wrapper launches, by
# dtype (a name no other kernel's name contains): bf16 on the mma tiles,
# float32 on the 3xTF32 body; bf16 batched past the mma staging
# (BATCHED_REGTILE_SHAPES) launches its register-tile kernel
ENCODER_KERNEL_NAMES = {
    "attention_per_head": {"bfloat16": "attention_heads_kernel_bf16",
                           "float32": "attention_heads_3xtf32_kernel"},
    "attention_all_heads": {"bfloat16": "attention_heads_kernel_bf16",
                            "float32": "attention_heads_3xtf32_kernel"},
    "attention_batched": {"bfloat16": "attention_batched_mma_kernel",
                          "float32": "attention_batched_3xtf32_kernel"},
    "attention_packed": {"bfloat16": "attention_packed_mma_kernel",
                         "float32": "attention_packed_3xtf32_kernel"},
}
BATCHED_REGTILE_KERNEL = "attention_batched_regtile_kernel"


def attention_bound(B: int, H: int, Lq: int, Lk: int, hd: int, moved: float, dtype_name: str,
                    products: int = 2):
    """(bound_ms, bound_by, bound_fp32_ms) of `products` attention products
    of B * H * Lq * Lk * hd multiply-adds each: bf16 at its tensor-core
    rate; float32 as the kernels take it, three TF32 products each (3xTF32),
    with the fp32 figure without the tensor cores beside (a 3xTF32 kernel
    may beat it, so it bounds nothing)."""
    flops = products * 2.0 * B * H * Lq * Lk * hd
    if dtype_name != "float32":
        return bound(moved, flops, dtype_name) + (None,)
    return bound(moved, 3 * flops, "tf32") + (bound(moved, flops, "float32")[0],)


def _encoder_kernels():
    """(wrapper, plain version) of each (B, L, E) self-attention kernel an
    encoder site reaches under MESM_ATTN_VARIANT."""
    from mesm_tpu_torch.ops import attention_batched as ab
    from mesm_tpu_torch.ops import attention_heads as ah
    from mesm_tpu_torch.ops import attention_packed as ap

    return {
        "attention_per_head": (ah.attention_per_head, ab.attention_batched_reference),
        "attention_all_heads": (ah.attention_all_heads, ab.attention_batched_reference),
        "attention_batched": (ab.attention_batched, ab.attention_batched_reference),
        "attention_packed": (ap.attention_packed, ap.attention_packed_reference),
    }


def check_encoder_attention(name: str, dtype_name: str, B: int, L: int, summary=None,
                            heads: int = MAIN_PATH["H"]) -> dict:
    """An encoder self-attention kernel of a MESM_ATTN_VARIANT layout (or a
    new dtype instance) against its plain version, then its time (CUDA
    events, and the kernel alone from the profiler), its plain version's and
    SDPA's. `summary` names its entry in the kernel summary (None: none)."""
    import torch
    import torch.nn.functional as Fn

    fn, ref = _encoder_kernels()[name]
    key = ENCODER_KERNEL_NAMES[name][dtype_name]
    E, H = MAIN_PATH["E"], heads
    hd = E // H
    q, k, v, mask = _encoder_qkv(B, L, dtype_name, seed=7)
    got = fn(q, k, v, H, mask)
    want = ref(q, k, v, H, mask)
    torch.cuda.synchronize()
    tol = TOL[f"{name}_{dtype_name}"]
    err = _rel_err(got, want)
    res = {
        "kernel": name, "dtype": dtype_name, "shape": [B, L, E, H], "summary_name": summary,
        "max_abs_err": float((got.float() - want.float()).abs().max()), "max_err_rel_to_max1": err,
        "tol": tol, "finite": bool(torch.isfinite(got).all()),
        "masked_row_vs_mean_v": float((got[3].float() - v[3].float().mean(0)).abs().max()),
    }
    if not (err <= tol and res["finite"] and res["masked_row_vs_mean_v"] <= tol):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"{name} {dtype_name} B={B}: {res}")
    res["ms"] = cuda_time_ms(lambda: fn(q, k, v, H, mask))
    res["kernel_ms"] = device_kernel_ms(lambda: fn(q, k, v, H, mask), key)
    res["plain_ms"] = cuda_time_ms(lambda: ref(q, k, v, H, mask))
    qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
    am = _sdpa_mask(mask)
    res["library_ms"] = cuda_time_ms(
        lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
    )
    moved = 4 * B * L * E * q.element_size() + B * L
    res["bound_ms"], res["bound_by"], res["bound_fp32_ms"] = attention_bound(B, H, L, L, hd, moved,
                                                                             dtype_name)
    return res


# the fp32 body's timing grid (32 stacked TACoS train rows, 16 eval rows,
# L = 601, E = 256, head_dim hd with 256 / hd heads), and each shape's
# kernel time on the register tiles it replaced (PERF.md section 6, rows 6
# and 7: 0.594 / 0.301 ms at hd 32, 0.793 / 0.740 ms at hd 16 / 128 at 32
# rows, H100 80GB HBM3 at 700 W); None where they were not timed
FP32_BODY_GRID = tuple((B, hd) for B in (32, 16) for hd in (16, 32, 128, 256))
REGTILE_MS = {(32, 32): 0.594, (16, 32): 0.301, (32, 16): 0.793, (32, 128): 0.740}


def check_fp32_body() -> list:
    """The float32 body of kernels 2, 6, 7 and 8 (3xTF32 on the tensor
    cores) through the batched wrapper at FP32_BODY_GRID, as
    check_encoder_attention holds and times it, with the time of the
    register tiles it replaced beside."""
    out = []
    for B, hd in FP32_BODY_GRID:
        res = check_encoder_attention("attention_batched", "float32", B, TACOS["L"],
                                      heads=TACOS["E"] // hd)
        res.update(body="3xtf32", head_dim=hd, regtile_ms=REGTILE_MS.get((B, hd)))
        out.append(res)
    return out


# the shapes at the edges of the (B, L, E) encoder kernels' tiles, (B, Lq,
# Lk, E) with H = 8: query counts that are not a multiple of the 16-row mma
# tile (1, 70), key counts that are not a multiple of 16 (17, 81) and above
# the 256 keys whose bf16 logits stay in registers (601), head_dim 64 (E =
# 512) and a single sample
HEADS_EDGE_SHAPES = ((1, 1, 17, 256), (2, 70, 81, 256), (2, 70, 601, 256), (3, 195, 195, 512),
                     (1, 70, 601, 512), (2, 1, 601, 256))
# bf16 shapes whose K_h and V_h do not fit a block's shared memory on the
# mma tiles (more than 1,760 keys at head_dim 32, 864 at 64): the batched
# kernel takes them on its register tiles
BATCHED_REGTILE_SHAPES = ((2, 70, 1800, 256), (2, 70, 900, 512))


def launched_kernels(fn, tries: int = 6):
    """fn() under torch.profiler: its result and the names of the device
    kernels it launched. Short spin kernels open and close the window, and
    are left out of the names: the tracer can miss the first kernel of a
    window. It can also return a window with no kernel at all, several in a
    row: then fn() is traced again after a pause, up to `tries` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        names = sorted(n for n in names if SPIN not in n)
        if names:
            break
    return out, names


def _edge_cases():
    """(kernel, dtype, (B, Lq, Lk, E), expected device kernel name): every
    encoder kernel in both dtypes at HEADS_EDGE_SHAPES, bf16 batched also at
    BATCHED_REGTILE_SHAPES."""
    cases = [(name, dtype_name, shape, ENCODER_KERNEL_NAMES[name][dtype_name])
             for name in ENCODER_KERNEL_NAMES for dtype_name in ("bfloat16", "float32")
             for shape in HEADS_EDGE_SHAPES]
    return cases + [("attention_batched", "bfloat16", shape, BATCHED_REGTILE_KERNEL)
                    for shape in BATCHED_REGTILE_SHAPES]


def check_encoder_edges() -> dict:
    """Every (B, L, E) encoder attention kernel at the edges of its tiles
    (_edge_cases) against its own plain version, within TOL; where B > 1,
    sample 1 has every key masked and must give the mean of v over all Lk
    keys. Each call must launch the device kernel its case names (for bf16
    batched: the mma body or, past its staging, the register tiles), seen
    by the profiler. Then the bf16 pair kernel, the fp32 backward, the bf16
    short-key kernels and the int8 FFN at their own edges (_pair_edge_cases,
    _backward_edge_cases, _shortkey_edge_cases, _ffn_edge_cases). Untimed."""
    import torch

    H, cases, ok = MAIN_PATH["H"], [], True
    kernels = _encoder_kernels()
    for name, dtype_name, (B, Lq, Lk, E), kernel_name in _edge_cases():
        fn, ref = kernels[name]
        dt = getattr(torch, dtype_name)
        tol = TOL[f"{name}_{dtype_name}"]
        g = torch.Generator(device="cuda").manual_seed(B * 1000 + Lq + Lk + E)
        q = torch.randn(B, Lq, E, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").to(dt) for _ in range(2))
        lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
        mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
        if B > 1:
            mask[1] = False
        got, names = launched_kernels(lambda: fn(q, k, v, H, mask))
        want = ref(q, k, v, H, mask)
        torch.cuda.synchronize()
        case = {"kernel": name, "dtype": dtype_name, "shape": [B, Lq, Lk, E, H],
                "device_kernel": kernel_name, "launched": names,
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "max_err_rel_to_max1": _rel_err(got, want),
                "finite": bool(torch.isfinite(got).all()), "tol": tol}
        if B > 1:
            case["masked_row_vs_mean_v"] = float(
                (got[1].float() - v[1].float().mean(0)).abs().max())
        case["ok"] = bool(case["finite"] and case["max_err_rel_to_max1"] <= tol
                          and case.get("masked_row_vs_mean_v", 0.0) <= tol
                          and any(kernel_name in n for n in names))
        ok = ok and case["ok"]
        cases.append(case)
    for case in (_pair_edge_cases() + _backward_edge_cases() + _shortkey_edge_cases()
                 + _ffn_edge_cases()):
        ok = ok and case["ok"]
        cases.append(case)
    res = {"phase": "attention_edges", "ok": ok, "cases": cases}
    emit(res)
    if not ok:
        raise SystemExit("attention edge shapes: a check failed")
    return res


def _pair_edge_cases() -> list:
    """The bf16 pair kernel at HEADS_EDGE_SHAPES against its plain version
    (3e-2), on the mma body (by its device kernel name and its route's
    count): random pair factors, sample 0 with every key of head 0 flagged
    and every other query of that head flagged (rows whose every key is
    dropped), sample 1 (where B > 1) with every key masked; each dropped row
    must give the mean of v over all Lk keys."""
    import torch

    from mesm_tpu_torch.ops import attention_packed as ap

    H, tol, out = MAIN_PATH["H"], TOL["attention_packed_pair_bfloat16"], []
    kernel_name = PAIR_KERNEL_NAMES[("attention_packed_pair", "bfloat16")]
    for B, Lq, Lk, E in HEADS_EDGE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * 1000 + Lq + Lk + E + 1)
        q = torch.randn(B, Lq, E, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").bfloat16() for _ in range(2))
        lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
        mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
        if B > 1:
            mask[1] = False
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[0, 0] = True
        qf[0, 0, ::2] = True
        pf = (qf, kf)
        got, names = launched_kernels(lambda: ap.attention_packed_pair(q, k, v, H, mask, pf))
        want = ap.attention_packed_pair_reference(q, k, v, H, mask, pf)
        torch.cuda.synchronize()
        dead_err, dead_rows = _dead_rows_vs_mean_v(got, v, mask, pf, H)
        case = {"kernel": "attention_packed_pair", "dtype": "bfloat16", "shape": [B, Lq, Lk, E, H],
                "device_kernel": kernel_name, "launched": names,
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "max_err_rel_to_max1": _rel_err(got, want), "finite": bool(torch.isfinite(got).all()),
                "masked_rows": dead_rows, "masked_rows_vs_mean_v": dead_err, "tol": tol}
        case["ok"] = bool(case["finite"] and case["max_err_rel_to_max1"] <= tol and dead_rows > 0
                          and dead_err <= tol and any(kernel_name in n for n in names))
        out.append(case)
    return out


# the bf16 short-key kernels' edges: query rows around their 64-row tiles
# and key counts around their 16-key steps (padded to 16, 16, 32, 48, 64);
# the one-matmul kernel also at head_dim 64 (E = 512) on a subset
SHORTKEY_EDGE_LQ = (1, 15, 16, 63, 64, 65, 194)
SHORTKEY_EDGE_LK = (1, 16, 17, 33, 63)
ONEMATMUL_EDGE_HD64 = ((1, 17), (65, 63), (194, 33))
# the fp32 short-key kernels' edges: query rows around their 64-row tiles;
# keys around the short-key kernel's tiles of 24, 32 and 40 keys and the
# one-matmul kernel's n8 tiles and key groups of 64
FP32_SHORTKEY_EDGE_LQ = (1, 63, 64, 65)
FP32_SHORTKEY_EDGE_LK = (1, 16, 17, 24, 25, 32, 33, 40, 41, 64, 65)


def _shortkey_edge_inputs(B: int, Lq: int, Lk: int, E: int, pair: bool, seed: int,
                          dtype_name: str = "bfloat16"):
    """q, k, v in the dtype, a key mask with sample 1 fully masked and, with
    pair factors, sample 0 with every key of head 0 flagged and every other
    query of that head flagged (rows whose every key is dropped)."""
    import torch

    H = MAIN_PATH["H"]
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").to(dt) for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    mask[1] = False
    pf = None
    if pair:
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[0, 0] = True
        qf[0, 0, ::2] = True
        pf = (qf, kf)
    return q, k, v, mask, pf


def _shortkey_edge_case(name: str, q, k, v, mask, pf):
    """One short-key kernel call against its plain version (TOL: bf16 3e-2,
    fp32 1e-5), on its tensor-core device kernel (by name); each row whose
    every key is dropped must give the mean of v over all Lk keys. Returns
    the case and the kernel's output."""
    import torch

    H = MAIN_PATH["H"]
    dtype_name = str(q.dtype).replace("torch.", "")
    fn, ref = _pair_kernels()[name]
    tol, kernel_name = TOL[f"{name}_{dtype_name}"], PAIR_KERNEL_NAMES[(name, dtype_name)]
    got, names = launched_kernels(lambda: fn(q, k, v, H, mask, pf))
    want = ref(q, k, v, H, mask, pf)
    torch.cuda.synchronize()
    dead_err, dead_rows = _dead_rows_vs_mean_v(got, v, mask, pf, H)
    case = {"kernel": name, "dtype": dtype_name, "shape": [*q.shape[:2], k.shape[1], q.shape[2], H],
            "pair": pf is not None, "device_kernel": kernel_name, "launched": names,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_err_rel_to_max1": _rel_err(got, want), "finite": bool(torch.isfinite(got).all()),
            "masked_rows": dead_rows, "masked_rows_vs_mean_v": dead_err, "tol": tol}
    case["ok"] = bool(case["finite"] and case["max_err_rel_to_max1"] <= tol and dead_rows > 0
                      and dead_err <= tol and any(kernel_name in n for n in names))
    return case, got


def _onematmul_underflow_case(hd: int, dtype_name: str = "bfloat16") -> dict:
    """The one-matmul kernel where sample 2's head 1 logits sit ~180 (hd 32)
    or ~250 (hd 64) above its head 0 logits (0): head 0's segment sum
    underflows to 0 and takes 1/Lk on every key, so its output is the mean
    of v over all Lk keys (padded keys included), while head 1 keeps its own
    softmax."""
    import torch

    B, Lq, Lk, H = 3, 70, 17, MAIN_PATH["H"]
    q, k, v, mask, pf = _shortkey_edge_inputs(B, Lq, Lk, H * hd, True, seed=7 + hd,
                                              dtype_name=dtype_name)
    sign = torch.randint(0, 2, (hd,), generator=torch.Generator().manual_seed(9)).cuda() * 2 - 1
    q[2, :, hd:2 * hd] = (40.0 * sign).to(q.dtype)
    k[2, :, hd:2 * hd] = (k[2, :, hd:2 * hd].float().abs() * sign).to(k.dtype)
    k[2, :, :hd] = 0.0
    pf[0][2, 1] = False  # head 1 keeps every unmasked key
    case, got = _shortkey_edge_case("attention_shortkey_onematmul", q, k, v, mask, pf)
    head0 = got[2, :, :hd].float() - v[2, :, :hd].float().mean(0)
    case["underflow_rows_vs_mean_v"] = float(head0.abs().max())
    case["ok"] = bool(case["ok"] and case["underflow_rows_vs_mean_v"] <= case["tol"])
    return case


def _shortkey_edge_cases() -> list:
    """The bf16 short-key kernels at SHORTKEY_EDGE_LQ x SHORTKEY_EDGE_LK,
    with and without pair factors (_shortkey_edge_case, B = 3, E = 256), the
    one-matmul kernel also at ONEMATMUL_EDGE_HD64 with E = 512 and where one
    head's segment underflows against another's maximum (head_dim 32 and
    64); the fp32 instances at FP32_SHORTKEY_EDGE_LQ x FP32_SHORTKEY_EDGE_LK
    and the fp32 one-matmul kernel's underflowed segments too."""
    out = []
    for name in ("attention_shortkey", "attention_shortkey_onematmul"):
        for Lq in FP32_SHORTKEY_EDGE_LQ:
            for Lk in FP32_SHORTKEY_EDGE_LK:
                for pair in (True, False):
                    inputs = _shortkey_edge_inputs(3, Lq, Lk, MAIN_PATH["E"], pair,
                                                   seed=Lq * 100 + Lk + pair + 2,
                                                   dtype_name="float32")
                    out.append(_shortkey_edge_case(name, *inputs)[0])
    out.extend(_onematmul_underflow_case(hd, "float32") for hd in (32, 64))
    for name in ("attention_shortkey", "attention_shortkey_onematmul"):
        for Lq in SHORTKEY_EDGE_LQ:
            for Lk in SHORTKEY_EDGE_LK:
                for pair in (True, False):
                    inputs = _shortkey_edge_inputs(3, Lq, Lk, MAIN_PATH["E"], pair,
                                                   seed=Lq * 100 + Lk + pair)
                    out.append(_shortkey_edge_case(name, *inputs)[0])
    for Lq, Lk in ONEMATMUL_EDGE_HD64:
        for pair in (True, False):
            inputs = _shortkey_edge_inputs(3, Lq, Lk, 2 * MAIN_PATH["E"], pair,
                                           seed=Lq * 100 + Lk + pair + 1)
            out.append(_shortkey_edge_case("attention_shortkey_onematmul", *inputs)[0])
    out.extend(_onematmul_underflow_case(hd) for hd in (32, 64))
    return out


# the int8 FFN's edges: rows around its 64- and 128-row tiles and the
# charades site, at the model's widths K = N1 = 1024 (its 64-row instance)
# and the smallest the wrapper takes, K = N1 = K2 = 32 (its 128-row one)
FFN_EDGE_N = (1, 63, 64, 65, 127, 128, 129, 24960)
FFN_EDGE_WIDTHS = ((1024, 1024, 256), (32, 32, 32))


def _ffn_edge_cases() -> list:
    """The int8 FFN at FFN_EDGE_N x FFN_EDGE_WIDTHS in both dtypes against
    its plain version (2**-7, bit-equal share reported), with a row of zeros
    (the 1e-8 floor) and a row of +-1000 (every element saturates at +-127),
    on its device kernel (by name)."""
    import torch

    from mesm_tpu_torch.ops import ffn_int8 as fi

    out = []
    for K, N1, K2 in FFN_EDGE_WIDTHS:
        for dtype_name in ("bfloat16", "float32"):
            g = torch.Generator(device="cuda").manual_seed(K + N1)
            w1 = torch.randn(N1, K, generator=g, device="cuda") / K**0.5
            b1 = 0.1 * torch.randn(N1, generator=g, device="cuda")
            alpha = torch.full((1,), 0.25, device="cuda")
            w2 = torch.randn(K2, N1, generator=g, device="cuda") / N1**0.5
            b2 = 0.1 * torch.randn(K2, generator=g, device="cuda")
            for N in FFN_EDGE_N:
                x = torch.randn(N, K, generator=g, device="cuda")
                x[0] = 0.0
                if N > 1:
                    x[1] = 1000.0 * (1 - 2 * (torch.arange(K, device="cuda") % 2))
                x = x.to(getattr(torch, dtype_name))
                args = (x, w1, b1, alpha, w2, b2)
                got, names = launched_kernels(lambda: fi.ffn_int8(*args))
                want = fi.ffn_int8_reference(*args)
                torch.cuda.synchronize()
                case = {"kernel": "ffn_int8", "dtype": dtype_name, "shape": [N, K, N1, K2],
                        "device_kernel": "ffn_int8_kernel", "launched": names,
                        "max_abs_err": float((got.float() - want.float()).abs().max()),
                        "max_err_rel_to_max1": _rel_err(got, want),
                        "bit_equal_share": float((got == want).float().mean()),
                        "finite": bool(torch.isfinite(got).all()), "tol": TOL["ffn_int8"]}
                case["ok"] = bool(case["finite"] and case["max_err_rel_to_max1"] <= TOL["ffn_int8"]
                                  and any("ffn_int8_kernel" in n for n in names))
                out.append(case)
    return out


# Lq != Lk with the roles of HEADS_EDGE_SHAPES' (2, 70, 81) swapped
BACKWARD_EDGE_SHAPES = HEADS_EDGE_SHAPES + ((2, 81, 70, 256),)
# the device kernels of one attention_backward call
BACKWARD_KERNELS = ("attention_backward_dq_3xtf32_kernel", "attention_backward_dkdv_3xtf32_kernel")
# the backward's kernels at a head_dim above 128 (one block per 128 columns)
BACKWARD_WIDE_KERNELS = ("attention_backward_dq_wide_kernel",
                         "attention_backward_dkdv_wide_kernel")


def backward_kernels(hd: int) -> tuple:
    """The backward's two kernels at head_dim hd."""
    return BACKWARD_WIDE_KERNELS if hd > 128 else BACKWARD_KERNELS
# the kernels a forward route launches at a head_dim above 128 where they
# are not its own kernels' wide instances: the bf16 one-matmul kernel's wide
# block, and the fp32 one-matmul kernel's CUDA-core kernel
WIDE_KERNEL_NAMES = {("attention_shortkey_onematmul", "bfloat16"):
                         "attention_shortkey_onematmul_wide_kernel",
                     ("attention_shortkey_onematmul", "float32"):
                         "attention_shortkey_onematmul_fp32_wide_kernel"}


def route_kernel_name(name: str, dtype_name: str, hd: int, kernel_names: dict) -> str:
    """The device kernel a forward route launches at head_dim hd."""
    if hd > 128:
        return WIDE_KERNEL_NAMES.get((name, dtype_name), kernel_names[dtype_name])
    return kernel_names[dtype_name]


def _backward_edge_cases() -> list:
    """The fp32 backward kernels at BACKWARD_EDGE_SHAPES against their plain
    version and against autograd through attention_core on the same tensors
    (1e-5), by their device kernel names, with sample 1 (where B > 1) fully
    masked: its dq and dk must be 0 and its dv at every key the sum of dO
    over the queries over Lk (P = 1 / Lk). Where the shape is on a kernel
    route, also the trainable Function's output and gradients against
    attention_core's."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.models.attention import attention_core
    from mesm_tpu_torch.ops import attention_backward as abw
    from mesm_tpu_torch.ops.attention_trainable import attention_trainable

    H, tol, out = MAIN_PATH["H"], TOL["attention_backward"], []
    for B, Lq, Lk, E in BACKWARD_EDGE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * 1000 + Lq + Lk + E + 2)
        q, cot = (torch.randn(B, Lq, E, generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn(B, Lk, E, generator=g, device="cuda") for _ in range(2))
        lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
        mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
        if B > 1:
            mask[1] = False
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = attention_core(*leaves, H, key_valid_mask=mask)
        ref_out.backward(cot)
        auto = [t.grad for t in leaves]
        got, names = launched_kernels(
            lambda: abw.attention_backward(q, k, v, ref_out.detach(), cot, H, mask))
        want = abw.attention_backward_reference(q, k, v, cot, H, mask)
        torch.cuda.synchronize()
        case = {"kernel": "attention_backward", "dtype": "float32", "shape": [B, Lq, Lk, E, H],
                "device_kernel": "attention_backward_{dq,dkdv}_3xtf32_kernel",
                "launched": names,
                "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
                "max_err_rel_to_max1": max(_rel_err(a, b) for a, b in zip(got, want)),
                "vs_autograd_rel_to_max1": max(_rel_err(a, b) for a, b in zip(got, auto)),
                "finite": all(bool(torch.isfinite(a).all()) for a in got), "tol": tol}
        if B > 1:
            case["masked_sample_dq_dk_max"] = max(float(got[0][1].abs().max()),
                                                  float(got[1][1].abs().max()))
            case["masked_sample_dv_vs_mean_g"] = float(
                (got[2][1] - cot[1].sum(0) / Lk).abs().max())
        ok = (case["finite"] and case["max_err_rel_to_max1"] <= tol
              and case["vs_autograd_rel_to_max1"] <= tol
              and case.get("masked_sample_dq_dk_max", 0.0) == 0.0
              and case.get("masked_sample_dv_vs_mean_g", 0.0) <= tol
              and all(any(n in x for x in names) for n in BACKWARD_KERNELS))
        if kernels.fused_route(Lq, Lk, torch.float32, False) is not None:
            fn_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = abw.backward_launches
            fn_out = attention_trainable(*fn_leaves, H, mask)
            fn_out.backward(cot)
            torch.cuda.synchronize()
            case["function_backward_launches"] = abw.backward_launches - before
            case["function_vs_autograd_rel_to_max1"] = max(
                _rel_err(a, b) for a, b in zip([fn_out.detach()] + [t.grad for t in fn_leaves],
                                               [ref_out.detach()] + auto))
            ok = (ok and case["function_backward_launches"] == 1
                  and case["function_vs_autograd_rel_to_max1"] <= tol)
        case["ok"] = bool(ok)
        out.append(case)
    return out


def _sdpa_mask(mask):
    """SDPA's boolean mask for the same keys, with no fully masked row (SDPA
    gives NaN there, the kernels the uniform average)."""
    m = mask.clone()
    m[:, 1] = True
    return m[:, None, None, :]


def check_attention_trainable() -> list:
    """The trainable Function at the stacked train shape (32 rows): forward
    (the batched kernel) plus backward (the backward kernel), against plain
    autograd through attention_core and SDPA's forward and backward. Then
    the backward kernel alone on the same card tensors: against its plain
    version (and two calls bit for bit), timed beside its plain version,
    the plain autograd backward of attention_core and SDPA's backward, each
    on a graph built once, with the device memory it holds beyond its
    gradients. Returns both results."""
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.models.attention import attention_core
    from mesm_tpu_torch.ops import attention_backward as abw
    from mesm_tpu_torch.ops.attention_trainable import attention_trainable

    B, L, E, H = 2 * TACOS["B"], TACOS["L"], TACOS["E"], TACOS["H"]
    hd = E // H
    q, k, v, mask = _encoder_qkv(B, L, "float32", seed=2)
    cot = torch.randn(B, L, E, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(cot)
        return [out.detach()] + [t.grad for t in leaves]

    def trainable(a, b, c):
        return attention_trainable(a, b, c, H, mask)

    def plain(a, b, c):
        return attention_core(a, b, c, H, key_valid_mask=mask)

    got, want = run(trainable), run(plain)
    torch.cuda.synchronize()
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    res = {
        "kernel": "attention_trainable", "dtype": "float32", "shape": [B, L, E, H],
        "summary_name": "attention_trainable",
        "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
        "max_err_rel_to_max1": {"out": errs[0], "dq": errs[1], "dk": errs[2], "dv": errs[3]},
        "tol": TOL["attention_trainable"],
        "finite": all(bool(torch.isfinite(t).all()) for t in got),
    }
    if not (max(errs) <= TOL["attention_trainable"] and res["finite"]):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"attention_trainable: {res}")
    am = _sdpa_mask(mask)

    def sdpa(a, b, c):
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (a, b, c))
        o = Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
        return o.transpose(1, 2).reshape(B, L, E)

    res["ms"] = cuda_time_ms(lambda: run(trainable), iters=10)
    # the forward and backward kernels alone (every kernel named attention_*)
    res["kernel_ms"] = device_kernel_ms(lambda: run(trainable), "attention_", iters=10)
    res["plain_ms"] = cuda_time_ms(lambda: run(plain), iters=10)
    res["library_ms"] = cuda_time_ms(lambda: run(sdpa), iters=10)
    # inputs q, k, v, mask, d_out read once; out, dq, dk, dv written once;
    # six products: the function of (q, k, v, d_out) needs S and P.V
    # forward, dP, dV, dQ and dK backward; S once would do (the kernels
    # compute it three times: forward, and in each backward kernel); each
    # three TF32 products (3xTF32), as the kernels take them
    moved = 4 * B * L * E * 8 + B * L
    res["bound_ms"], res["bound_by"], res["bound_fp32_ms"] = attention_bound(
        B, H, L, L, hd, moved, "float32", products=6)

    out = got[0]  # the forward's output, as the Function saves it
    bwd = abw.attention_backward(q, k, v, out, cot, H, mask)
    again = abw.attention_backward(q, k, v, out, cot, H, mask)
    ref = abw.attention_backward_reference(q, k, v, cot, H, mask)
    torch.cuda.synchronize()
    errs = [_rel_err(a, b) for a, b in zip(bwd, ref)]
    b = {
        "kernel": "attention_backward", "dtype": "float32", "shape": [B, L, E, H],
        "summary_name": "attention_backward",
        "max_abs_err": max(float((a - r).abs().max()) for a, r in zip(bwd, ref)),
        "max_err_rel_to_max1": {"dq": errs[0], "dk": errs[1], "dv": errs[2]},
        "tol": TOL["attention_backward"],
        "finite": all(bool(torch.isfinite(t).all()) for t in bwd),
        "deterministic": all(torch.equal(a, c) for a, c in zip(bwd, again)),
    }
    if not (max(errs) <= TOL["attention_backward"] and b["finite"] and b["deterministic"]):
        emit(dict(b, phase="kernels", ok=False))
        raise SystemExit(f"attention_backward: {b}")
    del bwd, again, ref

    def call():
        return abw.attention_backward(q, k, v, out, cot, H, mask)

    b["ms"] = cuda_time_ms(call, iters=10)
    b["kernel_ms"] = device_kernel_ms(call, "attention_backward_", iters=10)
    b["dq_kernel_ms"], b["dkdv_kernel_ms"] = (device_kernel_ms(call, name, iters=10)
                                              for name in BACKWARD_KERNELS)
    # device memory a call holds beyond its inputs and its dq, dk, dv
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = call()
    torch.cuda.synchronize()
    b["workspace_bytes"] = torch.cuda.max_memory_allocated() - base - sum(
        t.numel() * t.element_size() for t in grads)
    del grads
    b["plain_ms"] = cuda_time_ms(lambda: abw.attention_backward_reference(q, k, v, cot, H, mask),
                                 iters=10)

    def backward_of(fn):
        """The backward alone: autograd.grad over a graph of fn built once."""
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        return lambda: torch.autograd.grad(o, leaves, cot, retain_graph=True)

    b["autograd_backward_ms"] = cuda_time_ms(backward_of(plain), iters=10)
    b["library_ms"] = cuda_time_ms(backward_of(sdpa), iters=10)
    # q, k, v, O, d_out and the mask read once; dq, dk, dv written once; five
    # products: S (only q, k, v, O and d_out are given), dP, dV, dQ and dK,
    # each three TF32 products on the tensor cores (3xTF32), as the kernels
    # take them; and the same five in fp32 without the tensor cores
    moved = 8 * B * L * E * 4 + B * L
    flops = 5 * 2.0 * B * H * L * L * hd
    b["bound_ms"], b["bound_by"] = bound(moved, 3 * flops, "tf32")
    b["bound_fp32_ms"], _ = bound(moved, flops, "float32")
    return [res, b]


def _pair_attention_case(B: int, Lq: int, Lk: int, pair: bool, dtype_name: str, seed: int):
    """q, k, v at a cross-attention site and its masks: padded keys, sample 1
    with every key masked, and pair factors with rows that mask every key
    of one head (sample 2, head 3, every other query) while the other heads
    keep keys: those are the one-matmul kernel's underflowed segments."""
    import torch

    E, H = MAIN_PATH["E"], MAIN_PATH["H"]
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").to(dt) for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    mask[1] = False
    pf = None
    if pair:
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[2, 3] = True
        qf[2, 3, ::2] = True
        pf = (qf, kf)
    return q, k, v, mask, pf


def _dead_pairs(mask, pf, H: int, Lq: int):
    """(B, H, Lq, Lk) True where the key mask or the pair mask drops (q, k)."""
    dead = ~mask[:, None, None, :]
    if pf is not None:
        dead = dead | (pf[0][..., :, None] & pf[1][..., None, :])
    return dead.expand(mask.shape[0], H, Lq, mask.shape[1])


def _dead_rows_vs_mean_v(got, v, mask, pf, H: int):
    """The largest distance, over the (b, h, q) rows whose keys are all
    dropped, of the output from the mean of v over all Lk keys (padded keys
    included), and how many such rows there are."""
    B, Lq, E = got.shape
    hd = E // H
    dead = _dead_pairs(mask, pf, H, Lq).all(-1)  # (B, H, Lq)
    mean_v = v.float().mean(1).view(B, 1, H, hd)
    diff = (got.float().view(B, Lq, H, hd) - mean_v).abs().amax(-1).transpose(1, 2)
    sel = diff[dead]
    return (float(sel.max()) if sel.numel() else 0.0), int(dead.sum())


def _pair_kernels():
    from mesm_tpu_torch.ops import attention_packed as ap
    from mesm_tpu_torch.ops import attention_shortkey as sk

    return {
        "attention_packed_pair": (ap.attention_packed_pair, ap.attention_packed_pair_reference),
        "attention_shortkey": (sk.attention_shortkey, sk.attention_shortkey_reference),
        "attention_shortkey_onematmul": (sk.attention_shortkey_onematmul,
                                         sk.attention_shortkey_onematmul_reference),
    }


# the device kernel the pair and short-key wrappers launch, by dtype: bf16
# on the mma tiles, float32 in 3xTF32 (the pair entry point and the
# short-key kernel on the 3xTF32 body, the one-matmul kernel on its own)
PAIR_KERNEL_NAMES = {("attention_packed_pair", "bfloat16"): "attention_packed_pair_mma_kernel",
                     ("attention_packed_pair", "float32"): "attention_packed_pair_3xtf32_kernel",
                     ("attention_shortkey", "bfloat16"): "attention_shortkey_mma_kernel",
                     ("attention_shortkey", "float32"): "attention_shortkey_3xtf32_kernel",
                     ("attention_shortkey_onematmul", "bfloat16"):
                         "attention_shortkey_onematmul_mma_kernel",
                     ("attention_shortkey_onematmul", "float32"):
                         "attention_shortkey_onematmul_3xtf32_kernel"}


def check_pair_attention(name: str, site: str, B: int, Lq: int, Lk: int, pair: bool,
                         dtype_name: str = "bfloat16", seed: int = 4,
                         summary=None) -> dict:
    """A pair-masked or short-key attention kernel against its plain version
    at a model site, then its time, its plain version's, and SDPA's on the
    same function (an additive -1e9 mask built from the key mask and the
    pair factors)."""
    import torch
    import torch.nn.functional as Fn

    fn, ref = _pair_kernels()[name]
    H = MAIN_PATH["H"]
    E = MAIN_PATH["E"]
    hd = E // H
    q, k, v, mask, pf = _pair_attention_case(B, Lq, Lk, pair, dtype_name, seed)
    got = fn(q, k, v, H, mask, pf)
    want = ref(q, k, v, H, mask, pf)
    torch.cuda.synchronize()
    tol = TOL[f"{name}_{dtype_name}"]
    err = _rel_err(got, want)
    dead_err, dead_rows = _dead_rows_vs_mean_v(got, v, mask, pf, H)
    res = {
        "kernel": name, "site": site, "dtype": dtype_name, "shape": [B, Lq, Lk, E, H],
        "pair": pair, "max_abs_err": float((got.float() - want.float()).abs().max()),
        "max_err_rel_to_max1": err, "tol": tol, "finite": bool(torch.isfinite(got).all()),
        "masked_rows": dead_rows, "masked_rows_vs_mean_v": dead_err, "summary_name": summary,
    }
    if not (err <= tol and res["finite"] and dead_rows > 0 and dead_err <= tol):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"{name} at {site}: {res}")
    res["ms"] = cuda_time_ms(lambda: fn(q, k, v, H, mask, pf))
    res["kernel_ms"] = device_kernel_ms(lambda: fn(q, k, v, H, mask, pf),
                                        PAIR_KERNEL_NAMES[(name, dtype_name)])
    res["plain_ms"] = cuda_time_ms(lambda: ref(q, k, v, H, mask, pf))
    am = torch.zeros(B, H, Lq, Lk, dtype=q.dtype, device="cuda").masked_fill(
        _dead_pairs(mask, pf, H, Lq), -1e9)
    qh, kh, vh = (t.view(B, -1, H, hd).transpose(1, 2) for t in (q, k, v))
    res["library_ms"] = cuda_time_ms(
        lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
    )
    item = q.element_size()
    moved = 2 * B * (Lq + Lk) * E * item + B * Lk + (B * H * (Lq + Lk) if pair else 0)
    # bf16 on its tensor cores, fp32 in 3xTF32
    res["bound_ms"], res["bound_by"], _ = attention_bound(B, H, Lq, Lk, hd, moved, dtype_name)
    return res


# (rows, K, N1, K2) of the int8 FFN at widths off its tiles, held against
# the plain version beside each site: widths that are no multiple of 32,
# N1 2048 (the model's --dim_feedforward 2048), and N1 2048 on inputs
# whose integer sums pass 2**24 (`big`: every h and w2 positive)
FFN_WIDTHS = ((1000, 48, 80, 48, False), (4096, 256, 2048, 256, False),
              (600, 256, 2048, 256, True))


def _ffn_args(N: int, K: int, N1: int, K2: int, dt, seed: int = 5, big: bool = False):
    """x (N, K) in dt and the FFN's f32 weights (torch layout), from a seed;
    with `big`, positive inputs and weights, so that linear2's sums pass
    2**24."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, K, generator=g, device="cuda")
    w1 = torch.randn(N1, K, generator=g, device="cuda") / K**0.5
    b1 = 0.1 * torch.randn(N1, generator=g, device="cuda")
    alpha = torch.full((1,), 0.25, device="cuda")
    w2 = torch.randn(K2, N1, generator=g, device="cuda") / N1**0.5
    b2 = 0.1 * torch.randn(K2, generator=g, device="cuda")
    if big:
        x, w1, b1, w2 = x.abs() + 1, w1.abs(), b1.abs(), w2.abs() + 1
    return x.to(dt), w1, b1, alpha, w2, b2


def check_ffn_int8(site: str, dtype_name: str, N: int, summary: str, K: int = 256,
                   N1: int = 1024) -> dict:
    """The fused int8 FFN at an FFN site (N rows of width K, hidden N1)
    against its plain version, its distance to the exact fp32 FFN, then its
    time, its plain version's, and as context the FFN it replaces in the
    site's dtype (F.linear -> prelu -> F.linear, cuBLAS) and torch._int_mm
    for each of its two products; untimed, the kernel at FFN_WIDTHS against
    its plain version."""
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.ops import ffn_int8 as fi

    dt = getattr(torch, dtype_name)
    widths = []
    for rows, k, n1, k2, big in FFN_WIDTHS:
        wargs = _ffn_args(rows, k, n1, k2, dt, seed=6, big=big)
        wgot, wwant = fi.ffn_int8(*wargs), fi.ffn_int8_reference(*wargs)
        torch.cuda.synchronize()
        widths.append({"shape": [rows, k, n1, k2], "big_sums": big,
                       "max_err_rel_to_max1": _rel_err(wgot, wwant),
                       "bit_equal_share": float((wgot == wwant).float().mean()),
                       "finite": bool(torch.isfinite(wgot).all())})
    args = _ffn_args(N, K, N1, K, dt)
    x, w1, b1, alpha, w2, b2 = args
    quantized = fi.weight_quantizations
    got = fi.ffn_int8(*args)
    want = fi.ffn_int8_reference(*args)
    exact = Fn.linear(Fn.prelu(Fn.linear(x.float(), w1, b1), alpha), w2, b2)
    torch.cuda.synchronize()
    err = _rel_err(got, want)
    res = {
        "kernel": "ffn_int8", "site": site, "dtype": dtype_name, "shape": [N, K, N1, K],
        "summary_name": summary, "max_abs_err": float((got.float() - want.float()).abs().max()),
        "max_err_rel_to_max1": err, "bit_equal_share": float((got == want).float().mean()),
        "tol": TOL["ffn_int8"], "finite": bool(torch.isfinite(got).all()),
        "vs_exact_fp32_mean_rel": float((got.float() - exact).abs().mean() / exact.abs().mean()),
    }
    res["widths"] = widths
    if not (err <= TOL["ffn_int8"] and res["finite"]
            and all(c["finite"] and c["max_err_rel_to_max1"] <= TOL["ffn_int8"]
                    for c in res["widths"])):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"ffn_int8 at {site}: {res}")
    # the cached weights: 20 timed calls and the profiler's 21 quantize none
    res["ms"] = cuda_time_ms(lambda: fi.ffn_int8(*args))
    res["kernel_ms"] = device_kernel_ms(lambda: fi.ffn_int8(*args), "ffn_int8_kernel")
    res["weight_quantizations"] = fi.weight_quantizations - quantized
    if res["weight_quantizations"] != 1:
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"ffn_int8 at {site}: the weights were quantized "
                         f"{res['weight_quantizations']} times for one weight version")

    def first_call():  # a call that finds no cached weights and quantizes them
        fi._weight_cache.clear()
        return fi.ffn_int8(*args)

    res["first_call_ms"] = cuda_time_ms(first_call)
    res["plain_ms"] = cuda_time_ms(lambda: fi.ffn_int8_reference(*args))
    w1d, b1d, ad, w2d, b2d = (t.to(dt) for t in (w1, b1, alpha, w2, b2))
    res["library_ms"] = cuda_time_ms(lambda: Fn.linear(Fn.prelu(Fn.linear(x, w1d, b1d), ad), w2d, b2d))
    w1q, _ = fi.quantize_weight(w1)
    w2q, _ = fi.quantize_weight(w2)
    g = torch.Generator(device="cuda").manual_seed(7)
    xq = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
    hq = torch.randint(-127, 128, (N, N1), generator=g, device="cuda", dtype=torch.int8)
    try:  # context only: a library call that may not take these shapes on every build
        res["int_mm_ms"] = [cuda_time_ms(lambda: torch._int_mm(xq, w1q.t())),
                            cuda_time_ms(lambda: torch._int_mm(hq, w2q.t()))]
    except RuntimeError as e:
        res["int_mm_ms"] = None
        res["int_mm_error"] = str(e)[:200]
    # x and out read and written once; the int8 weights and their bf16
    # scales and biases; 2 int8 products of 2 * N * K * N1 operations
    moved = 2 * N * K * x.element_size() + 2 * K * N1 + 4 * (N1 + K)
    res["bound_ms"], res["bound_by"] = bound(moved, 4.0 * N * K * N1, "int8")
    return res


# (Lq, Lk) of the stream layer at D 48 (head_dim 12, padded to 16 in the
# kernel), 4 heads, F 80, per flavour, with a sample whose keys are all
# masked, each with and without pair factors
STREAM_EDGE = dict(D=48, H=4, F=80, B=3, cases={"encoder": ((70, 70),), "t2v": ((70, 1), (70, 17))})


def _stream_edge_cases(flavor: str, dtype_name: str) -> list:
    """The stream layer at STREAM_EDGE against its plain version, untimed."""
    import torch

    from mesm_tpu_torch.ops import stream_layer as sl

    dt, e, out = getattr(torch, dtype_name), STREAM_EDGE, []
    D, H, F, B = e["D"], e["H"], e["F"], e["B"]
    for Lq, Lk in e["cases"][flavor]:
        for pair in (False, True):
            g = torch.Generator(device="cuda").manual_seed(Lk + 10 * pair)
            rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
            x, pos = rn(B, Lq, D).to(dt), rn(B, Lq, D).to(dt)
            k_in = v_in = None
            if flavor == "t2v":
                k_in, v_in = rn(B, Lk, D).to(dt), rn(B, Lk, D).to(dt)
            shapes = {"w1": (F, D), "b1": (F,), "w2": (D, F), "alpha": (1,)}
            params = {n: rn(*shapes.get(n, (D, D) if n in ("wq", "wk", "wv", "wo") else (D,)))
                      * (1 / D**0.5 if n in ("wq", "wk", "wv", "wo", "w1") else
                         1 / F**0.5 if n == "w2" else 0.3) for n in sl.WEIGHT_NAMES}
            mask = torch.rand(B, Lk, generator=g, device="cuda") < 0.7
            mask[:, 0] = True
            mask[1] = False  # every key of sample 1 masked
            pf = None
            if pair:
                pf = (torch.rand(B, H, Lq, generator=g, device="cuda") < 0.3,
                      torch.rand(B, H, Lk, generator=g, device="cuda") < 0.3)
            with torch.no_grad():
                got = sl.fused_stream_layer(x, pos, k_in, v_in, mask, pf, params, H, flavor == "encoder")
                want = sl.stream_layer_reference(x, pos, k_in, v_in, mask, pf, params, H,
                                                 flavor == "encoder")
            torch.cuda.synchronize()
            out.append({"shape": [B, Lq, Lk, D, H, F], "pair": pair,
                        "max_err_rel_to_max1": _rel_err(got, want),
                        "finite": bool(torch.isfinite(got).all())})
    return out


STREAM_KERNEL = "stream_layer_kernel"


def check_stream_layer(flavor: str, dtype_name: str, summary: str) -> dict:
    """The fused stream layer on the bench entry point's inputs at the
    charades widths (STREAM), sample 1 with every key masked, against its
    plain version, on the device kernel STREAM_KERNEL (the profiler's
    names); untimed, the layer at STREAM_EDGE; then its time (CUDA events,
    and the kernel alone), the plain version's, and as the library column
    the port's module layer in eval on the same inputs (no single PyTorch
    call computes the layer)."""
    import torch

    from mesm_tpu_torch.ops import stream_layer as sl
    from mesm_tpu_torch.scripts.bench_layer_kernel import D, F, H, make_case

    dt = getattr(torch, dtype_name)
    B, Lq = STREAM["B"], STREAM["L"] if flavor == "encoder" else STREAM["Lv"]
    with torch.no_grad():
        case = make_case(flavor, B, Lq, dt, "cuda")
        x, args = case["x"], list(case["args"])
        args[3] = args[3].clone()
        args[3][1] = False
        Lk = args[3].shape[1]
        got, names = launched_kernels(lambda: sl.fused_stream_layer(x, *args))
        want = sl.stream_layer_reference(x, *args)
        torch.cuda.synchronize()
        err, tol = _rel_err(got, want), TOL[f"stream_layer_{dtype_name}"]
        res = {
            "kernel": "stream_layer", "flavor": flavor, "dtype": dtype_name,
            "shape": [B, Lq, Lk, D, H, F], "pair": args[4] is not None, "summary_name": summary,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_err_rel_to_max1": err, "tol": tol, "finite": bool(torch.isfinite(got).all()),
            "device_kernel": STREAM_KERNEL, "launched": names,
            "edges": _stream_edge_cases(flavor, dtype_name),
        }
        if not (err <= tol and res["finite"] and any(STREAM_KERNEL in n for n in names)
                and all(c["finite"] and c["max_err_rel_to_max1"] <= tol for c in res["edges"])):
            emit(dict(res, phase="kernels", ok=False))
            raise SystemExit(f"stream_layer {flavor} {dtype_name}: {res}")
        res["ms"] = cuda_time_ms(lambda: sl.fused_stream_layer(x, *args))
        res["kernel_ms"] = device_kernel_ms(lambda: sl.fused_stream_layer(x, *args),
                                            "stream_layer_kernel")
        res["plain_ms"] = cuda_time_ms(lambda: sl.stream_layer_reference(x, *args))
        res["library_ms"] = cuda_time_ms(lambda: case["module"](x))
    # x, pos and out (and the text's keys and values) once, the masks, the
    # f32 weights; the operations of layer_pallas.py:236-237, in fp32 as
    # three TF32 products each (3xTF32) at the TF32 rate
    item = x.element_size()
    moved = (3 * B * Lq * D + (0 if flavor == "encoder" else 2 * B * Lk * D)) * item + B * Lk \
        + (B * H * (Lq + Lk) if args[4] is not None else 0) + 4 * (4 * D * D + 2 * D * F + 8 * D + F + 1)
    ops = 2.0 * B * (Lq * D * D * 2 + Lk * D * D * 2 + Lq * Lk * D * 2 + Lq * D * F * 2)
    if dtype_name == "float32":
        res["bound_ms"], res["bound_by"] = bound(moved, 3 * ops, "tf32")
    else:
        res["bound_ms"], res["bound_by"] = bound(moved, ops, dtype_name)
    return res


# the anchor's layouts of a (B, L, D) stream, and the device kernel each
# takes: row-major, a (B, D, L) tensor viewed as (B, L, D), and the [:, 1:]
# slice of a row-major (B, L + 1, D) stream (the encoder memory without its
# global token, the layout of phase stream_layer)
ANCHOR_LAYOUTS = {"row": "anchor_rows_kernel", "transposed": "anchor_transpose_kernel",
                  "slice": "anchor_rows_kernel"}
ANCHOR_TARGET_MS = 0.0152  # the copy's aim at this shape: twice its byte bound


def _anchor_input(layout: str, dt, seed: int = 8):
    """A (128, 194, 256) stream of dtype dt in the given layout (ANCHOR_LAYOUTS)."""
    import torch

    B, L, D = MAIN_PATH["B"], MAIN_PATH["L"] - 1, MAIN_PATH["E"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randint(-100, 100, (B, D, L + 1), generator=g, device="cuda").to(dt)
    if dt.is_floating_point:
        base = base + torch.rand(B, D, L + 1, generator=g, device="cuda").to(dt)
    if layout == "row":
        return base[..., 1:].transpose(1, 2).contiguous()
    if layout == "transposed":
        return base[..., 1:].contiguous().transpose(1, 2)
    return base.transpose(1, 2).contiguous()[:, 1:]


def check_layout_anchor(layout: str, summary=None) -> dict:
    """layout_anchor at the stream's shape (128 x 194 x 256) in one of
    ANCHOR_LAYOUTS: in bf16, float32 (4 bytes) and uint8 (1 byte) a fresh
    row-major tensor bit-equal to its plain version (a contiguous clone), on
    the layout's device kernel; then, in bf16, its time against
    ANCHOR_TARGET_MS, the plain version's and, where x is not row-major,
    x.contiguous()'s."""
    import torch

    from mesm_tpu_torch.ops import anchor

    res = {"kernel": "layout_anchor", "layout": layout, "summary_name": summary,
           "tol": TOL["layout_anchor"], "device_kernel": ANCHOR_LAYOUTS[layout], "dtypes": {}}
    for dt in (torch.float32, torch.uint8, torch.bfloat16):
        x = _anchor_input(layout, dt)
        got, names = launched_kernels(lambda: anchor.layout_anchor(x))
        want = anchor.layout_anchor_reference(x)
        torch.cuda.synchronize()
        res["dtypes"][str(dt)] = {
            "bit_equal": bool(torch.equal(got.view(torch.uint8), want.view(torch.uint8))),
            "row_major": got.is_contiguous() and got.data_ptr() != x.data_ptr(),
            "launched": names}
    res["shape"] = list(x.shape)
    res["max_abs_err"] = float((got.float() - want.float()).abs().max())
    if not all(c["bit_equal"] and c["row_major"]
               and any(ANCHOR_LAYOUTS[layout] in n for n in c["launched"])
               for c in res["dtypes"].values()):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"layout_anchor {layout}: {res}")
    res["ms"] = cuda_time_ms(lambda: anchor.layout_anchor(x))
    res["kernel_ms"] = device_kernel_ms(lambda: anchor.layout_anchor(x), "anchor_")
    res["target_ms"] = ANCHOR_TARGET_MS
    res["plain_ms"] = cuda_time_ms(lambda: anchor.layout_anchor_reference(x))
    res["library_ms"] = None if x.is_contiguous() else cuda_time_ms(lambda: x.contiguous())
    res["bound_ms"], res["bound_by"] = bound(2 * x.numel() * x.element_size(), 0.0, "bfloat16")
    return res


# The head-dim phase: every attention kernel at the head dims of its
# instances 16, 64 and 128, at a padded 24 (run on the 32 instance with zero
# columns), and on the wide bodies at 256 and 512 (2 and 4 slices of 128)
# and a padded 192 (run at 256), in both dtypes (the backward in fp32),
# against its plain version within the kernel's own tolerance (TOL), by its
# device kernel's name; each case with H = 4 heads (E = 4 hd) at a tile edge
# (70 queries, keys not a multiple of 16) and a fully masked sample.
HEAD_DIMS = (16, 24, 64, 128, 192, 256, 512)
HEAD_DIM_H = 4
# (B, Lq, Lk) of each route's cases: the encoder kernels past the registers'
# resident keys at hd 128 (128) and beyond 256; the short-key kernels at
# their sites' key counts
HEAD_DIM_SHAPES = {"encoder": ((2, 70, 81), (2, 70, 300)), "pair": ((2, 70, 81),),
                   "shortkey": ((3, 70, 17), (3, 65, 33)), "backward": ((2, 70, 81), (2, 81, 130))}
# the per-launch timings at hd 16 and 128 on the main paths' shapes, E =
# 256 with 16 and 2 heads: (route, dtype, B, Lq, Lk)
HEAD_DIM_TIMED = (("attention_packed", "bfloat16", 128, 195, 195),
                  ("attention_batched", "float32", 32, 601, 601),
                  ("attention_per_head", "bfloat16", 128, 195, 195),
                  ("attention_all_heads", "float32", 16, 601, 601),
                  ("attention_batched", "bfloat16", 128, 195, 195),
                  ("attention_packed", "float32", 16, 601, 601),
                  ("attention_packed_pair", "bfloat16", 128, 194, 81),
                  ("attention_shortkey", "bfloat16", 128, 194, 17),
                  ("attention_shortkey_onematmul", "bfloat16", 128, 194, 17),
                  ("attention_shortkey", "float32", 16, 600, 17),
                  ("attention_shortkey_onematmul", "float32", 16, 600, 17),
                  ("attention_backward", "float32", 32, 601, 601))
# keys past what a block once staged (H = 4): bf16 at hd 128 beyond 416 keys
# and a smaller head_dim beyond its staging (padded to 128) on the wide
# body; the wide bodies past one chunk of 704 keys (705: a last chunk of one
# key); the fp32 pair entry point past the 215 keys its CUDA-core kernel
# took at hd 128: (route, dtype, hd, B, Lq, Lk)
HEAD_DIM_LONG_KEYS = (("attention_packed", "bfloat16", 128, 2, 70, 601),
                      ("attention_packed", "bfloat16", 32, 2, 70, 1800),
                      ("attention_per_head", "bfloat16", 64, 2, 70, 900),
                      ("attention_all_heads", "bfloat16", 128, 2, 70, 500),
                      ("attention_packed_pair", "bfloat16", 128, 2, 70, 601),
                      ("attention_packed_pair", "float32", 128, 2, 70, 601),
                      ("attention_packed_pair", "float32", 32, 2, 70, 1000),
                      ("attention_packed", "bfloat16", 256, 2, 70, 704),
                      ("attention_packed", "bfloat16", 256, 2, 70, 705),
                      ("attention_batched", "bfloat16", 256, 2, 70, 1500),
                      ("attention_packed_pair", "bfloat16", 256, 2, 70, 1000),
                      ("attention_per_head", "bfloat16", 512, 2, 70, 760))


def _hd_inputs(B: int, Lq: int, Lk: int, E: int, H: int, dtype_name: str, pair: bool, seed: int):
    """q, k, v, a key mask (sample 1 fully masked) and, with `pair`, pair
    factors (sample 0's head 0: every key flagged and every other query)."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda").to(dt) for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    mask[1] = False
    pf = None
    if pair:
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[0, 0] = True
        qf[0, 0, ::2] = True
        pf = (qf, kf)
    return q, k, v, mask, pf


def _hd_routes():
    """(wrapper, plain version, takes pair factors, shape group, device
    kernel name by dtype) of every forward attention route."""
    enc, pk = _encoder_kernels(), _pair_kernels()
    routes = {name: (*enc[name], False, "encoder", ENCODER_KERNEL_NAMES[name]) for name in enc}
    for name in pk:
        routes[name] = (*pk[name], True, "pair" if name == "attention_packed_pair" else "shortkey",
                        {d: PAIR_KERNEL_NAMES[(name, d)] for d in ("bfloat16", "float32")})
    return routes


def _hd_backward_case(B: int, Lq: int, Lk: int, hd: int, seed: int) -> dict:
    """The fp32 backward at head_dim hd against its plain version and
    autograd through attention_core (1e-5), with the trainable Function's
    output and gradients where the shape is on a kernel route."""
    import torch

    from mesm_tpu_torch.models.attention import attention_core
    from mesm_tpu_torch.ops import attention_backward as abw
    from mesm_tpu_torch.ops.attention_trainable import attention_trainable

    H, tol = HEAD_DIM_H, TOL["attention_backward"]
    q, k, v, mask, _ = _hd_inputs(B, Lq, Lk, H * hd, H, "float32", False, seed)
    cot = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                      device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = attention_core(*leaves, H, key_valid_mask=mask)
    ref_out.backward(cot)
    auto = [t.grad for t in leaves]
    got, names = launched_kernels(
        lambda: abw.attention_backward(q, k, v, ref_out.detach(), cot, H, mask))
    want = abw.attention_backward_reference(q, k, v, cot, H, mask)
    fn_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn_out = attention_trainable(*fn_leaves, H, mask)
    fn_out.backward(cot)
    torch.cuda.synchronize()
    case = {"kernel": "attention_backward", "dtype": "float32", "head_dim": hd,
            "shape": [B, Lq, Lk, H * hd, H], "launched": names,
            "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "max_err_rel_to_max1": max(_rel_err(a, b) for a, b in zip(got, want)),
            "vs_autograd_rel_to_max1": max(_rel_err(a, b) for a, b in zip(got, auto)),
            "function_vs_autograd_rel_to_max1": max(
                _rel_err(a, b) for a, b in zip([fn_out.detach()] + [t.grad for t in fn_leaves],
                                               [ref_out.detach()] + auto)),
            "masked_sample_dq_dk_max": max(float(got[0][1].abs().max()),
                                           float(got[1][1].abs().max())),
            "finite": all(bool(torch.isfinite(a).all()) for a in got), "tol": tol}
    case["ok"] = bool(case["finite"] and case["max_err_rel_to_max1"] <= tol
                      and case["vs_autograd_rel_to_max1"] <= tol
                      and case["function_vs_autograd_rel_to_max1"] <= tol
                      and case["masked_sample_dq_dk_max"] == 0.0
                      and all(any(n in x for x in names) for n in backward_kernels(hd)))
    return case


def _hd_case(routes: dict, name: str, dtype_name: str, hd: int, B: int, Lq: int, Lk: int,
             pair: bool) -> dict:
    """One route at head_dim hd (H = HEAD_DIM_H) against its plain version,
    by its device kernel's name; each fully masked row must give the mean of
    v."""
    import torch

    fn, ref, takes_pair, _, kernel_names = routes[name]
    H = HEAD_DIM_H
    seed = hd * 1000 + Lq + Lk + pair
    q, k, v, mask, pf = _hd_inputs(B, Lq, Lk, H * hd, H, dtype_name, pair, seed)
    args = (q, k, v, H, mask) + ((pf,) if takes_pair else ())
    got, names = launched_kernels(lambda: fn(*args))
    want = ref(*args)
    torch.cuda.synchronize()
    tol = TOL[f"{name}_{dtype_name}"]
    dead_err, dead_rows = _dead_rows_vs_mean_v(got, v, mask, pf, H)
    kname = route_kernel_name(name, dtype_name, hd, kernel_names)
    case = {"kernel": name, "dtype": dtype_name, "head_dim": hd,
            "shape": [B, Lq, Lk, H * hd, H], "pair": pair, "launched": names,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_err_rel_to_max1": _rel_err(got, want),
            "finite": bool(torch.isfinite(got).all()),
            "masked_rows_vs_mean_v": dead_err, "tol": tol}
    case["ok"] = bool(case["finite"] and case["max_err_rel_to_max1"] <= tol
                      and dead_rows > 0 and dead_err <= tol and any(kname in n for n in names))
    return case


def check_head_dims() -> list:
    """Every route at HEAD_DIMS x both dtypes x its HEAD_DIM_SHAPES (with
    and without pair factors where it takes them), the HEAD_DIM_LONG_KEYS
    cases, and the backward, against the plain versions."""
    routes, cases = _hd_routes(), []
    for name, (_, _, takes_pair, group, _) in routes.items():
        for hd in HEAD_DIMS:
            for dtype_name in ("bfloat16", "float32"):
                for B, Lq, Lk in HEAD_DIM_SHAPES[group]:
                    for pair in ((True, False) if takes_pair else (False,)):
                        if name == "attention_packed_pair" and not pair:
                            continue
                        cases.append(_hd_case(routes, name, dtype_name, hd, B, Lq, Lk, pair))
    for name, dtype_name, hd, B, Lq, Lk in HEAD_DIM_LONG_KEYS:
        cases.append(_hd_case(routes, name, dtype_name, hd, B, Lq, Lk,
                              name == "attention_packed_pair"))
    for hd in HEAD_DIMS:
        for B, Lq, Lk in HEAD_DIM_SHAPES["backward"]:
            cases.append(_hd_backward_case(B, Lq, Lk, hd, seed=hd + Lq + Lk))
    return cases


def _hd_timed_case(name: str, dtype_name: str, B: int, Lq: int, Lk: int, hd: int) -> dict:
    """One HEAD_DIM_TIMED case with E = 256 at head_dim hd: the wrapper
    against its plain version on the same inputs (its route's TOL; the
    backward at 1e-5, also against autograd through attention_core; each
    forward's fully masked rows against the mean of v); then, if it holds,
    per launch: CUDA events, the kernel alone from the profiler, the plain
    version's time, SDPA's on the same function (the backward: SDPA's
    backward), and the bound."""
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.models.attention import attention_core
    from mesm_tpu_torch.ops import attention_backward as abw

    E = MAIN_PATH["E"]
    H = E // hd
    routes = _hd_routes()
    pair = name != "attention_shortkey_onematmul" and name in _pair_kernels()
    q, k, v, mask, pf = _hd_inputs(B, Lq, Lk, E, H, dtype_name, pair, seed=hd + B)
    case = {"kernel": name, "dtype": dtype_name, "head_dim": hd, "heads": H,
            "shape": [B, Lq, Lk, E], "pair": pair}
    if name == "attention_backward":
        g = torch.randn_like(q)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out_t = attention_core(*leaves, H, key_valid_mask=mask)
        out_t.backward(g)
        auto = [t.grad for t in leaves]
        out_t = out_t.detach()
        fn = lambda: abw.attention_backward(q, k, v, out_t, g, H, mask)  # noqa: E731
        plain = lambda: abw.attention_backward_reference(q, k, v, g, H, mask)  # noqa: E731
        key, tol = "attention_backward_", TOL["attention_backward"]
        got, names = launched_kernels(fn)
        want = plain()
        torch.cuda.synchronize()
        case.update(max_err_rel_to_max1=max(_rel_err(a, b) for a, b in zip(got, want)),
                    vs_autograd_rel_to_max1=max(_rel_err(a, b) for a, b in zip(got, auto)),
                    finite=all(bool(torch.isfinite(a).all()) for a in got))
        ok = case["vs_autograd_rel_to_max1"] <= tol and all(
            any(n in x for x in names) for n in backward_kernels(hd))
        del auto
    else:
        f, ref, takes_pair, _, kernel_names = routes[name]
        args = (q, k, v, H, mask) + ((pf,) if takes_pair else ())
        fn = lambda: f(*args)  # noqa: E731
        plain = lambda: ref(*args)  # noqa: E731
        key = route_kernel_name(name, dtype_name, hd, kernel_names)
        tol = TOL[f"{name}_{dtype_name}"]
        got, names = launched_kernels(fn)
        want = plain()
        torch.cuda.synchronize()
        dead_err, dead_rows = _dead_rows_vs_mean_v(got, v, mask, pf, H)
        case.update(max_err_rel_to_max1=_rel_err(got, want), finite=bool(torch.isfinite(got).all()),
                    masked_rows_vs_mean_v=dead_err)
        ok = dead_rows > 0 and dead_err <= tol and any(key in n for n in names)
    case.update(launched=names, tol=tol)
    case["ok"] = bool(ok and case["finite"] and case["max_err_rel_to_max1"] <= tol)
    del got, want
    if not case["ok"]:
        return case
    qh, kh, vh = (t.view(B, -1, H, hd).transpose(1, 2) for t in (q, k, v))
    am = (torch.zeros(B, H, Lq, Lk, dtype=q.dtype, device="cuda").masked_fill(
        _dead_pairs(mask, pf, H, Lq), -1e9) if pair else _sdpa_mask(mask))
    item = q.element_size()
    if name == "attention_backward":
        sl = [t.clone().requires_grad_(True) for t in (qh, kh, vh)]
        so = Fn.scaled_dot_product_attention(*sl, attn_mask=am)
        gh = g.view(B, Lq, H, hd).transpose(1, 2)
        library = lambda: torch.autograd.grad(so, sl, gh, retain_graph=True)  # noqa: E731
        # as check_attention_trainable: q, k, v, O, d_out, the mask read and
        # dq, dk, dv written once; five products, each 3 TF32 products
        moved = 8 * B * Lq * E * 4 + B * Lk
        bnd = bound(moved, 3 * 5 * 2.0 * B * H * Lq * Lk * hd, "tf32")
    else:
        library = lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)  # noqa: E731
        moved = 2 * B * (Lq + Lk) * E * item + B * Lk + (B * H * (Lq + Lk) if pair else 0)
        # fp32 in 3xTF32 is bound at the TF32 rate, the one CUDA-core
        # kernel (the fp32 one-matmul kernel at a wide head) at the fp32 one
        if dtype_name == "float32" and name == "attention_shortkey_onematmul" and hd > 128:
            bnd = bound(moved, 2.0 * B * H * Lq * Lk * 2 * hd, "float32")
        else:
            bnd = attention_bound(B, H, Lq, Lk, hd, moved, dtype_name)
    case.update(ms=cuda_time_ms(fn, iters=10), kernel_ms=device_kernel_ms(fn, key, iters=10),
                plain_ms=cuda_time_ms(plain, iters=5), library_ms=cuda_time_ms(library, iters=10),
                bound_ms=bnd[0], bound_by=bnd[1])
    return case


def time_head_dims() -> list:
    """_hd_timed_case at each HEAD_DIM_TIMED shape, at hd 16 (16 heads), 128
    (2 heads) and 256 (one head, on the wide bodies)."""
    return [_hd_timed_case(*shape, hd) for shape in HEAD_DIM_TIMED for hd in (16, 128, 256)]


def _nheads_step_checks(card: str, nheads: int) -> dict:
    """The charades bf16 eval step in "auto" at --nheads `nheads` (16: head_dim
    16; 1: head_dim 256, on the wide bodies: the packed kernel at the
    encoder) against kernels "off", and the kernel-engaged TACoS fp32 train
    step at --nheads `nheads` (the batched kernel and the backward kernel at
    that head_dim) against its plain run, with the train phase's
    tolerances."""
    import dataclasses

    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(dataclasses.replace(_model_config(), nheads=nheads)).cuda().eval()
    step = make_eval_step(model, _encode_batch, torch.bfloat16)
    batch = make_eval_batch(0)
    reset_launches()
    got = step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    with kernels.pallas_scope("off"):
        off = step(batch)
    want = expected_launches(CHARADES_LAUNCHES["auto"], 1)
    ev = {"launches": launches, "launches_expected": want, "vs_off_bf16": _pred_err(got, off),
          "finite": all(bool(torch.isfinite(x.float()).all()) for x in got.values()),
          "tol": MODEL_TOL}
    ev["ok"] = bool(launches == want and ev["finite"] and max(ev["vs_off_bf16"].values()) <= MODEL_TOL)
    del model, step

    cfg = dataclasses.replace(_tacos_config(dropout=0.0), nheads=nheads)
    torch.manual_seed(0)
    init = MESM(cfg).state_dict()
    ccfg = CriterionConfig(**TACOS_CRITERION)
    tbatch = make_train_batch(0, TACOS["B"], TACOS["Lv"], TACOS["Dv"], TACOS["Lw"], TACOS["Dt"],
                              cfg.num_classes)
    first = {}
    for mode in ("auto", "off"):
        m = MESM(cfg)
        m.load_state_dict(init)
        reset_launches()
        first[mode] = _first_grads(m.cuda(), ccfg, tbatch, mode)
        torch.cuda.synchronize()
        first[mode] += (read_launches(),)
    (loss_a, g_a, launches_a), (loss_o, g_o, _) = first["auto"], first["off"]
    want = expected_launches({"attention_batched": 2, "attention_trainable": 2,
                              "attention_backward": 2}, 1)
    tr = {"launches": launches_a, "launches_expected": want, "first_loss_auto": loss_a,
          "first_loss_off": loss_o,
          "first_loss_rel_err": abs(loss_a - loss_o) / max(1.0, abs(loss_o)),
          "grad_max_err_rel_to_max1": _grad_err(g_a, g_o),
          "grads_same_params": sorted(g_a) == sorted(g_o),
          "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL}
    tr["ok"] = bool(launches_a == want and tr["grads_same_params"]
                    and tr["first_loss_rel_err"] <= TRAIN_LOSS_TOL
                    and tr["grad_max_err_rel_to_max1"] <= TRAIN_GRAD_TOL)
    return {f"charades_eval_nheads{nheads}": ev, f"tacos_train_nheads{nheads}": tr}


# the --nheads of the head-dim phase's model steps: head_dim 16 and 256
STEP_NHEADS = (16, 1)


def phase_head_dims(card: str) -> dict:
    """The head-dim domain on the card: check_head_dims, time_head_dims
    (each timed case held against its plain version first) and the eval and
    train steps at each STEP_NHEADS."""
    cases = check_head_dims()
    timed = time_head_dims()
    res = {"phase": "head_dims", "card": card, "cases": cases, "timed": timed}
    for nheads in STEP_NHEADS:
        res.update(_nheads_step_checks(card, nheads))
    res["ok"] = bool(all(c["ok"] for c in cases + timed) and all(
        res[f"{kind}_nheads{n}"]["ok"] for n in STEP_NHEADS
        for kind in ("charades_eval", "tacos_train")))
    res["failed"] = [c for c in cases + timed if not c["ok"]]
    emit(res)
    if not res["ok"]:
        raise SystemExit("head-dim phase: a check failed")
    return res


def phase_kernels() -> dict:
    """Every kernel against its plain version at its main paths' shapes,
    timed; each check names the kernel summary's entry it stands for."""
    results = []
    for dtype_name in ("bfloat16", "float32"):
        for relu in (True, False):
            # the main path runs bf16 with ReLU (input_vid_proj.block0)
            main = dtype_name == "bfloat16" and relu
            results.append(check_ln_dense(dtype_name, relu, time_it=(relu or dtype_name == "float32"),
                                          summary="ln_dense" if main else None))
    # the TACoS eval input projection: fp32, 6 videos x 600 clips of 4098
    results.append(check_ln_dense("float32", True, time_it=True, N=6 * TACOS["Lv"], D=TACOS["Dv"]))
    # the coalesced eval's hoisted projection (phase coalesce): the unique
    # videos of K charades batches in one launch
    results.append(check_ln_dense("bfloat16", True, time_it=True, N=COALESCE["K"] * 53 * 194,
                                  summary="ln_dense_hoisted"))
    # the edges of its tiles and its domain (any N, D, F), untimed, and its
    # rows' independence of their address
    results.extend(check_ln_dense_edges())
    results.append(check_ln_dense_alignment())
    # the DETR encoder's self-attention: charades bf16 (128 x 195), TACoS
    # fp32 eval (16 x 601) and stacked train (32 x 601); the bf16 batched
    # and fp32 packed instances, and the per-head and all-heads layouts, are
    # what MESM_ATTN_VARIANT sends there; the summary takes per_head fp32 at
    # the train step's shape, all_heads at the eval step's
    B16, L16, B32, L32 = MAIN_PATH["B"], MAIN_PATH["L"], TACOS["B"], TACOS["L"]
    results.append(check_encoder_attention("attention_packed", "bfloat16", B16, L16, "attention_packed"))
    for B in (B32, 2 * B32):  # eval, and the stacked train pass
        results.append(check_encoder_attention("attention_batched", "float32", B, L32,
                                               "attention_batched" if B == 2 * B32 else None))
    results.extend(check_attention_trainable())
    # the fp32 body of kernels 2, 6, 7 and 8 at 16 and 32 rows and head_dim
    # 16, 32, 128 and 256, beside the register tiles' times and SDPA's
    results.extend(check_fp32_body())
    for name in ("attention_per_head", "attention_all_heads"):
        results.append(check_encoder_attention(name, "bfloat16", B16, L16, name))
        for B in (B32, 2 * B32):
            main = (B == 2 * B32) == (name == "attention_per_head")
            results.append(check_encoder_attention(name, "float32", B, L32,
                                                   f"{name}_float32" if main else None))
    check_encoder_edges()
    results.append(check_encoder_attention("attention_batched", "bfloat16", B16, L16,
                                           "attention_batched_bfloat16"))
    results.append(check_encoder_attention("attention_packed", "float32", B32, L32,
                                           "attention_packed_float32"))
    # the short-key kernels at their sites; the summary takes the QVH site
    # with the pair mask
    for name in ("attention_shortkey", "attention_shortkey_onematmul"):
        for site, B, Lq, Lk, pair in SHORT_KEY_SITES:
            results.append(check_pair_attention(name, site, B, Lq, Lk, pair,
                                                summary=name if site == "qvh" and pair else None))
    # both short-key kernels in fp32 at the fp32 sites (FP32_SHORT_KEY_SITES),
    # with and without pair factors; the summary takes TACoS with the pair
    # mask: the one-matmul kernel is what "auto" with SHORTKEY_VARIANT
    # "kernel" launches there (phase tacos_eval), the short-key kernel what
    # "on" under MESM_ATTN_VARIANT=packed launches (phase attn_variants)
    for name in ("attention_shortkey", "attention_shortkey_onematmul"):
        for site, B, Lq, Lk in FP32_SHORT_KEY_SITES:
            for pair in (True, False):
                results.append(check_pair_attention(
                    name, site, B, Lq, Lk, pair, "float32",
                    summary=f"{name}_float32" if site == "tacos" and pair else None))
    results.append(check_pair_attention("attention_packed_pair", *LONG_KEY_SITE,
                                        summary="attention_packed_pair"))
    # the fp32 instances of the pair and short-key kernels (MESM_ATTN_VARIANT
    # packed, "on"): charades with long queries, and TACoS
    results.append(check_pair_attention("attention_packed_pair", *LONG_KEY_SITE, dtype_name="float32",
                                        summary="attention_packed_pair_float32"))
    # the fused int8 FFN at the charades (bf16, 128 x 195 rows) and TACoS
    # (fp32, 16 x 600) FFN sites
    results.append(check_ffn_int8("charades", "bfloat16", B16 * L16, "ffn_int8"))
    results.append(check_ffn_int8("tacos", "float32", B32 * TACOS["Lv"], "ffn_int8_float32"))
    # the fused stream layer on the bench entry point's inputs, both flavours
    # and dtypes; the layout anchor in each of its layouts, the summary on
    # the slice the stream_layer phase copies
    for flavor in ("encoder", "t2v"):
        for dtype_name, suffix in (("bfloat16", ""), ("float32", "_float32")):
            results.append(check_stream_layer(flavor, dtype_name, f"stream_layer_{flavor}{suffix}"))
    for layout in ANCHOR_LAYOUTS:
        results.append(check_layout_anchor(layout, "layout_anchor" if layout == "slice" else None))
    out = {"phase": "kernels", "ok": True, "results": results}
    emit(out)
    return out


def _model_config():
    """charades C+SF_C at full width and depth (scripts/synthetic.charades_config)."""
    from mesm_tpu_torch.scripts import synthetic

    return synthetic.charades_config()


def make_eval_batch(seed: int, B=128, NG=53, Lv=194, Dv=2818, Lw=16, Dt=512, min_words=3,
                    G=None):
    """A collated eval batch on the card (scripts/synthetic.make_eval_batch)."""
    from mesm_tpu_torch.scripts import synthetic

    return synthetic.make_eval_batch(seed, B, NG, Lv, Dv, Lw, Dt, min_words, device="cuda", G=G)


def _tacos_config(dropout: float = 0.1):
    """TACoS C3D_GloVe at full width and depth (scripts/synthetic.tacos_config)."""
    from mesm_tpu_torch.scripts import synthetic

    return synthetic.tacos_config(dropout=dropout)


# criterion weights (config/TACoS/C3D_GloVe.json, config/charades/C+SF_C.json)
TACOS_CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=6.0, saliency_coef=1.0,
                       recfw_coef=0.1, recss_coef=0.1, cost_span=10.0, cost_giou=1.0,
                       cost_class=6.0, rank_coef=1.0, use_triplet=True)
CHARADES_CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=4.0,
                          recfw_coef=0.1, recss_coef=0.1, cost_span=10.0, cost_giou=1.0,
                          cost_class=4.0, rank_coef=12.0)
TRAIN_SEED = 2019


def make_train_batch(seed: int, B: int, Lv: int, Dv: int, Lw: int, Dt: int, num_classes: int,
                     G: int = 3) -> dict:
    """A collated train batch on the card (scripts/synthetic.make_train_batch)."""
    from mesm_tpu_torch.scripts import synthetic

    return synthetic.make_train_batch(seed, B, Lv, Dv, Lw, Dt, num_classes, G, device="cuda")


def _pred_err(a, b):
    import torch

    out = {}
    for k in a:
        x, y = a[k].float(), b[k].float()
        out[k] = float(((x - y).abs() / torch.clamp(y.abs().max(), min=1.0)).max())
    return out


def _launch_counters():
    """Each kernel's launch counter: (module, attribute)."""
    from mesm_tpu_torch.ops import (anchor, attention_backward, attention_batched, attention_heads,
                                    attention_packed, attention_shortkey, attention_trainable,
                                    ffn_int8, ln_dense, stream_layer)

    return {"ln_dense": (ln_dense, "launches"), "attention_packed": (attention_packed, "launches"),
            "attention_batched": (attention_batched, "launches"),
            "attention_trainable": (attention_trainable, "launches"),
            "attention_backward": (attention_backward, "backward_launches"),
            "attention_packed_pair": (attention_packed, "pair_launches"),
            "attention_shortkey": (attention_shortkey, "launches"),
            "attention_shortkey_onematmul": (attention_shortkey, "onematmul_launches"),
            "attention_per_head": (attention_heads, "per_head_launches"),
            "attention_all_heads": (attention_heads, "all_heads_launches"),
            "ffn_int8": (ffn_int8, "launches"), "stream_layer": (stream_layer, "launches"),
            "layout_anchor": (anchor, "launches")}


def reset_launches():
    for mod, attr in _launch_counters().values():
        setattr(mod, attr, 0)


def read_launches():
    return {name: getattr(mod, attr) for name, (mod, attr) in _launch_counters().items()}


def expected_launches(per_batch: dict, n: int) -> dict:
    """Every kernel's expected count over n batches or steps (0 where unnamed)."""
    return {name: per_batch.get(name, 0) * n for name in _launch_counters()}


@contextlib.contextmanager
def dispatch_mode(mode: str):
    """The kernel dispatch mode of a run: "off", "auto", "on", or
    "auto+kernel" ("auto" with kernels.SHORTKEY_VARIANT = "kernel": the
    short-key sites launch the one-matmul kernel)."""
    from mesm_tpu_torch import kernels

    variant = kernels.SHORTKEY_VARIANT
    if mode == "auto+kernel":
        kernels.SHORTKEY_VARIANT = "kernel"
    try:
        with kernels.pallas_scope("auto" if mode == "auto+kernel" else mode):
            yield
    finally:
        kernels.SHORTKEY_VARIANT = variant


@contextlib.contextmanager
def attn_variant(variant: str):
    """MESM_ATTN_VARIANT set for the run, as a user sets it."""
    from mesm_tpu_torch import kernels

    old = os.environ.get(kernels.ATTN_VARIANT_ENV)
    os.environ[kernels.ATTN_VARIANT_ENV] = variant
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(kernels.ATTN_VARIANT_ENV)
        else:
            os.environ[kernels.ATTN_VARIANT_ENV] = old


@contextlib.contextmanager
def int8_ffn(enabled: bool = True):
    """kernels.set_int8_ffn for the run, restored after."""
    from mesm_tpu_torch import kernels

    old = kernels.INT8_FFN
    kernels.set_int8_ffn(enabled)
    try:
        yield
    finally:
        kernels.set_int8_ffn(old)


@contextlib.contextmanager
def ffn_plain_route():
    """The int8 FFN sites sent to ffn_int8_reference (the plain version, on
    the card): the reference the model with the kernel is held against."""
    from mesm_tpu_torch.models import layers
    from mesm_tpu_torch.ops.ffn_int8 import ffn_int8_reference

    orig = layers.ffn_int8
    layers.ffn_int8 = ffn_int8_reference
    try:
        yield
    finally:
        layers.ffn_int8 = orig


def drive_modes(step, batches, per_batch: dict, n_batches: int, refs: dict, tol: float = MODEL_TOL):
    """n_batches eval steps in each dispatch mode of `per_batch`, the launch
    counts set to 0 just before and read just after each mode's run; the
    first batch's predictions against each reference (within `tol`).
    Returns ({mode: report}, all ok)."""
    import torch

    report, ok = {}, True
    for mode, expect in per_batch.items():
        with dispatch_mode(mode):
            reset_launches()
            outs = [step(batches[i % len(batches)]) for i in range(n_batches)]
            torch.cuda.synchronize()
            launches = read_launches()
        want = expected_launches(expect, n_batches)
        r = {"launches": launches, "launches_expected": want,
             "finite": all(bool(torch.isfinite(v.float()).all()) for o in outs for v in o.values())}
        for name, ref in refs.items():
            r[f"vs_{name}"] = _pred_err(outs[0], ref)
        r["ok"] = bool(launches == want and r["finite"] and all(
            max(r[f"vs_{name}"].values()) <= tol for name in refs))
        report[mode] = r
        ok = ok and r["ok"]
    return report, ok


def rows_per_s(step, batches, mode: str, iters: int) -> float:
    """Rows per second of the eval step in one dispatch mode: host clock
    around `iters` synchronised steps after a warm-up over the batches."""
    import torch

    B = batches[0]["video_mask"].shape[0]
    with dispatch_mode(mode):
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
        return B * iters / (time.perf_counter() - t0)


def phase_model(card: str, n_batches: int = 4) -> dict:
    """The port's eval step at the bench geometry, bf16, seeded weights."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(_model_config()).cuda().eval()

    def encode(b):
        return b["cached_words_feat"], b["cached_words_mask"], b["cached_sentence_feat"]

    step16 = make_eval_step(model, encode, torch.bfloat16)
    step32 = make_eval_step(model, encode, torch.float32)
    batches = [make_eval_batch(s) for s in range(2)]
    B = batches[0]["video_mask"].shape[0]

    reset_launches()
    outs = [step16(batches[i % 2]) for i in range(n_batches)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_launches(CHARADES_LAUNCHES["auto"], n_batches)
    res = {"phase": "model", "batches": n_batches, "rows_per_batch": B,
           "launches": launches, "launches_expected": want}
    shapes_ok = (
        tuple(outs[0]["scores"].shape) == (B, 10)
        and tuple(outs[0]["pred_spans"].shape) == (B, 10, 2)
        and tuple(outs[0]["saliency_scores"].shape) == (B, 194)
    )
    finite = all(bool(torch.isfinite(v.float()).all()) for o in outs for v in o.values())
    with kernels.pallas_scope("off"):
        off = step16(batches[0])
        ref32 = step32(batches[0])
    res["kernels_vs_off_bf16"] = _pred_err(outs[0], off)
    res["bf16_vs_fp32_off"] = _pred_err(outs[0], ref32)
    res["tol"] = MODEL_TOL
    res["shapes_ok"], res["finite"] = shapes_ok, finite
    ok = (
        launches == want and shapes_ok and finite
        and max(res["kernels_vs_off_bf16"].values()) <= MODEL_TOL
        and max(res["bf16_vs_fp32_off"].values()) <= MODEL_TOL
    )

    res["modes"], modes_ok = drive_modes(
        step16, batches, {m: CHARADES_LAUNCHES[m] for m in ("on", "auto+kernel")}, n_batches,
        {"off_bf16": off, "fp32_off": ref32},
    )
    ok = ok and modes_ok

    torch.cuda.reset_peak_memory_stats()
    turns = [(m, rows_per_s(step16, batches, m, 10))
             for m in ("auto", "off", "on", "auto+kernel", "auto+kernel", "on", "off", "auto")]
    for mode in ("auto", "off", "on", "auto+kernel"):
        res[f"rows_per_s_{mode}"] = [r for m, r in turns if m == mode]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["profile"] = profile_step(step16, batches)
    with dispatch_mode("auto+kernel"):
        res["profile_auto_kernel"] = profile_step(step16, batches)
    res["card"] = card
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise SystemExit("model phase failed")
    return res


def _encode_batch(b):
    if "cached_words_feat" in b:
        return b["cached_words_feat"], b["cached_words_mask"], b["cached_sentence_feat"]
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def phase_tacos_eval(card: str, n_batches: int = 4) -> dict:
    """The port's eval step at the TACoS geometry (bench.py:753-754), fp32:
    the fp32 attention tier (16 rows, 601 keys) and the 4098-wide fused
    LayerNorm -> Dense; then "auto+kernel" (TACOS_LAUNCHES), whose 4 T2V /
    enhance sites (600 video queries x 17 text keys) launch the fp32
    one-matmul kernel, its predictions against "off"."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(_tacos_config()).cuda().eval()
    step = make_eval_step(model, _encode_batch, torch.float32)
    B, Lv = TACOS["B"], TACOS["Lv"]
    batches = _tacos_eval_batches()
    reset_launches()
    outs = [step(batches[i % 2]) for i in range(n_batches)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_launches(TACOS_LAUNCHES["auto"], n_batches)
    with kernels.pallas_scope("off"):
        off = step(batches[0])
    res = {"phase": "tacos_eval", "batches": n_batches, "rows_per_batch": B, "launches": launches,
           "launches_expected": want, "kernels_vs_off_fp32": _pred_err(outs[0], off),
           "tol": FP32_MODEL_TOL}
    res["shapes_ok"] = tuple(outs[0]["saliency_scores"].shape) == (B, Lv)
    res["finite"] = all(bool(torch.isfinite(v.float()).all()) for o in outs for v in o.values())
    res["modes"], modes_ok = drive_modes(step, batches, {"auto+kernel": TACOS_LAUNCHES["auto+kernel"]},
                                         n_batches, {"off_fp32": off}, tol=FP32_MODEL_TOL)

    def rows_per_s(mode, iters=6):
        with dispatch_mode(mode):
            step(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                step(batches[i % 2])
            torch.cuda.synchronize()
            return B * iters / (time.perf_counter() - t0)

    turns = [(m, rows_per_s(m)) for m in ("auto", "off", "auto+kernel", "auto+kernel", "off",
                                          "auto")]
    res["rows_per_s_kernels_auto"] = [r for m, r in turns if m == "auto"]
    res["rows_per_s_kernels_off"] = [r for m, r in turns if m == "off"]
    res["rows_per_s_kernels_auto_kernel"] = [r for m, r in turns if m == "auto+kernel"]
    res["card"] = card
    res["ok"] = bool(launches == want and res["shapes_ok"] and res["finite"] and modes_ok
                     and max(res["kernels_vs_off_fp32"].values()) <= FP32_MODEL_TOL)
    emit(res)
    if not res["ok"]:
        raise SystemExit("tacos_eval phase failed")
    return res


def _qvh_config(dropout: float = 0.1):
    from mesm_tpu_torch.models.mesm import MESMConfig

    # QVHighlights C+SF_C (config/QVHighlights/C+SF_C.json) at full width and
    # depth: 2816 + 2 TEF video channels, 75 clips, 32 words, cached 512-d
    # text; the MLM head is the CLIP tokenizer's (vocab_size 5000 + 3)
    return MESMConfig(
        hidden_dim=256, v_feat_dim=QVH["Dv"], t_feat_dim=QVH["Dt"], nheads=8, dim_feedforward=1024,
        num_recfw_layers=2, t2v_layers=2, enc_layers=2, dec_layers=2, num_recss_layers=4,
        num_queries=10, max_words_l=QVH["Lw"], max_video_l=QVH["Lv"], num_classes=5003,
        dropout=dropout,
    )


# criterion weights (config/QVHighlights/C+SF_C.json)
QVH_CRITERION = dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=1.0,
                     recfw_coef=0.5, recss_coef=0.1, cost_span=10.0, cost_giou=1.0,
                     cost_class=4.0, rank_coef=12.0, use_triplet=True, multi_clip=True)


def make_qvh_host_batch(seed: int, B: int, NG: int, with_targets: bool = False) -> dict:
    """A collated QVHighlights batch on the host, as data/collate.py lays it
    out: each row its own clip (most 150 s long: 75 clips), rows grouped by
    YouTube video (at most QVH["G"] a group), each group's clips
    concatenated once as the SS-MESM video with the rows' group slots,
    cached 512-d text; with targets, up to 5 windows per row, 3-annotator
    saliency sums, the triplet's clip indices and MLM labels. Features from
    a seed; staging (data/pipeline.stage_batch) expands the group video."""
    import numpy as np

    G, Lv, Dv, Lw, Dt, T = QVH["G"], QVH["Lv"], QVH["Dv"], QVH["Lw"], QVH["Dt"], QVH["T"]
    rng = np.random.default_rng(seed)
    counts = np.ones(NG, np.int64)
    while counts.sum() < B:
        i = int(rng.integers(NG))
        if counts[i] < G:
            counts[i] += 1
    group_id = np.repeat(np.arange(NG), counts)
    vlen = np.where(rng.random(B) < 0.8, Lv, rng.integers(Lv // 3, Lv, B))
    video_mask = np.arange(Lv)[None] < vlen[:, None]
    video = rng.standard_normal((B, Lv, Dv), dtype=np.float32) * video_mask[..., None]
    Lss = G * Lv
    ss_feat = np.zeros((NG, Lss, Dv), np.float32)
    ss_mask = np.zeros((NG, Lss), bool)
    ss_idx, ss_smask, own = np.zeros((B, G), np.int64), np.zeros((B, G), bool), np.zeros(B, np.int64)
    for g in range(NG):
        rows = np.flatnonzero(group_id == g)
        cat = np.concatenate([video[r, : vlen[r]] for r in rows])
        ss_feat[g, : len(cat)], ss_mask[g, : len(cat)] = cat, True
        for pos, r in enumerate(rows):
            ss_idx[r, : len(rows)], ss_idx[r, len(rows):] = rows, r
            ss_smask[r, : len(rows)] = True
            own[r] = pos
    w_len = rng.integers(4, Lw + 1, B)
    words_mask = np.arange(Lw)[None] < w_len[:, None]
    batch = {
        "video_feat": video, "video_mask": video_mask,
        "cached_words_feat": 0.1 * rng.standard_normal((B, Lw, Dt), dtype=np.float32) * words_mask[..., None],
        "cached_words_mask": words_mask,
        "cached_sentence_feat": 0.1 * rng.standard_normal((B, Dt), dtype=np.float32),
        "ss_sent_idx": ss_idx, "ss_sent_mask": ss_smask, "ss_own_pos": own, "group_id": group_id,
        "ss_video_feat_groups": ss_feat, "ss_video_mask_groups": ss_mask, "ss_group_slot": group_id,
        "row_mask": np.ones(B, bool),
    }
    if with_targets:
        n_win = rng.integers(1, T + 1, B)
        tgt_mask = np.arange(T)[None] < n_win[:, None]
        st = rng.integers(0, np.maximum(vlen - 6, 1)[:, None], (B, T))
        ed = np.minimum(st + rng.integers(1, 15, (B, T)), vlen[:, None])
        moment = np.stack([st / vlen[:, None], ed / vlen[:, None]], -1) * tgt_mask[..., None]
        span = np.stack([moment.mean(-1), moment[..., 1] - moment[..., 0]], -1)
        clip = np.zeros((B, Lv), bool)
        for r in range(B):
            for t in np.flatnonzero(tgt_mask[r]):
                clip[r, st[r, t]: ed[r, t]] = True
        saliency = np.where(clip, rng.integers(1, 13, (B, Lv)), 0).astype(np.float32)
        def pick(cands):  # two clip indices out of cands (clip 0 if there is none)
            cands = np.flatnonzero(cands)
            return cands[rng.integers(len(cands), size=2)] if len(cands) else np.zeros(2, np.int64)

        pos = np.stack([pick(c) for c in clip])
        neg = np.stack([pick(~c & m) for c, m in zip(clip, video_mask)])
        batch.update(
            norm_moment=moment.astype(np.float32), norm_span=span.astype(np.float32),
            tgt_mask=tgt_mask, saliency_label=saliency, clip_mask=clip, pos_idx=pos, neg_idx=neg,
            words_weight=(rng.integers(1, 3, (B, Lw)) * words_mask).astype(np.float32),
            unknown_mask=(rng.random((B, Lw)) < 0.1) & words_mask,
            words_label=rng.integers(0, 5003, (B, Lw)) * words_mask,
        )
    return batch


def phase_qvh_eval(card: str, n_batches: int = 2) -> dict:
    """QVHighlights C+SF_C bf16 inference at full width and depth through
    the port's staging and eval step, in every dispatch mode: "off",
    "auto", "auto+kernel" (the one-matmul short-key kernel at the 4 T2V /
    enhance sites) and "on" (the packed short-key kernel there, the packed
    kernel in the 76 x 76 DETR encoder), each against "off" and against fp32
    "off"; rows/s per mode and a device-time profile under "on"."""
    import torch

    from mesm_tpu_torch.data.pipeline import stage_batch
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(_qvh_config()).cuda().eval()
    step16 = make_eval_step(model, _encode_batch, torch.bfloat16)
    step32 = make_eval_step(model, _encode_batch, torch.float32)
    B, NG, Lv = QVH["B"], QVH["NG"], QVH["Lv"]
    hosts = [make_qvh_host_batch(s, B, NG) for s in range(2)]
    batches = [stage_batch(h, True, "cuda") for h in hosts]
    with dispatch_mode("off"):
        off = step16(batches[0])
        ref32 = step32(stage_batch(hosts[0], False, "cuda"))
    torch.cuda.synchronize()
    res = {"phase": "qvh_eval", "batches_per_mode": n_batches, "rows_per_batch": B,
           "groups_per_batch": NG, "ss_video_len": QVH["G"] * Lv, "tol": MODEL_TOL,
           "shapes_ok": (tuple(off["scores"].shape) == (B, 10)
                         and tuple(off["pred_spans"].shape) == (B, 10, 2)
                         and tuple(off["saliency_scores"].shape) == (B, Lv)),
           "fp32_finite": all(bool(torch.isfinite(v).all()) for v in ref32.values())}
    res["modes"], ok = drive_modes(step16, batches, QVH_LAUNCHES, n_batches,
                                   {"off_bf16": off, "fp32_off": ref32})
    turns = [(m, rows_per_s(step16, batches, m, 6))
             for m in ("off", "auto", "auto+kernel", "on", "on", "auto+kernel", "auto", "off")]
    for mode in QVH_LAUNCHES:
        res[f"rows_per_s_{mode}"] = [r for m, r in turns if m == mode]
    for mode in ("auto", "on"):
        with dispatch_mode(mode):
            res[f"profile_{mode}"] = profile_step(step16, batches)
    res["card"] = card
    res["ok"] = bool(ok and res["shapes_ok"] and res["fp32_finite"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("qvh_eval phase failed")
    return res


def phase_long_query(card: str, n_batches: int = 2) -> dict:
    """The charades model with max_words_l 80 and queries of 64-80 words in
    bf16 under "on": the T2V / enhance sites see 80 and 81 keys with the
    pair mask, so they launch the pair-masked packed kernel (in bf16 on
    its mma body); predictions against "off" and fp32 "off"."""
    import dataclasses

    import torch

    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(dataclasses.replace(_model_config(), max_words_l=80)).cuda().eval()
    step16 = make_eval_step(model, _encode_batch, torch.bfloat16)
    step32 = make_eval_step(model, _encode_batch, torch.float32)
    batches = [make_eval_batch(s, Lw=80, min_words=64) for s in range(2)]
    with dispatch_mode("off"):
        off = step16(batches[0])
        ref32 = step32(batches[0])
    res = {"phase": "long_query", "batches": n_batches, "words": [64, 80], "tol": MODEL_TOL}
    res["modes"], ok = drive_modes(step16, batches, LONG_QUERY_LAUNCHES, n_batches,
                                   {"off_bf16": off, "fp32_off": ref32})
    res["rows_per_s_on"] = rows_per_s(step16, batches, "on", 6)
    res["rows_per_s_off"] = rows_per_s(step16, batches, "off", 6)
    res["card"] = card
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise SystemExit("long_query phase failed")
    return res


def _train_ms_per_step(model, ccfg, batch, mode: str, steps: int, count: bool,
                       profile: bool = False):
    """ms per train step (host clock around synchronised steps, after one
    warm-up step), the launches of the timed steps when `count`, the last
    step's loss, and with `profile` the device time by kernel of `steps`
    more steps (profile_step)."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step

    optimizer = build_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, ccfg, _encode_batch, optimizer, 0.1, TRAIN_SEED)
    with kernels.pallas_scope(mode):
        step(batch, 0)
        torch.cuda.synchronize()
        if count:
            reset_launches()
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            metrics = step(batch, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = read_launches() if count else None
        prof = None
        if profile:
            taken = [steps]

            def one(b):
                taken[0] += 1
                return step(b, taken[0])

            prof = profile_step(one, [batch], iters=steps)
    return ms, launches, float(metrics["loss_overall"]), prof


def _first_grads(model, ccfg, batch, mode: str):
    """The train step's first loss and gradients (TRAIN_SEED's draws) under
    a dispatch mode: (loss, {parameter name: gradient})."""
    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.parallel.step import make_micro_grads, step_draws

    neg_gen, mask_gen = step_draws(TRAIN_SEED, 0, "cuda")
    with kernels.pallas_scope(mode):
        total, _ = make_micro_grads(model, ccfg, _encode_batch)(batch, neg_gen, mask_gen)
    return float(total.detach()), {n: p.grad for n, p in model.named_parameters()
                                   if p.grad is not None}


def _grad_err(g, ref) -> float:
    """The largest gradient difference in units of max(1, max |ref|) over
    all parameters."""
    scale = max(1.0, max(float(x.abs().max()) for x in ref.values()))
    return max(float((g[n] - ref[n]).abs().max()) for n in ref) / scale


def _params_max_diff(a, b) -> float:
    pb = dict(b.named_parameters())
    return max(float((p.detach() - pb[n].detach()).abs().max()) for n, p in a.named_parameters())


def check_grad_accum(fresh, ccfg, batch, per_step_k1: dict, steps: int) -> dict:
    """One grad_accum = 2 train step (two microbatches of B/2 rows, one
    update) against the update on the mean of two single-microbatch
    gradients taken with the same draws from the same parameters; its
    launches against twice the grad_accum = 1 step's; ms/step."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.parallel.step import (apply_update, build_optimizer, make_micro_grads,
                                              make_train_step, split_micro, step_draws)

    model = fresh()
    optimizer = build_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, ccfg, _encode_batch, optimizer, 0.1, TRAIN_SEED, grad_accum=2)
    ref = fresh()
    ref_opt = build_optimizer(ref, 2e-4, 1e-4)
    micro = make_micro_grads(ref, ccfg, _encode_batch)
    with kernels.pallas_scope("auto"):
        reset_launches()
        metrics = step(batch, 0)
        torch.cuda.synchronize()
        launches = read_launches()
        acc = {n: torch.zeros_like(p) for n, p in ref.named_parameters()}
        for i, mb in enumerate(split_micro(batch, 2)):
            ref_opt.zero_grad(set_to_none=True)
            micro(mb, *step_draws(TRAIN_SEED, 0, batch["video_mask"].device, micro=i))
            for n, p in ref.named_parameters():
                if p.grad is not None:
                    acc[n] += p.grad
        for n, p in ref.named_parameters():
            p.grad = acc[n] / 2
        apply_update(ref_opt, 0.1)
        err = _params_max_diff(model, ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            step(batch, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
    want = {name: 2 * per_step_k1[name] for name in ("attention_batched", "attention_trainable",
                                                      "attention_backward")}
    res = {"micro_rows": batch["video_mask"].shape[0] // 2, "launches": launches,
           "launches_expected_twice_k1": want, "params_max_abs_diff_vs_mean_grad_update": err,
           "tol": GRAD_ACCUM_TOL, "loss": float(metrics["loss_overall"]), "ms_per_step": ms}
    res["ok"] = bool(all(launches[n] == w for n, w in want.items()) and err <= GRAD_ACCUM_TOL
                     and math.isfinite(res["loss"]))
    return res


def check_bf16_train(fresh, ccfg, batch, steps: int) -> dict:
    """bf16 training at the kernel-engaged TACoS geometry: `steps` train
    steps with float32 parameters and AdamW state, the DETR encoder's
    self-attention on kernel 2 through attention_trainable (its backward
    recomputed), finite losses; the step-0 loss against the fp32 step's
    from the same init and draws (tests/test_bf16_train.py:85's bound);
    ms/step. `fresh` gives models without dropout: torch draws other
    dropout masks for bf16 tensors than for fp32 ones (JAX draws the
    same), which would move the two losses apart by more than rounding."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.parallel.step import (build_optimizer, make_micro_grads, make_train_step,
                                              step_draws)

    ref = fresh()
    with kernels.pallas_scope("auto"):
        fp32_first_loss = float(make_micro_grads(ref, ccfg, _encode_batch)(
            batch, *step_draws(TRAIN_SEED, 0, batch["video_mask"].device))[0])
    del ref
    model = fresh()
    optimizer = build_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, ccfg, _encode_batch, optimizer, 0.1, TRAIN_SEED,
                           compute_dtype=torch.bfloat16)
    with kernels.pallas_scope("auto"):
        reset_launches()
        losses = [float(step(batch, i)["loss_overall"]) for i in range(steps)]
        torch.cuda.synchronize()
        launches = read_launches()
        t0 = time.perf_counter()
        for i in range(steps, 2 * steps):
            step(batch, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        taken = [2 * steps]

        def one(b):
            taken[0] += 1
            return step(b, taken[0])

        prof = profile_step(one, [batch], iters=steps, top=8)
    want = expected_launches({"attention_packed": 2, "attention_trainable": 2}, steps)
    state_dtypes = sorted({str(t.dtype) for st in optimizer.state.values()
                           for t in (st["exp_avg"], st["exp_avg_sq"])})
    res = {"steps": steps, "losses": losses, "launches": launches, "launches_expected": want,
           "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
           "adamw_state_dtypes": state_dtypes, "fp32_first_loss": fp32_first_loss,
           "first_loss_rel_err_vs_fp32": abs(losses[0] - fp32_first_loss) / abs(fp32_first_loss),
           "tol": BF16_TRAIN_TOL, "ms_per_step": ms, "profile": prof}
    res["ok"] = bool(launches == want and res["param_dtypes"] == ["torch.float32"]
                     and state_dtypes == ["torch.float32"]
                     and all(math.isfinite(x) for x in losses)
                     and res["first_loss_rel_err_vs_fp32"] <= BF16_TRAIN_TOL)
    return res


def check_eval_loss(fresh, ccfg, batch) -> dict:
    """The trainer's eval step (with the loss: the negative pass and every
    loss term) at the TACoS geometry in fp32, kernels "auto" against "off":
    the 4098-wide ln_dense and the fp32 batched attention kernel."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.parallel.step import make_eval_step

    model = fresh().eval()
    step = make_eval_step(model, _encode_batch, torch.float32, ccfg, with_loss=True,
                          seed=TRAIN_SEED)
    with kernels.pallas_scope("auto"):
        reset_launches()
        preds, losses = step(batch)
        torch.cuda.synchronize()
        launches = read_launches()
    with kernels.pallas_scope("off"):
        preds_off, losses_off = step(batch)
    want = expected_launches({"ln_dense": 1, "attention_batched": 2}, 1)
    loss_err = max(abs(float(losses[k]) - float(losses_off[k])) / max(1.0, abs(float(losses_off[k])))
                   for k in losses_off)
    res = {"launches_per_batch": launches, "launches_expected": want,
           "loss_overall": float(losses["loss_overall"]), "n_loss_terms": len(losses),
           "loss_max_err_vs_off": loss_err, "preds_vs_off": _pred_err(preds, preds_off),
           "tol": FP32_MODEL_TOL}
    res["ok"] = bool(launches == want and loss_err <= FP32_MODEL_TOL
                     and max(res["preds_vs_off"].values()) <= FP32_MODEL_TOL
                     and all(math.isfinite(float(v)) for v in losses.values()))
    return res


def phase_train(card: str, steps: int = 4) -> dict:
    """The train step: the kernel-engaged TACoS fp32 step (bench.py:780-795:
    B = 16, attention dropout 0, input dropout 0.5 as shipped) with the
    kernels "auto" and "off" from one init and the same draws, then the
    charades C+SF_C fp32 step at B = 32 with dropout 0.1 as shipped."""
    import torch

    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models.mesm import MESM

    cfg = _tacos_config(dropout=0.0)
    torch.manual_seed(0)
    init = MESM(cfg).state_dict()
    ccfg = CriterionConfig(**TACOS_CRITERION)
    batch = make_train_batch(0, TACOS["B"], TACOS["Lv"], TACOS["Dv"], TACOS["Lw"], TACOS["Dt"],
                             cfg.num_classes)

    def fresh():
        model = MESM(cfg)
        model.load_state_dict(init)
        return model.cuda()

    # the first step's loss and gradients with the kernels and without, and
    # without them on features moved by 1e-7 (relative): the noise floor
    perturbed = dict(batch)
    noise = torch.randn(batch["video_feat"].shape, generator=torch.Generator(device="cuda").manual_seed(9),
                        device="cuda")
    perturbed["video_feat"] = batch["video_feat"] * (1 + 1e-7 * noise)
    del noise
    first = {name: _first_grads(fresh(), ccfg, b, mode)
             for name, mode, b in (("auto", "auto", batch), ("off", "off", batch),
                                   ("floor", "off", perturbed))}
    torch.cuda.synchronize()
    (loss_a, g_a), (loss_o, g_o), (_, g_f) = first["auto"], first["off"], first["floor"]
    res = {"phase": "train", "card": card, "tacos": {
        "rows": TACOS["B"], "stacked_rows": 2 * TACOS["B"], "first_loss_auto": loss_a,
        "first_loss_off": loss_o, "first_loss_rel_err": abs(loss_a - loss_o) / max(1.0, abs(loss_o)),
        "grad_max_abs": max(float(g.abs().max()) for g in g_o.values()),
        "grad_max_err_rel_to_max1": _grad_err(g_a, g_o),
        "grad_noise_floor_rel_to_max1": _grad_err(g_f, g_o),
        "grad_max_err_rel_to_own_max1_per_param": max(_rel_err(g_a[n], g_o[n]) for n in g_o),
        "grad_noise_floor_rel_to_own_max1_per_param": max(_rel_err(g_f[n], g_o[n]) for n in g_o),
        "grads_same_params": sorted(g_a) == sorted(g_o),
        "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
    }}
    del first, g_a, g_o, g_f, perturbed
    turns = []
    for mode in ("auto", "off", "off", "auto"):
        first_turn = not turns
        ms, launches, loss, prof = _train_ms_per_step(fresh(), ccfg, batch, mode, steps,
                                                      count=first_turn, profile=first_turn)
        turns.append((mode, ms, loss))
        if first_turn:
            res["tacos"]["launches"], res["tacos"]["profile"] = launches, prof
    t = res["tacos"]
    t["steps_per_turn"] = steps
    t["ms_per_step_kernels_auto"] = [ms for m, ms, _ in turns if m == "auto"]
    t["ms_per_step_kernels_off"] = [ms for m, ms, _ in turns if m == "off"]
    t["last_loss"] = [loss for _, _, loss in turns]
    per_step = {"attention_batched": 2, "attention_trainable": 2, "attention_backward": 2}
    want = expected_launches(per_step, steps)
    t["launches_expected"] = want
    ok_tacos = (t["launches"] == want and t["grads_same_params"]
                and t["first_loss_rel_err"] <= TRAIN_LOSS_TOL
                and t["grad_max_err_rel_to_max1"] <= TRAIN_GRAD_TOL
                and all(math.isfinite(x) for x in t["last_loss"]))
    res["tacos_grad_accum"] = check_grad_accum(fresh, ccfg, batch, per_step, steps)
    def fresh_without_dropout():
        model = MESM(dataclasses.replace(cfg, input_dropout=0.0))
        model.load_state_dict(init)
        return model.cuda()

    res["tacos_bf16"] = check_bf16_train(fresh_without_dropout, ccfg, batch, steps)
    res["tacos_eval_loss"] = check_eval_loss(fresh, ccfg, batch)
    ok_tacos = ok_tacos and all(res[k]["ok"] for k in ("tacos_grad_accum", "tacos_bf16",
                                                       "tacos_eval_loss"))

    # charades C+SF_C as shipped: dropout 0.1, so no attention kernel
    torch.manual_seed(0)
    model = MESM(_model_config()).cuda()
    cbatch = make_train_batch(1, 32, 194, 2818, 16, 512, model.cfg.num_classes)
    torch.cuda.reset_peak_memory_stats()
    ms, launches, loss, prof = _train_ms_per_step(model, CriterionConfig(**CHARADES_CRITERION),
                                                  cbatch, "auto", steps, count=True, profile=True)
    res["charades"] = {"rows": 32, "dropout": 0.1, "ms_per_step": ms, "launches": launches,
                       "last_loss": loss,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "profile": prof}
    res["ok"] = bool(ok_tacos and math.isfinite(loss))
    emit(res)
    if not res["ok"]:
        raise SystemExit("train phase failed")
    return res


@contextlib.contextmanager
def _captured_logs(logger_name: str, level: str = "WARNING"):
    """The messages of `level` and above that `logger_name` logs meanwhile."""
    import logging

    got = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    handler = Keep(level=getattr(logging, level))
    log = logging.getLogger(logger_name)
    log.addHandler(handler)
    try:
        yield got
    finally:
        log.removeHandler(handler)


@contextlib.contextmanager
def _without_tensorboard():
    """`from torch.utils.tensorboard import ...` raises ImportError meanwhile,
    as on a machine without the tensorboard package."""
    name = "torch.utils.tensorboard"
    saved = sys.modules.get(name, False)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is False:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = saved


def _eval_log_losses(line: str) -> dict:
    """{term: value} of an eval log line's [Loss] field."""
    if "[Loss]" not in line:
        return {}
    toks = line.split("[Loss]")[1].split("[Metrics]")[0].split()
    return dict(zip(toks[::2], map(float, toks[1::2])))


def phase_train_cli() -> dict:
    """`python -m mesm_tpu_torch.train` through its train() entry on the
    synthetic charades root at full width (fp32 on the card, one epoch and
    its eval with the loss terms), then `mesm_tpu_torch.evaluate` scoring
    the run's best checkpoint. The run must log its eval loss; it runs with
    torch.utils.tensorboard unimportable, and must warn and go on."""
    import torch

    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.train import train

    with tempfile.TemporaryDirectory(prefix="mesm_chip_train_") as root:
        cfg_path = write_charades_root(root)
        with open(cfg_path) as f:
            cfg = json.load(f)
        # mIoU picks the best checkpoint: a random model's mAP can be 0
        cfg.update(n_epoch=1, stop_score="miou", exp_id="chip_smoke_train")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        reset_launches()
        t0 = time.perf_counter()
        # torch.utils.tensorboard made unimportable: the run must warn and go on
        with _captured_logs("mesm_tpu_torch.train") as warnings, _without_tensorboard():
            run = train(["--config_file", cfg_path, "--device", "cuda", *PER_BATCH])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_launches()
        warned = any("tensorboard unavailable" in w for w in warnings)
        tb = {"import_blocked": True, "warned": warned,
              "log_dir_written": os.path.exists(run["opt"].tensorboard_log_dir),
              "ok": warned and not os.path.exists(run["opt"].tensorboard_log_dir)}
        opt = run["opt"]
        with open(opt.train_log_filepath) as f:
            train_log = f.read().strip().splitlines()
        with open(opt.eval_log_filepath) as f:
            eval_log = f.read().strip().splitlines()
        eval_cfg = os.path.join(root, "eval.json")
        with open(eval_cfg, "w") as f:
            json.dump({
                "ann_path": opt.ann_path, "feat_files": opt.feat_files,
                "text_model_path": opt.text_model_path, "bpe_path": "",
                "trained_result_dir": opt.result_dir, "inference_id": "chip_smoke_trained",
                "inference_result_dir": os.path.join(root, "inference"), "num_workers": 4,
            }, f)
        t0 = time.perf_counter()
        metrics, _ = inference(["--config_file", eval_cfg, "--device", "cuda", *PER_BATCH])
        loss_terms = _eval_log_losses(eval_log[-1]) if eval_log else {}
        res = {"phase": "train_cli", "train_s": train_s, "steps": run["step"],
               "launches": launches, "train_log_last": train_log[-1] if train_log else None,
               "eval_loss": loss_terms, "tensorboard": tb,
               "best_ckpt": os.path.exists(os.path.join(opt.result_dir, "model_test_best.ckpt")),
               "evaluate_s": time.perf_counter() - t0, "brief": metrics["brief"]}
        res["ok"] = bool(run["step"] > 0 and res["best_ckpt"] and res["brief"]
                         and res["brief"].get("MR-full-miou") is not None
                         and math.isfinite(loss_terms.get("loss_overall", math.nan))
                         and tb["ok"])
        emit(res)
        if not res["ok"]:
            raise SystemExit("train_cli phase failed")
    return res


# the public CLIP ViT-B/32 text tower (heads = width // 64, as both
# packages' build_clip_text_encoder infer them); Charades-STA's test split holds 3,720 sentences
CLIP_TEXT = dict(width=512, layers=12, context=77, vocab=49408, embed=512)
CHARADES_TEST_SENTENCES = 3720
CLIP_CHUNK = 256
CLIP_FP32_TOL, CLIP_BF16_TOL = 1e-4, 3e-2


def write_clip_tower(path: str, seed: int = 0) -> None:
    """A fabricated fp16 CLIP text tower at CLIP_TEXT's widths, in the
    upstream key layout of clip_text_encoder.pth (with its three int
    entries), from a seed."""
    import torch

    W, L, E, V = CLIP_TEXT["width"], CLIP_TEXT["context"], CLIP_TEXT["embed"], CLIP_TEXT["vocab"]
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).half()

    sd = {"token_embedding.weight": rnd(V, W, std=0.02), "positional_embedding": rnd(L, W, std=0.01),
          "text_projection": rnd(W, E, std=W**-0.5), "ln_final.weight": rnd(W, std=0.05, mean=1.0),
          "ln_final.bias": rnd(W, std=0.02)}
    for i in range(CLIP_TEXT["layers"]):
        p = f"transformer.resblocks.{i}."
        sd.update({
            p + "ln_1.weight": rnd(W, std=0.05, mean=1.0), p + "ln_1.bias": rnd(W, std=0.02),
            p + "ln_2.weight": rnd(W, std=0.05, mean=1.0), p + "ln_2.bias": rnd(W, std=0.02),
            p + "attn.in_proj_weight": rnd(3 * W, W, std=W**-0.5),
            p + "attn.in_proj_bias": rnd(3 * W, std=0.02),
            p + "attn.out_proj.weight": rnd(W, W, std=W**-0.5),
            p + "attn.out_proj.bias": rnd(W, std=0.02),
            p + "mlp.c_fc.weight": rnd(4 * W, W, std=W**-0.5), p + "mlp.c_fc.bias": rnd(4 * W, std=0.02),
            p + "mlp.c_proj.weight": rnd(W, 4 * W, std=(4 * W)**-0.5),
            p + "mlp.c_proj.bias": rnd(W, std=0.02),
        })
    sd.update(input_resolution=224, context_length=L, vocab_size=V)
    torch.save(sd, path)


def clip_token_ids(n: int, seed: int = 0):
    """n token rows as CLIP's tokenizer lays them out: <|startoftext|>
    (49406), 3-20 word pieces, <|endoftext|> (49407, the largest id: the
    argmax pools it), zeros to the context length."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.zeros((n, CLIP_TEXT["context"]), np.int64)
    for i in range(n):
        k = int(rng.integers(3, 21))
        ids[i, 0] = 49406
        ids[i, 1:k + 1] = rng.integers(1, 49406, k)
        ids[i, k + 1] = 49407
    return ids


def _clip_opt(tower_path: str, max_words_l: int = 32):
    import types

    return types.SimpleNamespace(tokenizer_type="CLIP", text_model_path=tower_path,
                                 max_words_l=max_words_l, normalize_txt=True)


def phase_clip(card: str, tower_path: str) -> dict:
    """The CLIP text tower at the ViT-B/32 text widths, built by the
    runner's build_clip_text_encoder from a fabricated fp16 file: fp32 on the card (TF32
    off) against the same tower on the CPU, bf16 against fp32, one
    CLIP_CHUNK-sentence chunk timed (CUDA events) and a cache pass over
    CHARADES_TEST_SENTENCES sentences through runner.cache_text_features
    (host clock). The tower reaches no kernel, as the JAX one."""
    import types

    import torch

    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.models.text_encoder import clip_encode_text

    t0 = time.perf_counter()
    cpu = R.build_clip_text_encoder(tower_path, "cpu")
    gpu = R.build_clip_text_encoder(tower_path, "cuda")
    build_s = time.perf_counter() - t0
    ids = torch.from_numpy(clip_token_ids(32, seed=1))
    reset_launches()
    with torch.no_grad():
        want = cpu(ids, torch.float32)
        got = gpu(ids.cuda(), torch.float32)
        got_bf16 = gpu(ids.cuda(), torch.bfloat16)
    torch.cuda.synchronize()
    errs = {}
    for key in ("last_hidden_state", "pooler_output"):
        scale = float(want[key].abs().max())
        errs[f"{key}_fp32_vs_cpu"] = float((got[key].cpu() - want[key]).abs().max()) / scale
        ref = got[key].float()
        errs[f"{key}_bf16_vs_fp32"] = float((got_bf16[key].float() - ref).abs().max() / ref.abs().max())
    chunk = torch.from_numpy(clip_token_ids(CLIP_CHUNK, seed=2)).cuda()
    res = {"phase": "clip", "card": card, "arch": dict(CLIP_TEXT, heads=CLIP_TEXT["width"] // 64),
           "parameters": sum(p.numel() for p in gpu.parameters()), "build_s": build_s,
           "errs_rel_to_max": errs, "tol": {"fp32": CLIP_FP32_TOL, "bf16": CLIP_BF16_TOL}}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        with torch.no_grad():
            ms = cuda_time_ms(lambda: clip_encode_text(gpu, chunk, chunk != 0, 32, True, dt),
                              iters=10)
        res[f"chunk_ms_{name}"] = ms
        res[f"sentences_per_s_{name}"] = CLIP_CHUNK / ms * 1e3
        with torch.no_grad():
            res[f"profile_{name}"] = profile_step(
                lambda ids: clip_encode_text(gpu, ids, ids != 0, 32, True, dt), [chunk], top=8)
        encode = R.build_text_encoder(_clip_opt(tower_path), None, "cuda", dt)
        flat = clip_token_ids(CHARADES_TEST_SENTENCES, seed=3)
        ds = types.SimpleNamespace(merged_data=[{"words_id": [row]} for row in flat])
        R.cache_text_features(types.SimpleNamespace(merged_data=ds.merged_data[:CLIP_CHUNK]),
                              encode, "cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R.cache_text_features(ds, encode, "cuda")
        torch.cuda.synchronize()
        res[f"cache_pass_{CHARADES_TEST_SENTENCES}_s_{name}"] = time.perf_counter() - t0
        cached = ds.merged_data[0]["cached_words_feat"][0]
        res[f"cache_shape_{name}"] = list(cached.shape)
    res["launches"] = read_launches()
    res["ok"] = bool(
        errs["last_hidden_state_fp32_vs_cpu"] <= CLIP_FP32_TOL
        and errs["pooler_output_fp32_vs_cpu"] <= CLIP_FP32_TOL
        and errs["last_hidden_state_bf16_vs_fp32"] <= CLIP_BF16_TOL
        and errs["pooler_output_bf16_vs_fp32"] <= CLIP_BF16_TOL
        and res["cache_shape_bf16"] == [32, CLIP_TEXT["width"]]
        and not any(res["launches"].values()))
    emit(res)
    if not res["ok"]:
        raise SystemExit("clip phase failed")
    return res


def write_bpe(path: str) -> None:
    """A fabricated BPE merge table (gzip, CLIP's file format) that merges
    every word of SENTS whole; other text falls back to characters."""
    import gzip

    merges = []
    for w in sorted({w for s in SENTS for w in s.split()}):
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            pair = f"{parts[0]} {parts[1]}"
            if pair not in merges:
                merges.append(pair)
            parts = [parts[0] + parts[1]] + parts[2:]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: fabricated"] + merges) + "\n")


def to_clip_root(cfg_path: str, tower_path: str) -> None:
    """The synthetic charades root of write_charades_root on CLIP text, as
    config/charades/C+SF_C.json ships it: the fabricated BPE file and tower,
    512-d text, the MLM keep-vocab counted over the root's sentences."""
    from collections import Counter

    from mesm_tpu_torch.data.tokenizers import ClipBPETokenizer

    with open(cfg_path) as f:
        cfg = json.load(f)
    root = os.path.dirname(cfg_path)
    bpe = os.path.join(root, "bpe_fabricated.txt.gz")
    write_bpe(bpe)
    tok = ClipBPETokenizer(False, None, bpe)
    counts = Counter(i for s in SENTS for i in tok.encode(s)[0])
    with open(os.path.join(cfg["ann_path"], "CLIP_tokenized_count.txt"), "w") as f:
        f.writelines(f"{i} {c}\n" for i, c in counts.most_common())
    with open(os.path.join(HERE, "config", "charades", "C+SF_C.json")) as f:
        shipped = json.load(f)
    cfg.update(tokenizer_type="CLIP", bpe_path=bpe, text_model_path=tower_path,
               t_feat_dim=shipped["t_feat_dim"], vocab_size=shipped["vocab_size"])
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)


@contextlib.contextmanager
def counted_eval_batches():
    """The number of eval batches decoded meanwhile (one _decode_batch each)."""
    from mesm_tpu_torch import evaluate

    orig, n = evaluate._decode_batch, [0]

    def counted(*args, **kwargs):
        n[0] += 1
        return orig(*args, **kwargs)

    evaluate._decode_batch = counted
    try:
        yield n
    finally:
        evaluate._decode_batch = orig


def phase_clip_cli(tower_path: str) -> dict:
    """Both entry points from raw text on CLIP: the synthetic charades root
    with tokenizer_type CLIP, the fabricated BPE file and tower.
    `evaluate` in fp32 (TF32 off) with the text cache on and off (brief
    metrics equal; the largest difference between the encodings of the
    cache's chunks of CLIP_CHUNK and the eval batches' 128 rows), then bf16
    "auto" with the cache on (the launches of kernels 1 and 2 per batch),
    then one `train` epoch."""
    import torch

    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.config import TestOptions
    from mesm_tpu_torch.data.tokenizers import ClipBPETokenizer
    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.train import train

    res = {"phase": "clip_cli"}
    with tempfile.TemporaryDirectory(prefix="mesm_chip_clip_") as root:
        eval_cfg = write_cli_eval(root, clip_tower=tower_path)
        with open(eval_cfg) as f:
            base = json.load(f)

        def run(name, *args):
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(dict(base, inference_id=name), f)
            with counted_eval_batches() as n:
                reset_launches()
                t0 = time.perf_counter()
                metrics, _ = inference(["--config_file", path, "--device", "cuda", *args,
                                         *PER_BATCH])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            return metrics["brief"], read_launches(), n[0], secs

        on, _, _, on_s = run("clip_fp32_on", "--compute_dtype", "float32", "--cache_text", "on")
        off, _, _, off_s = run("clip_fp32_off", "--compute_dtype", "float32", "--cache_text", "off")
        bf16, launches, n_batches, bf16_s = run("clip_bf16_on", "--compute_dtype", "bfloat16",
                                                "--cache_text", "on")
        opt = TestOptions().parse(["--config_file", os.path.join(root, "clip_fp32_on.json")])
        with open(os.path.join(opt.ann_path, "charades_sta_test.txt")) as f:
            sents = [line.split("##")[1].strip() for line in f if line.strip()]
        ids = torch.from_numpy(ClipBPETokenizer(False, None, opt.bpe_path).tokenize(sents)[0]).cuda()
        encode = R.build_text_encoder(opt, None, "cuda", torch.float32)
        whole = [torch.cat(x) for x in zip(*(encode({"words_id": ids[i:i + CLIP_CHUNK]})
                                             for i in range(0, len(ids), CLIP_CHUNK)))]
        rows = [torch.cat(x) for x in zip(*(encode({"words_id": ids[i:i + 128]})
                                            for i in range(0, len(ids), 128)))]
        enc_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(whole, rows))
        res.update(sentences=len(sents), brief_fp32_cache_on=on, brief_fp32_cache_off=off,
                   brief_bf16=bf16, cache_on_equals_off=on == off,
                   encodings_max_abs_diff_chunk256_vs_rows128=enc_diff,
                   evaluate_s={"fp32_on": on_s, "fp32_off": off_s, "bf16_on": bf16_s},
                   bf16_eval_batches=n_batches, bf16_launches=launches,
                   bf16_launches_per_batch={k: launches[k] / max(n_batches, 1)
                                            for k in ("ln_dense", "attention_packed")},
                   eval_rows_per_s_bf16=len(sents) / bf16_s)

        train_path = os.path.join(root, "config.json")  # the root's train config, on CLIP
        with open(train_path) as f:
            train_cfg = json.load(f)
        train_cfg.update(n_epoch=1, stop_score="miou", exp_id="chip_smoke_clip_train")
        with open(train_path, "w") as f:
            json.dump(train_cfg, f)
        t0 = time.perf_counter()
        out = train(["--config_file", train_path, "--device", "cuda", *PER_BATCH])
        torch.cuda.synchronize()
        with open(out["opt"].train_log_filepath) as f:
            last = f.read().strip().splitlines()[-1]
        toks = last.split()
        res["train"] = {"steps": out["step"], "s": time.perf_counter() - t0,
                        "loss_overall": float(toks[toks.index("loss_overall") + 1])}
    res["ok"] = bool(on and res["cache_on_equals_off"] and bf16
                     and all(v > 0 for v in res["bf16_launches_per_batch"].values())
                     and res["train"]["steps"] > 0
                     and math.isfinite(res["train"]["loss_overall"]))
    emit(res)
    if not res["ok"]:
        raise SystemExit("clip_cli phase failed")
    return res


def phase_resume_v1() -> dict:
    """`evaluate` on a mesm_tpu.v1 checkpoint: the phase-cli model written
    as the JAX package writes its own (convert.jax_params_from_state_dict,
    no optimizer state), scored on the card in bf16 "auto" beside the
    torch-layout checkpoint of the same weights: equal brief metrics."""
    import shutil

    import torch

    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.config import BaseOptions
    from mesm_tpu_torch.convert import jax_params_from_state_dict
    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.utils.checkpoint import is_torch_checkpoint, save_v1_checkpoint

    with tempfile.TemporaryDirectory(prefix="mesm_chip_v1_") as root:
        eval_cfg = write_cli_eval(root)
        with open(eval_cfg) as f:
            base = json.load(f)
        run_dir = base["trained_result_dir"]
        v1_dir = os.path.join(root, "v1_run")
        os.makedirs(v1_dir)
        shutil.copy(os.path.join(run_dir, "opt.json"), v1_dir)
        opt = BaseOptions().parse(["--config_file", os.path.join(root, "config.json")])
        state = torch.load(os.path.join(run_dir, "model_test_best.ckpt"), weights_only=False)["model"]
        v1_path = os.path.join(v1_dir, "model_test_best.ckpt")
        save_v1_checkpoint(v1_path, jax_params_from_state_dict(state, R.build_model_config(opt)),
                           epoch=0)
        briefs = {}
        for name, trained in (("torch_layout", run_dir), ("mesm_tpu_v1", v1_dir)):
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(dict(base, inference_id=name, trained_result_dir=trained), f)
            metrics, _ = inference(["--config_file", path, "--compute_dtype", "bfloat16",
                                    "--device", "cuda", *PER_BATCH])
            briefs[name] = metrics["brief"]
        res = {"phase": "resume_v1", "v1_is_torch": is_torch_checkpoint(v1_path),
               "brief_torch_layout": briefs["torch_layout"], "brief_v1": briefs["mesm_tpu_v1"]}
    res["ok"] = bool(briefs["torch_layout"] and briefs["torch_layout"] == briefs["mesm_tpu_v1"]
                     and not res["v1_is_torch"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("resume_v1 phase failed")
    return res


def phase_qvh_train(card: str, steps: int = 4) -> dict:
    """QVHighlights C+SF_C fp32 train steps as shipped (dropout 0.1, B = 12
    rows, multi-clip targets matched by the batched Hungarian solver, the
    group video as the SS-MESM video): ms/step, the loss finite, no kernel
    launched (no kernel tier takes an fp32 train call at these lengths, and
    the LayerNorm -> Dense kernel is eval-only). Then the train CLI for one
    epoch on a synthetic qvh root and the evaluate CLI on its checkpoint."""
    import shutil

    import torch

    from mesm_tpu_torch.data.pipeline import stage_batch
    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.train import train

    torch.manual_seed(0)
    model = MESM(_qvh_config()).cuda()
    B = QVH["train_B"]
    batch = stage_batch(make_qvh_host_batch(3, B, max(2, B // 2), with_targets=True), False, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ms, launches, loss, prof = _train_ms_per_step(model, CriterionConfig(**QVH_CRITERION), batch,
                                                  "auto", steps, count=True, profile=True)
    res = {"phase": "qvh_train", "card": card, "rows": B, "steps": steps, "ms_per_step": ms,
           "launches": launches, "launches_expected": expected_launches({}, steps),
           "last_loss": loss, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "profile": prof}
    with tempfile.TemporaryDirectory(prefix="mesm_chip_qvh_") as root:
        cfg_path = write_qvh_root(root)
        reset_launches()
        t0 = time.perf_counter()
        run = train(["--config_file", cfg_path, "--device", "cuda", *PER_BATCH])
        torch.cuda.synchronize()
        res["cli_train_s"] = time.perf_counter() - t0
        res["cli_steps"] = run["step"]
        res["cli_launches"] = read_launches()
        opt = run["opt"]
        with open(opt.train_log_filepath) as f:
            log = [line for line in f if "loss_overall" in line]
        res["cli_train_log_last"] = log[-1].strip() if log else None
        # evaluate reads <run>/model_val_best.ckpt; a random model's scores
        # may never improve, so it scores the latest checkpoint in its place
        scored = os.path.join(root, "scored")
        os.makedirs(scored)
        shutil.copy(os.path.join(opt.result_dir, "opt.json"), scored)
        shutil.copy(os.path.join(opt.result_dir, "model_latest.ckpt"),
                    os.path.join(scored, "model_val_best.ckpt"))
        eval_cfg = os.path.join(root, "eval.json")
        with open(eval_cfg, "w") as f:
            json.dump({"ann_path": opt.ann_path, "feat_files": opt.feat_files,
                       "text_model_path": opt.text_model_path, "bpe_path": "",
                       "trained_result_dir": scored, "inference_id": "chip_smoke_qvh",
                       "inference_result_dir": os.path.join(root, "inference"),
                       "num_workers": 4}, f)
        t0 = time.perf_counter()
        metrics, _ = inference(["--config_file", eval_cfg, "--compute_dtype", "bfloat16",
                                "--device", "cuda", *PER_BATCH])
        res["cli_evaluate_s"] = time.perf_counter() - t0
        res["cli_brief"] = metrics["brief"]
    res["ok"] = bool(launches == res["launches_expected"] and math.isfinite(loss)
                     and run["step"] > 0 and res["cli_train_log_last"]
                     and res["cli_brief"].get("MR-full-mAP") is not None)
    emit(res)
    if not res["ok"]:
        raise SystemExit("qvh_train phase failed")
    return res


def profile_step(step, batches, iters: int = 4, top: int = 12) -> dict:
    """Device time by kernel over `iters` steps (eval or train),
    from torch.profiler: the busy share is the summed kernel time over the
    window's wall time (the profiler's own overhead is in the wall time, so
    the share is a lower bound), in a window opened by open_window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window()
        t0 = time.perf_counter()
        for i in range(iters):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [  # device-side kernels only: the CPU ops' device time repeats them, and
        # a user annotation's device range (the optimizer step's) spans its kernels
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("Optimizer.") and SPIN not in e.key
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    return {
        "steps": iters, "wall_ms_per_step": wall_us / iters / 1e3,
        "device_ms_per_step": busy_us / iters / 1e3,
        "busy_share": busy_us / wall_us, "kernel_launches_per_step": sum(k[2] for k in kernels) / iters,
        "top": [{"name": n[:90], "ms_per_step": t / iters / 1e3, "calls_per_step": c / iters}
                for n, t, c in kernels[:top]],
    }


SENTS = [
    "a person opens the door", "someone closes a window", "the person eats a sandwich",
    "a man reads the book", "person turns on a light", "a woman drinks from a cup",
    "someone sits on the sofa", "the person puts a bag on the table",
]


def write_charades_root(root: str, n_videos: int = 64, seed: int = 0,
                        n_sentences: Optional[int] = None) -> str:
    """A synthetic charades root at full video width: CLIP image (512) and
    SlowFast (2304) features, 2818 wide with the two TEF channels, up to 194
    clips; GloVeSimple 300-d text. The features are stored as directories of
    per-video .npy arrays, which the port's FeatureStore reads like its HDF5
    files (the GPU host has no h5py). 1-4 sentences a video (~2.5), or
    `n_sentences` spread evenly. Returns the train config path."""
    import numpy as np

    from mesm_tpu_torch.data import Vocabulary

    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    rng = np.random.default_rng(seed)
    vids = [f"V{i:04d}" for i in range(n_videos)]
    durations = {v: float(rng.integers(30, 195)) for v in vids}
    lines = []
    for i, v in enumerate(vids):
        if n_sentences is None:
            count = 1 + (i % 3) + (i % 2)  # 1..4 sentences, ~2.5 on average
        else:
            count = n_sentences // n_videos + (i < n_sentences % n_videos)
        for j in range(count):
            d = durations[v]
            st = float(rng.uniform(1.5, d * 0.6))
            ed = float(rng.uniform(st + 1, d))
            lines.append(f"{v} {st:.2f} {ed:.2f}##{SENTS[(i + j) % len(SENTS)]}\n")
    for split in ("train", "test"):
        with open(os.path.join(ann, f"charades_sta_{split}.txt"), "w") as f:
            f.write("".join(lines))
        rows = ["id,subject,scene,quality,relevance,verified,script,objects,descriptions,length\n"]
        rows += [f"{v},s,x,7,7,Yes,script,objects,desc,{durations[v]}\n" for v in vids]
        with open(os.path.join(ann, f"Charades_v1_{split}.csv"), "w") as f:
            f.write("".join(rows))
    words = sorted({w for s in SENTS for w in s.split()})
    vocab = Vocabulary(words)
    with open(os.path.join(ann, "GloVe_tokenized_count.txt"), "w") as f:
        f.writelines(f"{w} {vocab.wtoi[w]} 5\n" for w in words)
    glove = os.path.join(root, "glove_300d.txt")
    with open(glove, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{x:.4f}" for x in rng.normal(size=300)) + "\n")
    feat_files = []
    for name, width in (("clip_image", 512), ("slowfast", 2304)):
        path = os.path.join(root, name)
        os.makedirs(path)
        for v in vids:
            L = int(min(194, durations[v]))
            np.save(os.path.join(path, f"{v}.npy"), rng.standard_normal((L, width), dtype=np.float32))
        feat_files.append(path)
    with open(os.path.join(HERE, "config", "charades", "C+SF_C.json")) as f:
        cfg = json.load(f)
    cfg.update(
        ann_path=ann, feat_files=feat_files, tokenizer_type="GloVeSimple",
        text_model_path=glove, t_feat_dim=300, vocab_size=len(vocab),
        result_root=os.path.join(root, "results"), num_workers=4, exp_id="chip_smoke",
    )
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    return cfg_path


def write_qvh_root(root: str, n_videos: int = 48, seed: int = 0) -> str:
    """A synthetic QVHighlights root at full video width: 150 s clips of
    YouTube videos (1-3 clips a video, 75 clips of 2 s each), CLIP image
    (512) and SlowFast (2304) features stored as per-clip .npy arrays; each
    clip has one query with 1-3 relevant windows and 3-annotator saliency
    scores of its relevant clips; GloVeSimple 300-d text (the CLIP text tower
    is not ported). The first 2/3 of the videos train, the rest validate.
    Returns the train config path (one epoch)."""
    import numpy as np

    from mesm_tpu_torch.data import Vocabulary

    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    rng = np.random.default_rng(seed)
    feats = {name: os.path.join(root, name) for name in ("clip_image", "slowfast")}
    for path in feats.values():
        os.makedirs(path)
    splits = {"train": [], "val": []}
    qid = 0
    for i in range(n_videos):
        for c in range(1 + i % 3):
            vid = f"Y{i:03d}_{c * 150:.1f}_{(c + 1) * 150:.1f}"
            for name, width in (("clip_image", 512), ("slowfast", 2304)):
                np.save(os.path.join(feats[name], f"{vid}.npy"),
                        rng.standard_normal((75, width), dtype=np.float32))
            windows, rel = [], []
            for _ in range(int(rng.integers(1, 4))):
                st = int(rng.integers(0, 60)) * 2
                ed = min(st + int(rng.integers(2, 16)) * 2, 150)
                windows.append([st, ed])
                rel += list(range(st // 2, ed // 2))
            rel = sorted(set(rel))
            qid += 1
            splits["train" if i < 2 * n_videos // 3 else "val"].append(dict(
                qid=qid, query=SENTS[(i + c) % len(SENTS)], vid=vid, duration=150,
                relevant_clip_ids=rel, relevant_windows=windows,
                saliency_scores=[[int(x) for x in rng.integers(0, 5, 3)] for _ in rel],
            ))
    for split, rows in splits.items():
        with open(os.path.join(ann, f"highlight_{split}_release.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    words = sorted({w for s in SENTS for w in s.split()})
    vocab = Vocabulary(words)
    with open(os.path.join(ann, "GloVe_tokenized_count.txt"), "w") as f:
        f.writelines(f"{w} {vocab.wtoi[w]} 5\n" for w in words)
    glove = os.path.join(root, "glove_300d.txt")
    with open(glove, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{x:.4f}" for x in rng.normal(size=300)) + "\n")
    with open(os.path.join(HERE, "config", "QVHighlights", "C+SF_C.json")) as f:
        cfg = json.load(f)
    cfg.update(
        ann_path=ann, feat_files=list(feats.values()), tokenizer_type="GloVeSimple",
        text_model_path=glove, t_feat_dim=300, vocab_size=len(vocab), n_epoch=1,
        result_root=os.path.join(root, "results"), num_workers=4, exp_id="chip_smoke_qvh",
    )
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    return cfg_path


def write_cli_eval(root: str, clip_tower: Optional[str] = None, n_videos: int = 64,
                   n_sentences: Optional[int] = None, shipped_batches: bool = False) -> str:
    """The synthetic charades root (on CLIP text with `clip_tower`, see
    to_clip_root), a torch-layout checkpoint from seeded weights and an eval
    config that scores it in one length bucket of 128 rows, or with
    `shipped_batches` in the shipped config's batches (eval_batch_size 30,
    4 length buckets). Returns the eval config's path."""
    import torch

    from mesm_tpu_torch import runner
    from mesm_tpu_torch.config import BaseOptions

    cfg_path = write_charades_root(root, n_videos=n_videos, n_sentences=n_sentences)
    if clip_tower is not None:
        to_clip_root(cfg_path, clip_tower)
    opt = BaseOptions().parse(["--config_file", cfg_path])  # writes the run's opt.json
    torch.manual_seed(1)
    model = runner.build_model(opt)
    torch.save({"model": model.state_dict(), "epoch": 0},
               os.path.join(opt.result_dir, "model_test_best.ckpt"))
    eval_cfg = os.path.join(root, "eval.json")
    cfg = {
        "ann_path": opt.ann_path, "feat_files": opt.feat_files,
        "text_model_path": opt.text_model_path, "bpe_path": opt.bpe_path,
        "trained_result_dir": opt.result_dir, "inference_id": "chip_smoke",
        "inference_result_dir": os.path.join(root, "inference"), "num_workers": 4,
    }
    if not shipped_batches:
        cfg.update(row_capacity=128, eval_len_buckets=1)
    with open(eval_cfg, "w") as f:
        json.dump(cfg, f)
    return eval_cfg


def phase_cli() -> dict:
    """`python -m mesm_tpu_torch.evaluate` through its inference() entry:
    bf16 on the card, a torch-layout checkpoint from seeded weights."""
    import torch

    from mesm_tpu_torch.evaluate import inference

    with tempfile.TemporaryDirectory(prefix="mesm_chip_smoke_") as root:
        t0 = time.perf_counter()
        eval_cfg = write_cli_eval(root)
        setup_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        metrics, _ = inference(["--config_file", eval_cfg, "--compute_dtype", "bfloat16",
                                "--device", "cuda", *PER_BATCH])
        torch.cuda.synchronize()
        launches = read_launches()
        brief = metrics["brief"]
        res = {"phase": "cli", "setup_s": setup_s, "inference_s": time.perf_counter() - t0,
               "launches": launches, "brief": brief}
        res["ok"] = bool(launches["ln_dense"] > 0 and launches["attention_packed"] > 0 and brief
                         and launches["stream_layer"] == 0 and launches["layout_anchor"] == 0)
        emit(res)
        if not res["ok"]:
            raise SystemExit("cli phase failed: a kernel of the main path never ran")
    return res


def _tacos_eval_batches():
    """Two TACoS eval batches (16 rows, ~6 videos of up to 600 clips)."""
    B = TACOS["B"]
    return [make_eval_batch(s, B=B, NG=max(2, int(B / 2.4)), Lv=TACOS["Lv"], Dv=TACOS["Dv"],
                            Lw=TACOS["Lw"], Dt=TACOS["Dt"]) for s in range(2)]


def phase_int8_eval(card: str, n_batches: int = 2) -> dict:
    """The charades bf16 and TACoS fp32 eval steps with
    kernels.set_int8_ffn(True) in "auto": the launches per batch
    (INT8_LAUNCHES), the predictions against the same model with the FFN
    sites sent to ffn_int8_reference on the card (MODEL_TOL), and, not
    gated, the distance to int8 off, rows/s and the device time and
    launches per batch (torch.profiler) with int8 on and off. Then the
    evaluate entry point in-process with the switch set."""
    import torch

    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    res = {"phase": "int8_eval", "card": card, "batches": n_batches, "tol": MODEL_TOL}
    ok = True
    for site, cfg, dt, batches in (
            ("charades", _model_config(), torch.bfloat16, [make_eval_batch(s) for s in range(2)]),
            ("tacos", _tacos_config(), torch.float32, _tacos_eval_batches())):
        torch.manual_seed(0)
        step = make_eval_step(MESM(cfg).cuda().eval(), _encode_batch, dt)
        with int8_ffn(True):
            reset_launches()
            outs = [step(batches[i % 2]) for i in range(n_batches)]
            torch.cuda.synchronize()
            launches = read_launches()
            with ffn_plain_route():
                plain = step(batches[0])
        off = step(batches[0])
        want = expected_launches(INT8_LAUNCHES[site], n_batches)
        r = {"launches": launches, "launches_expected": want,
             "finite": all(bool(torch.isfinite(v.float()).all()) for o in outs for v in o.values()),
             "vs_plain_route": _pred_err(outs[0], plain), "vs_int8_off": _pred_err(outs[0], off)}
        B = batches[0]["video_mask"].shape[0]

        def rate(enabled: bool, iters: int = 6) -> float:
            with int8_ffn(enabled):
                step(batches[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(iters):
                    step(batches[i % 2])
                torch.cuda.synchronize()
                return B * iters / (time.perf_counter() - t0)

        turns = [(on, rate(on)) for on in (True, False, False, True)]
        r["rows_per_s_int8_on"] = [x for on, x in turns if on]
        r["rows_per_s_int8_off"] = [x for on, x in turns if not on]
        # device ms and launches per batch, int8 on and off (torch.profiler)
        for on in (True, False):
            with int8_ffn(on):
                r[f"profile_int8_{'on' if on else 'off'}"] = profile_step(step, batches, top=8)
        r["ok"] = bool(launches == want and r["finite"] and max(r["vs_plain_route"].values()) <= MODEL_TOL)
        res[site] = r
        ok = ok and r["ok"]
        del step
    with tempfile.TemporaryDirectory(prefix="mesm_chip_int8_") as root:
        eval_cfg = write_cli_eval(root)
        reset_launches()
        t0 = time.perf_counter()
        with int8_ffn(True):
            metrics, _ = inference(["--config_file", eval_cfg, "--compute_dtype", "bfloat16",
                                    "--device", "cuda", *PER_BATCH])
        torch.cuda.synchronize()
        res["cli"] = {"inference_s": time.perf_counter() - t0, "launches": read_launches(),
                      "brief": metrics["brief"]}
    ok = ok and res["cli"]["launches"]["ffn_int8"] > 0 and bool(res["cli"]["brief"])
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise SystemExit("int8_eval phase failed")
    return res


# `python -m mesm_tpu_torch.evaluate` run as the interpreter runs it, then
# the launch counters of that process on the last line
CLI_WITH_COUNTS = """
import json, runpy, sys
sys.argv = ["mesm_tpu_torch.evaluate"] + sys.argv[1:]
runpy.run_module("mesm_tpu_torch.evaluate", run_name="__main__", alter_sys=True)
from mesm_tpu_torch.ops import attention_batched, attention_heads, attention_packed
print(json.dumps({"attention_per_head": attention_heads.per_head_launches,
                  "attention_all_heads": attention_heads.all_heads_launches,
                  "attention_batched": attention_batched.launches,
                  "attention_packed": attention_packed.launches}))
"""


def phase_attn_variants(card: str, n_batches: int = 2) -> dict:
    """Each MESM_ATTN_VARIANT layout through the eval step: charades bf16
    and TACoS fp32 in "auto", whose DETR encoders launch the variant's
    kernel twice a batch (VARIANT_KERNEL), held against kernels "off"
    (MODEL_TOL in bf16, FP32_MODEL_TOL in fp32). Under "packed" also fp32
    in "on" (PACKED_FP32_ON_LAUNCHES): TACoS, and the charades model with
    64-80-word queries. Then one kernel-engaged TACoS fp32 train step under
    "per_head" against "off" (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL), and
    `python -m mesm_tpu_torch.evaluate` with MESM_ATTN_VARIANT=all_heads in
    the environment of its process, as a user reaches it."""
    import dataclasses

    import torch

    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    def eval_step(cfg, dt):
        torch.manual_seed(0)
        return make_eval_step(MESM(cfg).cuda().eval(), _encode_batch, dt)

    sites = {
        "charades": (eval_step(_model_config(), torch.bfloat16),
                     [make_eval_batch(s) for s in range(2)], MODEL_TOL),
        "tacos": (eval_step(_tacos_config(), torch.float32), _tacos_eval_batches(), FP32_MODEL_TOL),
        "long_query": (eval_step(dataclasses.replace(_model_config(), max_words_l=80), torch.float32),
                       [make_eval_batch(s, Lw=80, min_words=64) for s in range(2)], FP32_MODEL_TOL),
    }
    with dispatch_mode("off"):
        offs = {name: step(batches[0]) for name, (step, batches, _) in sites.items()}
    res = {"phase": "attn_variants", "card": card, "batches": n_batches, "tol": MODEL_TOL,
           "fp32_tol": FP32_MODEL_TOL}
    ok = True
    for variant, kernel in VARIANT_KERNEL.items():
        with attn_variant(variant):
            for name in ("charades", "tacos"):
                step, batches, tol = sites[name]
                rep, good = drive_modes(step, batches, {"auto": {"ln_dense": 1, kernel: 2}}, n_batches,
                                        {"off": offs[name]}, tol)
                res[f"{variant}_{name}"] = rep["auto"]
                ok = ok and good
    with attn_variant("packed"):
        for name, want in PACKED_FP32_ON_LAUNCHES.items():
            step, batches, tol = sites[name]
            rep, good = drive_modes(step, batches, {"on": want}, n_batches, {"off": offs[name]}, tol)
            res[f"packed_on_{name}_fp32"] = rep["on"]
            ok = ok and good
    del sites, offs

    # one kernel-engaged TACoS fp32 train step under per_head, against off
    cfg = _tacos_config(dropout=0.0)
    torch.manual_seed(0)
    init = MESM(cfg).state_dict()
    ccfg = CriterionConfig(**TACOS_CRITERION)
    batch = make_train_batch(0, TACOS["B"], TACOS["Lv"], TACOS["Dv"], TACOS["Lw"], TACOS["Dt"],
                             cfg.num_classes)

    def fresh():
        model = MESM(cfg)
        model.load_state_dict(init)
        return model.cuda()

    with attn_variant("per_head"):
        reset_launches()
        loss_v, g_v = _first_grads(fresh(), ccfg, batch, "auto")
        torch.cuda.synchronize()
        launches = read_launches()
    loss_o, g_o = _first_grads(fresh(), ccfg, batch, "off")
    want = expected_launches({"attention_per_head": 2, "attention_trainable": 2,
                              "attention_backward": 2}, 1)
    t = {"launches": launches, "launches_expected": want, "first_loss_per_head": loss_v,
         "first_loss_off": loss_o, "first_loss_rel_err": abs(loss_v - loss_o) / max(1.0, abs(loss_o)),
         "grad_max_err_rel_to_max1": _grad_err(g_v, g_o), "grads_same_params": sorted(g_v) == sorted(g_o),
         "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL}
    t["ok"] = bool(launches == want and t["grads_same_params"]
                   and t["first_loss_rel_err"] <= TRAIN_LOSS_TOL
                   and t["grad_max_err_rel_to_max1"] <= TRAIN_GRAD_TOL)
    res["per_head_train_tacos_fp32"] = t
    ok = ok and t["ok"]
    del g_v, g_o, batch, init

    # the evaluate entry point in its own process, the variable in its environment
    from mesm_tpu_torch import kernels

    with tempfile.TemporaryDirectory(prefix="mesm_chip_variant_") as root:
        eval_cfg = write_cli_eval(root)
        env = dict(os.environ, **{kernels.ATTN_VARIANT_ENV: "all_heads"})
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_WITH_COUNTS, "--config_file", eval_cfg,
             "--compute_dtype", "bfloat16", "--device", "cuda", *PER_BATCH],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600,
        )
        cli = {"variant": "all_heads", "returncode": proc.returncode,
               "seconds": time.perf_counter() - t0}
        if proc.returncode == 0:
            cli["launches"] = json.loads(proc.stdout.strip().splitlines()[-1])
        else:
            cli["stderr_tail"] = proc.stderr[-2000:]
    cli["ok"] = bool(proc.returncode == 0 and cli["launches"]["attention_all_heads"] > 0
                     and cli["launches"]["attention_packed"] == 0)
    res["cli_all_heads"] = cli
    ok = ok and cli["ok"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise SystemExit("attn_variants phase failed")
    return res


def phase_stream_layer(card: str) -> dict:
    """The fused stream layer's path. First the bench entry point's run
    (`python -m mesm_tpu_torch.scripts.bench_layer_kernel`, STREAM) for both
    flavours in bf16 and fp32, the launch counts set to 0 just before each
    run and read just after: the kernel N times per chain, and the module
    chain what "auto" gives it (the packed attention in the bf16 encoder);
    after one application the module and the kernel agree within MODEL_TOL
    in bf16, FP32_MODEL_TOL in fp32. Then the charades C+SF_C model (phase
    `model`) in one bf16 eval batch in "auto", which launches
    CHARADES_LAUNCHES["auto"] and neither new kernel: forward hooks capture
    the inputs and outputs of the DETR encoder's first layer and the first
    T2V layer, and fused_stream_layer on each layer's own weights
    (stream_layer_params) and inputs holds the layer's output within
    MODEL_TOL; layout_anchor copies the encoder memory without its global
    token (the strided 128 x 194 x 256 bf16 view the decoder reads) into a
    row-major tensor, bit for bit."""
    import torch

    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.models.t2v import scrambled_pair_factors
    from mesm_tpu_torch.ops import anchor
    from mesm_tpu_torch.ops.stream_layer import (fused_stream_layer, stream_layer_params,
                                                 stream_layer_reference)
    from mesm_tpu_torch.parallel.step import make_eval_step
    from mesm_tpu_torch.scripts import bench_layer_kernel as bench

    res = {"phase": "stream_layer", "card": card, "tol": MODEL_TOL, "fp32_tol": FP32_MODEL_TOL}
    ok = True
    N, iters = STREAM["N"], STREAM["iters"]
    applications = N * (iters + 1) + 1  # the warm-up and timed chains, one more to compare
    for flavor in ("encoder", "t2v"):
        for dtype_name in ("bfloat16", "float32"):
            L = STREAM["L"] if flavor == "encoder" else STREAM["Lv"]
            reset_launches()
            r = bench.run(flavor, STREAM["B"], L, N, getattr(torch, dtype_name), "cuda", iters)
            torch.cuda.synchronize()
            r["launches"] = read_launches()
            expect = {"stream_layer": applications}
            if flavor == "encoder" and dtype_name == "bfloat16":
                expect["attention_packed"] = applications
            r["launches_expected"] = expected_launches(expect, 1)
            tol = MODEL_TOL if dtype_name == "bfloat16" else FP32_MODEL_TOL
            r["ok"] = bool(r["launches"] == r["launches_expected"] and r["finite"]
                           and r["kernel_launches_per_chain"] == N and r["max_err_rel_to_max1"] <= tol)
            res[f"bench_{flavor}_{dtype_name}"] = r
            ok = ok and r["ok"]

    torch.manual_seed(0)
    model = MESM(_model_config()).cuda().eval()
    step16 = make_eval_step(model, _encode_batch, torch.bfloat16)
    enc_layer = model.transformer.encoder.layers[0]
    t2v_layer = model.t2v_encoder.t2v_encoder.layers[0]
    seen = {}

    def capture(name):
        def hook(module, args, kwargs, output):
            seen[name] = (args, kwargs, output)
        return hook

    handles = [m.register_forward_hook(capture(name), with_kwargs=True)
               for name, m in (("encoder", enc_layer), ("t2v", t2v_layer),
                               ("memory", model.transformer.encoder))]
    reset_launches()
    step16(make_eval_batch(0))
    torch.cuda.synchronize()
    m = {"launches": read_launches(), "launches_expected": expected_launches(CHARADES_LAUNCHES["auto"], 1)}
    for h in handles:
        h.remove()
    H = model.cfg.nheads
    with torch.no_grad():
        (src, enc_mask, pos), _, enc_out = seen["encoder"]
        (txt, vid, tmask, pos_t, pos_v, vid_mask), kw, t2v_out = seen["t2v"]
        pair = kw.get("pair_factors") or scrambled_pair_factors(vid_mask, tmask, H)
        k_in = txt if pos_t is None else txt + pos_t
        enc_args = (pos, None, None, enc_mask, None, stream_layer_params(enc_layer), H, True)
        t2v_args = (pos_v, k_in, txt, tmask, pair, stream_layer_params(t2v_layer), H, False)
        local = seen["memory"][2][:, 1:]
        reset_launches()
        got_enc = fused_stream_layer(src, *enc_args)
        got_t2v = fused_stream_layer(vid, *t2v_args)
        anchored = anchor.layout_anchor(local)
        torch.cuda.synchronize()
        m["layer_launches"] = read_launches()
        want_local = anchor.layout_anchor_reference(local)
        for name, got, want, x, args in (("encoder", got_enc, enc_out, src, enc_args),
                                         ("t2v", got_t2v, t2v_out, vid, t2v_args)):
            m[name] = {"shape": list(x.shape), "dtype": str(x.dtype),
                       "max_err_rel_to_max1": _rel_err(got, want),
                       "plain_vs_layer": _rel_err(stream_layer_reference(x, *args), want),
                       "finite": bool(torch.isfinite(got).all())}
    m["layer_launches_expected"] = expected_launches({"stream_layer": 2, "layout_anchor": 1}, 1)
    m["anchor"] = {"shape": list(local.shape), "input_row_major": local.is_contiguous(),
                   "row_major": anchored.is_contiguous(),
                   "bit_equal": bool(torch.equal(anchored.view(torch.int16),
                                                 want_local.view(torch.int16)))}
    m["ok"] = bool(m["launches"] == m["launches_expected"]
                   and m["layer_launches"] == m["layer_launches_expected"]
                   and all(m[n]["finite"] and m[n]["max_err_rel_to_max1"] <= MODEL_TOL
                           for n in ("encoder", "t2v"))
                   and m["anchor"]["bit_equal"] and m["anchor"]["row_major"]
                   and not m["anchor"]["input_row_major"])
    res["model_layers"] = m
    res["ok"] = bool(ok and m["ok"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("stream_layer phase failed")
    return res


# ---------------------------------------------------------------------------
# the JAX package's last modules: its eval / train switches, profiling, the
# native host module, int8_dense and data-parallel training
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def dot_stats_ln(enabled: bool):
    """kernels.set_dot_stats_ln for the run, restored after."""
    from mesm_tpu_torch import kernels

    old = kernels.DOT_STATS_LN
    kernels.set_dot_stats_ln(enabled)
    try:
        yield
    finally:
        kernels.set_dot_stats_ln(old)


@contextlib.contextmanager
def attn_remat(enabled: bool):
    """kernels.ATTN_REMAT for the run, restored after."""
    from mesm_tpu_torch import kernels

    old = kernels.ATTN_REMAT
    kernels.ATTN_REMAT = enabled
    try:
        yield
    finally:
        kernels.ATTN_REMAT = old


def _layer_norm_sites_in_range(model, step, batch) -> dict:
    """The LayerNorm calls of one eval step that models/layers.apply_ln
    routes (the switch off) with at least DOT_STATS_MIN_ROWS rows of at most
    DOT_STATS_MAX_D features: {module name: [calls, rows, d]}. The gate
    apply_ln asks is wrapped to note each call's shape, and the LayerNorm
    module that apply_ln then calls takes it."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.models.layers import LayerNorm

    pending, seen, handles = [], {}, []
    gate = kernels.use_dot_stats_ln

    def noted(n_rows, d, device):
        pending[:] = [(n_rows, d)]
        return gate(n_rows, d, device)

    for name, m in model.named_modules():
        if isinstance(m, LayerNorm):
            def hook(mod, args, name=name):
                if pending:
                    rows, d = pending.pop()
                    if rows >= kernels.DOT_STATS_MIN_ROWS and d <= kernels.DOT_STATS_MAX_D:
                        calls = seen.get(name, [0, rows, d])[0]
                        seen[name] = [calls + 1, rows, d]
            handles.append(m.register_forward_pre_hook(hook))
    kernels.use_dot_stats_ln = noted
    try:
        with dot_stats_ln(False):
            step(batch)
        torch.cuda.synchronize()
    finally:
        kernels.use_dot_stats_ln = gate
        for h in handles:
            h.remove()
    return seen


@contextlib.contextmanager
def dot_stats_sites(model):
    """Counts, by LayerNorm module name, the calls that take ln_dot_stats
    (the function apply_ln calls, wrapped for the run)."""
    from collections import Counter

    from mesm_tpu_torch.models import layers

    names = {id(m.weight): n for n, m in model.named_modules() if isinstance(m, layers.LayerNorm)}
    taken = Counter()
    orig = layers.ln_dot_stats

    def counted(x, weight, bias, eps):
        taken[names.get(id(weight), "<other>")] += 1
        return orig(x, weight, bias, eps)

    layers.ln_dot_stats = counted
    try:
        yield taken
    finally:
        layers.ln_dot_stats = orig


def phase_dot_stats(card: str, n_batches: int = 4) -> dict:
    """The dot-stats LayerNorm (kernels.set_dot_stats_ln) in the charades
    C+SF_C bf16 eval step at full width under "auto", on and then off: every
    LayerNorm site in range (counted from the model with the switch off)
    takes the path once a batch and no other does, kernels 1 and 2 launch as
    without it, predictions within MODEL_TOL of "off", device ms per batch
    both ways."""
    import torch

    from mesm_tpu_torch.models import layers
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(_model_config()).cuda().eval()
    step16 = make_eval_step(model, _encode_batch, torch.bfloat16)
    batches = [make_eval_batch(s) for s in range(2)]
    with dispatch_mode("auto"):
        in_range = _layer_norm_sites_in_range(model, step16, batches[0])
    res = {"phase": "dot_stats", "card": card, "batches": n_batches, "sites_in_range": in_range}
    outs, ok = {}, bool(in_range)
    for enabled in (True, False):
        with dot_stats_ln(enabled), dispatch_mode("auto"):
            with dot_stats_sites(model) as taken:
                reset_launches()
                before = layers.dot_stats_calls
                outs[enabled] = [step16(batches[i % 2]) for i in range(n_batches)]
                torch.cuda.synchronize()
                launches = read_launches()
                calls = layers.dot_stats_calls - before
            prof = profile_step(step16, batches)
        want_sites = {n: c * n_batches for n, (c, _, _) in in_range.items()} if enabled else {}
        r = {"launches": launches,
             "launches_expected": expected_launches(CHARADES_LAUNCHES["auto"], n_batches),
             "sites_taken": dict(taken), "calls": calls,
             "device_ms_per_batch": prof["device_ms_per_step"],
             "wall_ms_per_batch": prof["wall_ms_per_step"]}
        r["ok"] = bool(r["launches"] == r["launches_expected"] and dict(taken) == want_sites
                       and calls == sum(want_sites.values()))
        res["on" if enabled else "off"] = r
        ok = ok and r["ok"]
    res["on_vs_off"] = _pred_err(outs[True][0], outs[False][0])
    res["finite"] = all(bool(torch.isfinite(v.float()).all()) for o in outs[True] for v in o.values())
    res["tol"] = MODEL_TOL
    res["ok"] = bool(ok and res["finite"] and max(res["on_vs_off"].values()) <= MODEL_TOL)
    emit(res)
    if not res["ok"]:
        raise SystemExit("dot_stats phase failed")
    return res


@contextlib.contextmanager
def remat_sites(model):
    """Counts, by attention module name, the calls whose core ran under
    torch.utils.checkpoint (models/attention.remat_calls around each
    module's forward)."""
    from collections import Counter

    from mesm_tpu_torch.models import attention

    taken, marks, handles = Counter(), {}, []
    for name, m in model.named_modules():
        if isinstance(m, (attention.ProjAttention, attention.CoreAttention)):
            def pre(mod, args, name=name):
                marks[name] = attention.remat_calls

            def post(mod, args, out, name=name):
                if attention.remat_calls > marks[name]:
                    taken[name] += attention.remat_calls - marks[name]
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        yield taken
    finally:
        for h in handles:
            h.remove()


def phase_remat(card: str, steps: int = 3) -> dict:
    """The training attention core under torch.utils.checkpoint
    (kernels.ATTN_REMAT) in the charades C+SF_C fp32 train step as shipped
    (B = 32, dropout 0.1), on and off from one init and the same draws: the
    first step's loss and gradients equal (1e-6; the checkpoint replays the
    dropout masks), the sites that took it named, peak memory and ms per
    step both ways. Then the kernel-engaged TACoS step with the switch on:
    the kernel tier wins before remat, so kernels 6 and 9 launch 2 + 2 a
    step and no core is rematerialised."""
    import torch

    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models import attention
    from mesm_tpu_torch.models.mesm import MESM

    cfg = _model_config()
    torch.manual_seed(0)
    init = MESM(cfg).state_dict()
    ccfg = CriterionConfig(**CHARADES_CRITERION)
    batch = make_train_batch(1, 32, 194, 2818, 16, 512, cfg.num_classes)

    def fresh():
        model = MESM(cfg)
        model.load_state_dict(init)
        return model.cuda()

    res, first = {"phase": "remat", "card": card, "rows": 32, "dropout": cfg.dropout}, {}
    for enabled in (True, False):
        with attn_remat(enabled):
            model = fresh()
            with remat_sites(model) as taken:
                first[enabled] = _first_grads(model, ccfg, batch, "auto")
            del model
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = attention.remat_calls
            ms, _, loss, _ = _train_ms_per_step(fresh(), ccfg, batch, "auto", steps, count=False)
            res["on" if enabled else "off"] = {
                "sites_first_step": dict(taken), "remat_calls": attention.remat_calls - before,
                "ms_per_step": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "last_loss": loss}
    (loss_on, g_on), (loss_off, g_off) = first[True], first[False]
    res["first_loss_on"], res["first_loss_off"] = loss_on, loss_off
    res["loss_abs_err"] = abs(loss_on - loss_off)
    res["grad_max_err_rel_to_max1"] = _grad_err(g_on, g_off)
    res["tol"] = 1e-6
    ok = (sorted(g_on) == sorted(g_off) and res["loss_abs_err"] <= 1e-6 * max(1.0, abs(loss_off))
          and res["grad_max_err_rel_to_max1"] <= 1e-6 and bool(res["on"]["sites_first_step"])
          and res["off"]["remat_calls"] == 0 and not res["off"]["sites_first_step"])
    del first, g_on, g_off

    tcfg = _tacos_config(dropout=0.0)
    torch.manual_seed(0)
    tmodel = MESM(tcfg).cuda()
    tbatch = make_train_batch(0, TACOS["B"], TACOS["Lv"], TACOS["Dv"], TACOS["Lw"], TACOS["Dt"],
                              tcfg.num_classes)
    with attn_remat(True):
        before = attention.remat_calls
        ms, launches, loss, _ = _train_ms_per_step(tmodel, CriterionConfig(**TACOS_CRITERION),
                                                   tbatch, "auto", 2, count=True)
    want = expected_launches({"attention_batched": 2, "attention_trainable": 2,
                              "attention_backward": 2}, 2)
    res["tacos_kernels_first"] = {"launches": launches, "launches_expected": want,
                                  "remat_calls": attention.remat_calls - before, "ms_per_step": ms,
                                  "last_loss": loss}
    ok = ok and launches == want and res["tacos_kernels_first"]["remat_calls"] == 0
    res["ok"] = bool(ok)
    emit(res)
    if not res["ok"]:
        raise SystemExit("remat phase failed")
    return res


def _kernel_counts(counts: dict, key: str) -> int:
    return sum(n for name, n in counts.items() if key in name)


def phase_profile(card: str, iters: int = 4) -> dict:
    """utils/profiling.maybe_trace (with the model's module ranges) around
    `iters` charades bf16 "auto" eval steps: utils/trace_report.report must
    count ln_dense's two kernels `iters` times and attention_packed's
    2 * `iters` times, and kernel_modules must put them in the input
    projection's first block and the DETR encoder; no launch of the window
    may lack its kernel's record (trace_report.dropped_launches). The top-10
    table and the module table are printed before the phase's line."""
    import torch

    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step
    from mesm_tpu_torch.utils import trace_report
    from mesm_tpu_torch.utils.profiling import maybe_trace

    torch.manual_seed(0)
    model = MESM(_model_config()).cuda().eval()
    step16 = make_eval_step(model, _encode_batch, torch.bfloat16)
    batches = [make_eval_batch(s) for s in range(2)]
    packed = ENCODER_KERNEL_NAMES["attention_packed"]["bfloat16"]
    want_counts = {LN_DENSE_KERNELS[0]: iters, LN_DENSE_KERNELS[1]: iters, packed: 2 * iters}
    want_modules = {LN_DENSE_KERNELS[0]: "MESM/input_vid_proj/0",
                    LN_DENSE_KERNELS[1]: "MESM/input_vid_proj/0", packed: "MESM/transformer/encoder"}
    with tempfile.TemporaryDirectory(prefix="mesm_chip_trace_") as trace_dir:
        with dispatch_mode("auto"):
            step16(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with maybe_trace(trace_dir, model=model):
                for i in range(iters):
                    step16(batches[i % 2])
            traced_s = time.perf_counter() - t0
        totals, counts, busy_ms, what = trace_report.device_op_totals(trace_dir)
        dropped = trace_report.dropped_launches(trace_dir)
        modules = trace_report.kernel_modules(trace_dir, depth=3)
        print(trace_report.report(trace_dir, top=10), flush=True)
        print(trace_report.module_report(trace_dir, depth=3), flush=True)
        mod_totals, _ = trace_report.module_totals(trace_dir, depth=3)
    got_counts = {k: _kernel_counts(counts, k) for k in want_counts}
    got_modules = {k: {m: n for name, mods in modules.items() if k in name for m, n in mods.items()}
                   for k in want_modules}
    res = {"phase": "profile", "card": card, "steps": iters, "read": what,
           "busy_ms_per_step": busy_ms / iters, "traced_wall_s": traced_s,
           "launches_per_step": sum(counts.values()) / iters, "dropped_launches": dropped,
           "kernel_counts": got_counts, "kernel_counts_expected": want_counts,
           "kernel_modules": got_modules,
           "module_ms_per_step": {m: ms / iters for m, ms in sorted(mod_totals.items(),
                                                                    key=lambda kv: -kv[1])[:12]}}
    res["ok"] = bool(dropped == 0 and got_counts == want_counts and all(
        got_modules[k] == {m: want_counts[k]} for k, m in want_modules.items()))
    emit(res)
    if not res["ok"]:
        raise SystemExit("profile phase failed")
    return res


@contextlib.contextmanager
def native_off():
    """The native host module reported absent: its callers take their numpy
    / Python paths."""
    from mesm_tpu_torch import native

    orig = native.get_native
    native.get_native = lambda: None
    try:
        yield
    finally:
        native.get_native = orig


def _host_ms(fn, reps: int = 3) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_native() -> dict:
    """The port's native host module (mesm_tpu_torch/native) built by g++ on
    this machine and loaded, then on the predictions of the evaluate entry
    point (bf16, the synthetic charades root): temporal NMS of every query's
    windows equal with the module and on the Python path, every query's AP
    at the ten IoU thresholds (metrics.average_precision_detection, as
    compute_mr_ap calls it) within 1e-9, the mean-pool of every video's
    features to half its length within 1e-5; host ms both ways."""
    import glob

    import numpy as np

    from mesm_tpu_torch import native
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.config import TestOptions
    from mesm_tpu_torch.data.datasets import mean_pool_downsample
    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.metrics import average_precision_detection
    from mesm_tpu_torch.postprocess import temporal_nms
    from mesm_tpu_torch.utils import load_jsonl

    t0 = time.perf_counter()
    built = native.get_native() is not None
    res = {"phase": "native", "built": built, "so_path": os.path.relpath(native.SO_PATH, HERE),
           "so_exists": os.path.exists(native.SO_PATH), "build_and_load_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory(prefix="mesm_chip_native_") as root:
        eval_cfg = write_cli_eval(root)
        inference(["--config_file", eval_cfg, "--compute_dtype", "bfloat16", "--device", "cuda",
                   *PER_BATCH])
        sub_path = [p for p in glob.glob(os.path.join(root, "inference", "**", "*submission*.jsonl"),
                                         recursive=True) if "nms" not in p][0]
        submission = load_jsonl(sub_path)
        opt = TestOptions().parse(["--config_file", eval_cfg, "--device", "cuda"])
        gt = next(iter(R.build_loaders(opt, R.get_vocab(opt))[0].values())).dataset.data
        feats = [np.load(p) for p in sorted(glob.glob(os.path.join(root, "**", "*.npy"),
                                                      recursive=True))][:64]

    def nms():
        return [temporal_nms(e["pred_relevant_windows"], 0.5, 10) for e in submission]

    thds = np.linspace(0.5, 0.95, 10)
    gts = {d["qid"]: [{"video-id": d["qid"], "t-start": w[0], "t-end": w[1]}
                      for w in d["relevant_windows"]] for d in gt}

    def ap():
        return np.array([average_precision_detection(
            gts[e["qid"]], [{"video-id": e["qid"], "t-start": w[0], "t-end": w[1], "score": w[2]}
                            for w in e["pred_relevant_windows"][:10]], thds) for e in submission])

    def pool():
        return [mean_pool_downsample(f, max(f.shape[0] // 2, 1)) for f in feats if f.shape[0] > 1]

    got = {"nms": nms(), "ap": ap(), "pool": pool()}
    ms = {k: _host_ms(fn) for k, fn in (("nms", nms), ("ap", ap), ("pool", pool))}
    with native_off():
        want = {"nms": nms(), "ap": ap(), "pool": pool()}
        ms_numpy = {k: _host_ms(fn) for k, fn in (("nms", nms), ("ap", ap), ("pool", pool))}
    pool_err = max(float(np.abs(a - b).max()) for a, b in zip(got["pool"], want["pool"]))
    ap_err = float(np.abs(got["ap"] - want["ap"]).max())
    res.update({"queries": len(submission), "videos_pooled": len(got["pool"]),
                "nms_equal": got["nms"] == want["nms"], "ap_max_abs_err": ap_err,
                "pool_max_abs_err": pool_err, "host_ms_native": ms, "host_ms_numpy": ms_numpy})
    res["ok"] = bool(built and res["so_exists"] and res["nms_equal"] and ap_err <= 1e-9
                     and pool_err <= 1e-5 and submission and got["pool"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("native phase failed")
    return res


INT8_DENSE_SHAPE = dict(N=24960, K=256, F=1024)  # the charades encoder FFN's linear1


def phase_int8_dense(card: str) -> dict:
    """ops/quant.int8_dense at the charades FFN shape (24,960 x 256 -> 1024,
    bf16) on the card (torch._int_mm) against its plain version computed on
    the card: the int32 sums equal, the outputs within one bf16 ulp; timed
    beside F.linear in bf16."""
    import torch
    import torch.nn.functional as F

    from mesm_tpu_torch.ops import quant

    N, K, Fo = INT8_DENSE_SHAPE["N"], INT8_DENSE_SHAPE["K"], INT8_DENSE_SHAPE["F"]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(N, K, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(Fo, K, generator=g, device="cuda") * 0.05
    b = torch.randn(Fo, generator=g, device="cuda")
    got = quant.int8_dense(x, w, b)
    want = quant.int8_dense_reference(x, w, b)
    xq, _ = quant._quantize(x, -1)
    wq, _ = quant._quantize(w, 1)
    sums_equal = bool(torch.equal(quant._padded_int_mm(xq, wq),
                                  (xq.double() @ wq.double().t()).to(torch.int32)))
    diff = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=2.0**-126))) - 7)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ms = cuda_time_ms(lambda: quant.int8_dense(x, w, b))
    library_ms = cuda_time_ms(lambda: F.linear(x, wb, bb))
    bound_ms, bound_by = bound(N * K * 2 + Fo * K * 4 + Fo * 4 + N * Fo * 2, 2 * N * K * Fo, "int8")
    res = {"phase": "int8_dense", "card": card, "shape": [N, K, Fo], "dtype": "bfloat16",
           "int32_sums_equal": sums_equal, "max_abs_err": float(diff.max()),
           "max_err_in_ulps": float((diff / ulp).max()), "ms": ms, "linear_bf16_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    res["ok"] = bool(sums_equal and bool((diff <= ulp).all()) and got.dtype == torch.bfloat16)
    emit(res)
    if not res["ok"]:
        raise SystemExit("int8_dense phase failed")
    return res


def _epoch_losses(lines) -> dict:
    """The unrounded epoch losses the train entry point logs."""
    for line in lines:
        if "Epoch 1 losses " in line:
            return json.loads(line.split("Epoch 1 losses ", 1)[1])
    return {}


def _first_step_losses(lines) -> dict:
    """The unrounded metrics of the run's first step that the train entry
    point logs."""
    for line in lines:
        if "Step 1 losses " in line:
            return json.loads(line.split("Step 1 losses ", 1)[1])
    return {}


def _step_ms(lines):
    """ms per train step (max, min, avg over the epoch) from the entry
    point's time stats line."""
    import ast

    for line in lines:
        if "train_step_time ==> " in line:
            return {k: float(v) * 1e3 for k, v in ast.literal_eval(line.split("==> ", 1)[1]).items()}
    return None


def phase_distributed(timeout_s: int = 300, nproc: int = 1) -> dict:
    """`torchrun --standalone --nproc_per_node <nproc> -m
    mesm_tpu_torch.train` on the synthetic charades root of phase train_cli
    (one epoch) against the single-process entry point with the same seed
    (and `--n_devices <nproc>`, so both batch the same rows): the process
    group is NCCL on every rank, ms per step both ways (max, min and mean
    over the epoch: the children's first step also starts CUDA, NCCL and
    the kernels' libraries, which this process has warm), and no process is
    left running. With one process the epoch's losses (the loss terms and
    the gradient norm, 1e-6 of max(1, |loss|)) and the two checkpoints
    (1e-6) are equal. With several (one card each; dropout 0 in both runs,
    since each rank draws its own dropout masks) each rank multiplies other
    shapes, so cuBLAS sums in another order and AdamW carries the rounding
    into every later step: the losses' and parameters' largest differences
    are reported, and the ratio diagnostics (class_error*, rec_fw_acc:
    shares of argmaxes) must be equal, which they are only if both runs saw
    the same batches. The algorithm's equality over ranks is held at 1e-6
    on the CPU (tests/test_torch_distributed.py). With any number of
    processes the first step, before AdamW carries any rounding on, is
    bounded: its loss terms and grad_norm (the entry point's "Step 1
    losses" line) within 1e-5 of max(1, |x|) of the single process's."""
    import glob
    import logging
    import signal

    import torch

    from mesm_tpu_torch.train import train

    with tempfile.TemporaryDirectory(prefix="mesm_chip_dist_") as root:
        cfg_path = write_charades_root(root)
        with open(cfg_path) as f:
            cfg = json.load(f)

        if nproc > 1:  # the config's n_devices overrides the command line's
            cfg.update(dropout=0.0, input_dropout=0.0, n_devices=nproc)

        def config(name):
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(dict(cfg, n_epoch=1, stop_score="miou", exp_id=name), f)
            return path

        lines = []

        class Keep(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        handler = Keep(level=logging.INFO)
        logging.getLogger("mesm_tpu_torch.train").addHandler(handler)
        try:
            one = train(["--config_file", config("single"), "--device", "cuda", *PER_BATCH])
        finally:
            logging.getLogger("mesm_tpu_torch.train").removeHandler(handler)
        torch.cuda.synchronize()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(nproc), "-m", "mesm_tpu_torch.train", "--config_file", config("torchrun"),
               "--device", "cuda", *PER_BATCH]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                start_new_session=True,
                                env=dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="4"))
        try:
            out = proc.communicate(timeout=timeout_s)[0].decode(errors="replace")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall_s = time.perf_counter() - t0
        child = out.splitlines()
        dirs = glob.glob(os.path.join(os.path.dirname(one["opt"].result_dir), "*-torchrun-*"))
        params_err = None
        if proc.returncode == 0 and len(dirs) == 1:
            two = torch.load(os.path.join(dirs[0], "model_latest.ckpt"), map_location="cpu",
                             weights_only=False)["model"]
            params_err = max(float((two[k] - v.detach().cpu()).abs().max())
                             for k, v in one["model"].state_dict().items())
    single, dist_losses = _epoch_losses(lines), _epoch_losses(child)
    first_single, first_dist = _first_step_losses(lines), _first_step_losses(child)
    first_err = (max(abs(first_single[k] - first_dist[k]) / max(1.0, abs(first_single[k]))
                     for k in first_single if k.startswith("loss") or k == "grad_norm")
                 if first_single and set(first_single) == set(first_dist) else None)
    same_keys = bool(single) and set(single) == set(dist_losses)
    loss_err = (max(abs(single[k] - dist_losses[k]) / max(1.0, abs(single[k]))
                    for k in single if k.startswith("loss") or k == "grad_norm")
                if same_keys else None)
    ratios = ({k: [single[k], dist_losses[k]] for k in single
               if not (k.startswith("loss") or k == "grad_norm")} if same_keys else None)
    left = live_descendants()
    res = {"phase": "distributed", "nproc": nproc, "returncode": proc.returncode,
           "torchrun_wall_s": wall_s,
           "nccl": sum(f"backend nccl, world {nproc}," in line for line in child) == nproc,
           "gloo": any("backend gloo" in line for line in child),
           "steps": one["step"], "loss_max_err_rel_to_max1": loss_err,
           "first_step_max_err_rel_to_max1": first_err, "first_step_tol": 1e-5,
           "ratio_terms_single_torchrun": ratios, "params_max_abs_err": params_err,
           "ms_per_step_single": _step_ms(lines), "ms_per_step_torchrun": _step_ms(child),
           "left_running": left, "tol": 1e-6}
    if nproc == 1:
        same = loss_err is not None and loss_err <= 1e-6 and params_err is not None \
            and params_err <= 1e-6
    else:
        same = bool(ratios) and all(a == b for a, b in ratios.values()) \
            and params_err is not None and math.isfinite(params_err)
    same = same and first_err is not None and first_err <= 1e-5
    res["ok"] = bool(proc.returncode == 0 and res["nccl"] and not res["gloo"] and same and not left)
    if not res["ok"]:
        res["child_tail"] = child[-30:]
    emit(res)
    if not res["ok"]:
        raise SystemExit("distributed phase failed")
    return res


# the shard shapes (stacked rows, local queries) of the sequence-sharded
# TACoS train step's DETR encoder: the global token and 600 / k clips as
# local queries against the 601 gathered keys, at k = 2 and 4 model ranks
# of one data rank (32 stacked rows) and at 2 data x 2 seq ranks (16)
SEQ_SHARD_SHAPES = ((32, 301), (32, 151), (16, 301))


def _seq_shard_inputs(B: int, Lq: int, seed: int):
    """q (B, Lq, E) and k, v (B, 601, E) in fp32 at a TACoS stacked train
    shape, a cotangent of the output, and the key mask the gathered TACoS
    batch gives data rank 0 (the global token never a key, each row's padded
    clips masked, the stack's two halves the same videos)."""
    import torch

    from mesm_tpu_torch.scripts import synthetic

    Lk, E = TACOS["L"], TACOS["E"]
    # the masks of scripts/synthetic.make_train_batch(0, ...) follow the seed
    # alone, not the feature width
    vm = synthetic.make_train_batch(0, TACOS["B"], TACOS["Lv"], 8, TACOS["Lw"], TACOS["Dt"], 1112,
                                    device="cuda")["video_mask"][:B // 2]
    mask = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device="cuda"),
                      torch.cat([vm, vm], 0)], dim=1)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda")
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda") for _ in range(2))
    cot = torch.randn(B, Lq, E, generator=g, device="cuda")
    return q, k, v, cot, mask


def check_seq_shard_kernels() -> list:
    """Kernel 6 (the fp32 batched forward) and kernel 9's backward at each
    shard shape of SEQ_SHARD_SHAPES against their plain versions (phase
    `kernels`' fp32 tolerance), then timed as PERF.md section 6 rows 6 and 9
    are: the wrapper (CUDA events), the kernel alone (profiler), the plain
    version, SDPA's forward / backward, and the bound."""
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.ops import attention_backward as abw
    from mesm_tpu_torch.ops import attention_batched as ab

    H, E, Lk = TACOS["H"], TACOS["E"], TACOS["L"]
    hd = E // H
    out = []
    for B, Lq in SEQ_SHARD_SHAPES:
        q, k, v, cot, mask = _seq_shard_inputs(B, Lq, seed=B * Lq)
        am = _sdpa_mask(mask)

        def sdpa(a, b, c):
            qh = a.view(B, Lq, H, hd).transpose(1, 2)
            kh, vh = (t.view(B, Lk, H, hd).transpose(1, 2) for t in (b, c))
            return Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am).transpose(1, 2) \
                .reshape(B, Lq, E)

        fwd = ab.attention_batched(q, k, v, H, mask)
        want = ab.attention_batched_reference(q, k, v, H, mask)
        bwd = abw.attention_backward(q, k, v, fwd, cot, H, mask)
        bwant = abw.attention_backward_reference(q, k, v, cot, H, mask)
        torch.cuda.synchronize()
        f_err, b_errs = _rel_err(fwd, want), [_rel_err(a, r) for a, r in zip(bwd, bwant)]
        f = {"kernel": "attention_batched", "dtype": "float32", "shape": [B, Lq, Lk, E, H],
             "max_abs_err": float((fwd - want).abs().max()), "max_err_rel_to_max1": f_err,
             "tol": TOL["attention_batched_float32"], "finite": bool(torch.isfinite(fwd).all())}
        b = {"kernel": "attention_backward", "dtype": "float32", "shape": [B, Lq, Lk, E, H],
             "max_abs_err": max(float((a - r).abs().max()) for a, r in zip(bwd, bwant)),
             "max_err_rel_to_max1": dict(zip(("dq", "dk", "dv"), b_errs)),
             "tol": TOL["attention_backward"], "finite": all(bool(torch.isfinite(t).all()) for t in bwd)}
        if not (f_err <= f["tol"] and f["finite"] and max(b_errs) <= b["tol"] and b["finite"]):
            emit({"phase": "seq_sharding", "kernels": [f, b], "ok": False})
            raise SystemExit(f"seq-shard kernels at B {B}, Lq {Lq}: {f} {b}")
        del want, bwd, bwant
        f["ms"] = cuda_time_ms(lambda: ab.attention_batched(q, k, v, H, mask))
        f["kernel_ms"] = device_kernel_ms(lambda: ab.attention_batched(q, k, v, H, mask),
                                          ENCODER_KERNEL_NAMES["attention_batched"]["float32"])
        f["plain_ms"] = cuda_time_ms(lambda: ab.attention_batched_reference(q, k, v, H, mask))
        f["library_ms"] = cuda_time_ms(lambda: sdpa(q, k, v))
        # q and out (B, Lq, E), k and v (B, Lk, E), the mask: read / written once
        moved = 2 * B * Lq * E * 4 + 2 * B * Lk * E * 4 + B * Lk
        f["bound_ms"], f["bound_by"], f["bound_fp32_ms"] = attention_bound(B, H, Lq, Lk, hd, moved,
                                                                           "float32")

        def call():
            return abw.attention_backward(q, k, v, fwd, cot, H, mask)

        b["ms"] = cuda_time_ms(call, iters=10)
        b["kernel_ms"] = device_kernel_ms(call, "attention_backward_", iters=10)
        b["plain_ms"] = cuda_time_ms(lambda: abw.attention_backward_reference(q, k, v, cot, H, mask),
                                     iters=10)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = sdpa(*leaves)
        b["library_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(o, leaves, cot, retain_graph=True), iters=10)
        del o, leaves
        # q, O, d_out, dq (B, Lq, E) and k, v, dk, dv (B, Lk, E) once, the
        # mask; five products (S, dP, dV, dQ, dK), each three TF32 products
        moved = 4 * B * Lq * E * 4 + 4 * B * Lk * E * 4 + B * Lk
        flops = 5 * 2.0 * B * H * Lq * Lk * hd
        b["bound_ms"], b["bound_by"] = bound(moved, 3 * flops, "tf32")
        b["bound_fp32_ms"], _ = bound(moved, flops, "float32")
        out += [f, b]
    return out


def _seq_step_child(args: list, nproc: int, out_path: str, timeout_s: int) -> dict:
    """`python -m mesm_tpu_torch.scripts.seq_step` in a process of its own
    (nproc 1) or under torchrun on nproc cards: its report, or the end of
    its output on failure."""
    import signal

    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                 str(nproc)] if nproc > 1 else [sys.executable])
    cmd = launcher + ["-m", "mesm_tpu_torch.scripts.seq_step", "--out", out_path] + args
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="4"))
    try:
        log = proc.communicate(timeout=timeout_s)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out_path):
        return {"returncode": proc.returncode, "wall_s": wall_s, "tail": log.splitlines()[-30:]}
    with open(out_path) as f:
        return dict(json.load(f), returncode=0, wall_s=wall_s)


def phase_seq_sharding(card: str, nproc: Optional[int] = None, timeout_s: int = 600) -> dict:
    """Sequence sharding of the TACoS kernel-engaged fp32 train step
    (parallel/seq.py). On any card count: kernels 6 and 9's backward at the
    shard shapes (check_seq_shard_kernels). With at least two cards:
    `torchrun --nproc_per_node <nproc>` (default 2: 1 data x 2 seq ranks;
    4: 2 data x 2 seq) of scripts/seq_step.py on NCCL against the same step
    in one process on the same batch: the first step's loss terms and
    grad_norm within 1e-5 of max(1, |x|), kernel 6 and kernel 9's backward
    launched twice a step on every rank (the two encoder layers), each
    rank's peak memory beside the one process's, ms a step. With one card
    the line says that the multi-card half did not run (seq_ranks_run 1)."""
    import torch

    from mesm_tpu_torch.scripts.seq_step import STEPS as steps

    res = {"phase": "seq_sharding", "card": card, "cards": torch.cuda.device_count(),
           "kernels": check_seq_shard_kernels()}
    nproc = nproc or (2 if res["cards"] >= 2 else 1)
    if nproc < 2:
        res.update(seq_ranks_run=1, multi_card="not run: one card; the seq-sharded step "
                   "needs one card per rank (torchrun --nproc_per_node 2)", ok_kernels=True,
                   ok_multi_card=None)
        emit(res)
        return res
    if nproc > res["cards"]:
        raise SystemExit(f"seq_sharding: {nproc} ranks asked for, {res['cards']} cards")
    data = 2 if nproc >= 4 else 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mesm_chip_seq_") as tmp:
        single = _seq_step_child([], 1, os.path.join(tmp, "single.json"), timeout_s)
        sharded = _seq_step_child(["--data", str(data)], nproc, os.path.join(tmp, "sharded.json"),
                                  timeout_s)
    res.update(seq_ranks_run=nproc // data, data_ranks=data, nproc=nproc, steps=steps,
               single=single, sharded=sharded, tol=1e-5)
    ok = single.get("returncode") == 0 and sharded.get("returncode") == 0
    if ok:
        want, got = single["first_step"], sharded["first_step"]
        res["first_step_max_err_rel_to_max1"] = max(
            abs(got[k] - w) / max(1.0, abs(w)) for k, w in want.items()
            if k.startswith("loss") or k == "grad_norm")
        per_step = {"attention_batched": 2, "attention_trainable": 2, "attention_backward": 2}
        res["launches_expected_per_rank"] = {k: n * steps for k, n in per_step.items()}
        res["launches_ok"] = all(r["launches"] == res["launches_expected_per_rank"]
                                 for r in sharded["ranks"] + single["ranks"])
        res["peak_mem_gib_single"] = single["ranks"][0]["peak_mem_gib"]
        res["peak_mem_gib_per_rank"] = [r["peak_mem_gib"] for r in sharded["ranks"]]
        res["ms_per_step_single"] = single["ranks"][0]["ms_per_step"]
        res["ms_per_step_per_rank"] = [r["ms_per_step"] for r in sharded["ranks"]]
        ok = (res["first_step_max_err_rel_to_max1"] <= 1e-5 and res["launches_ok"]
              and sharded["backend"] == "nccl" and sharded["world"] == nproc
              and math.isfinite(sharded["last_loss"]))
    res["left_running"] = live_descendants()
    res["ok_kernels"] = True
    res["ok_multi_card"] = res["ok"] = bool(ok and not res["left_running"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("seq_sharding phase failed")
    return res


def live_descendants() -> list:
    """Processes started by this one (or by its children) that still run,
    as (pid, command line), read from /proc. Zombies are left out: they end
    with this process."""
    parent, state = {}, {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue  # ended while we looked
        state[pid], parent[pid] = fields[0], fields[1]
    found, frontier = [], {str(os.getpid())}
    while frontier:
        frontier = {pid for pid, pp in parent.items() if pp in frontier}
        found += [pid for pid in frontier if state[pid] != "Z"]
    out = []
    for pid in found:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out.append((int(pid), f.read().replace(b"\0", b" ").decode(errors="replace")[:120]))
        except OSError:
            continue
    return out


def phase_processes() -> dict:
    """Fails if a phase left a process running (a loader or metric worker
    pool, a compiler): the script must stop everything it starts."""
    left = live_descendants()
    res = {"phase": "processes", "left_running": left, "ok": not left}
    emit(res)
    if left:
        raise SystemExit(f"processes still running: {left}")
    return res


# the coalesced eval step at the bench geometry: K batches of 128 rows (53
# videos of 194 clips) a graph replay, timed in alternating turns of
# `groups` groups each; the Charades-STA test split (1,334 videos, 3,720
# sentences) for the evaluate entry point at the shipped config's batches
COALESCE = dict(K=8, G=8, groups=4, turns=("per_batch", "graph", "graph", "per_batch"),
                cli_turns=("per_batch", "default", "default", "per_batch",
                           "per_batch_one_bucket", "k32_one_bucket"))
# phase coalesce (b)'s runs of the evaluate CLI: its arguments and the
# changes to the shipped config's eval settings (4 length buckets)
COALESCE_BUCKETS = 4
COALESCE_CLI_RUNS = {"per_batch": (PER_BATCH, {}), "default": ([], {}),
                     "per_batch_one_bucket": (PER_BATCH, {"eval_len_buckets": 1}),
                     "k32_one_bucket": (["--eval_coalesce", "32"], {"eval_len_buckets": 1})}
CHARADES_TEST = dict(videos=1334, sentences=3720)


def coalesced_launches(mode: str, K: int) -> dict:
    """Kernel launches of one coalesced group of K charades batches in a
    dispatch mode: the hoisted input projection once a group, every other
    site once a batch (CHARADES_LAUNCHES)."""
    per = {name: n * K for name, n in CHARADES_LAUNCHES[mode].items()}
    per["ln_dense"] = 1
    return per


# the device kernels (a part of their names) that each counted wrapper
# launches on the coalesced eval paths: bf16 and fp32 charades, "auto" and
# "auto+kernel"
GRAPH_KERNELS = {"ln_dense": ("ln_dense_wgmma_kernel",),
                 "attention_packed": ("attention_packed_mma_kernel",
                                      "attention_packed_3xtf32_kernel"),
                 "attention_batched": ("attention_batched_",),
                 "attention_shortkey_onematmul": ("attention_shortkey_onematmul_",)}


def graph_kernel_nodes(graph) -> dict:
    """The kernel nodes of a captured torch.cuda.CUDAGraph (kept with
    keep_graph=True) by kernel name: the kernels each replay launches, read
    from the graph through libcuda (cuGraphGetNodes,
    cuGraphKernelNodeGetParams_v2, cuKernelGetName or cuFuncGetName); child
    graphs are walked."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUresult {rc}")

    counts = {}

    def walk(g):
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
            if kind.value == 4:  # CU_GRAPH_NODE_TYPE_GRAPH
                child = ctypes.c_void_p()
                check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                      "cuGraphChildGraphNodeGetGraph")
                walk(child)
            elif kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                p = Params()
                check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
                      "cuGraphKernelNodeGetParams_v2")
                name = ctypes.c_char_p()
                if not (p.kern and cu.cuKernelGetName(ctypes.byref(name),
                                                      ctypes.c_void_p(p.kern)) == 0):
                    check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)),
                          "cuFuncGetName")
                key = name.value.decode()
                counts[key] = counts.get(key, 0) + 1

    walk(ctypes.c_void_p(graph.raw_cuda_graph()))
    return counts


class GraphCensus:
    """The kernel launches of the coalesced eval step's CUDA graph replays,
    measured. The wrappers' counters move when a graph is captured, where
    nothing launches, and not when it is replayed, where its kernels do
    launch. So at each capture (parallel/step.CoalescedEvalStep._capture,
    wrapped while the census is open) this keeps the counters' moves
    during the captured run and the graph's kernel nodes
    (graph_kernel_nodes); the port counts each graph's replays
    (_Graph.replays). `device_launches(counted)` turns a counter reading
    over the same span into the kernels launched on the device: the
    captured runs' counts out, each graph's nodes times its replays in.
    `ok()`: every capture recorded, for each counted wrapper, as many kernel
    nodes of that wrapper's kernel (GRAPH_KERNELS) as the wrapper counted."""

    def __enter__(self):
        from mesm_tpu_torch.parallel import step as tstep

        self._cls, self._orig, self.records = tstep.CoalescedEvalStep, None, []
        orig = self._orig = self._cls._capture
        records = self.records

        def capture(step, key, staged):
            runs, inner = [], step.run

            def run(*args, **kwargs):  # the warm-up run, then the captured one
                before = read_launches()
                out = inner(*args, **kwargs)
                after = read_launches()
                runs.append({n: after[n] - before[n] for n in after})
                return out

            step.run = run
            try:
                entry = orig(step, key, staged)
            finally:
                del step.run
            nodes = graph_kernel_nodes(entry.graph)
            by_wrapper = {n: sum(c for name, c in nodes.items()
                                 if any(k in name for k in GRAPH_KERNELS.get(n, ("?",))))
                          for n in runs[-1]}
            records.append({"entry": entry, "captured": runs[-1], "nodes": by_wrapper,
                            "kernel_nodes": sum(nodes.values())})
            return entry

        self._cls._capture = capture
        return self

    def __exit__(self, *exc):
        self._cls._capture = self._orig

    def ok(self) -> bool:
        return bool(self.records) and all(r["nodes"] == r["captured"] for r in self.records)

    def device_launches(self, counted: dict) -> dict:
        out = dict(counted)
        for r in self.records:
            for n, c in r["captured"].items():
                out[n] += r["nodes"][n] * r["entry"].replays - c
        return out

    def summary(self) -> dict:
        """Per graph: the kernel nodes in all, the counted wrappers' nodes
        and captured counts (where either is not 0), and the replays."""
        return {"graphs": len(self.records), "nodes_equal_captured_counts": self.ok(),
                "per_graph": [{"kernel_nodes": r["kernel_nodes"], "replays": r["entry"].replays,
                               "nodes": {n: c for n, c in r["nodes"].items() if c},
                               "captured": {n: c for n, c in r["captured"].items() if c}}
                              for r in self.records]}


def _coalesce_step_part(card: str) -> dict:
    """(a) The K-batch superbatch graph against K eager per-batch calls at
    the bench geometry, bf16, in "auto" and "auto+kernel": the largest
    prediction difference (must be 0: the same kernels on the same rows,
    kernel 1's rows independent of their address; within MODEL_TOL as
    well), the replay against the same coalesced step run eagerly (must be
    0: capture changes nothing), the launches of a replay from the graph's
    kernel nodes (GraphCensus, equal to the wrappers' counts at capture and
    to CHARADES_LAUNCHES), rows/s both ways in alternating turns, the busy
    share and peak memory (kernel 1 at the hoisted shape, K * 53 * 194
    rows, is held in phase `kernels`)."""
    import torch

    from mesm_tpu_torch.data.pipeline import stage_batch, stage_superbatch, staged_signature
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel import step as tstep
    from mesm_tpu_torch.parallel.step import make_eval_step
    from mesm_tpu_torch.scripts.synthetic import encode_cached

    K, groups = COALESCE["K"], COALESCE["groups"]
    torch.manual_seed(0)
    model = MESM(_model_config()).cuda().eval()
    # one SS group width for all K batches: a superbatch takes one shape
    hosts = [{k: v.cpu().numpy() for k, v in make_eval_batch(s, G=COALESCE["G"]).items()}
             for s in range(K)]
    per = [stage_batch(h, True, "cuda") for h in hosts]
    B = per[0]["video_mask"].shape[0]
    one = make_eval_step(model, encode_cached, torch.bfloat16)
    res = {"K": K, "rows_per_batch": B, "card": card, "modes": {}}
    ok = True
    for mode in ("auto", "auto+kernel"):
        step = make_eval_step(model, encode_cached, torch.bfloat16, coalesce=K)
        with dispatch_mode(mode), GraphCensus() as census:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.max_memory_allocated()
            sb = stage_superbatch(hosts, True, "cuda", into=step.static_inputs)
            captured0 = tstep.graphs_captured
            reset_launches()
            got = {k: v.clone() for k, v in step(sb).items()}
            torch.cuda.synchronize()
            counted = read_launches()
            first = census.device_launches(counted)  # one replay so far
            peak = torch.cuda.max_memory_allocated()
            sb = stage_superbatch(hosts, True, "cuda", into=step.static_inputs)
            staged_in_place = all(sb[k] is t
                                  for k, t in step.static_inputs(staged_signature(sb)).items())
            replayed = step(sb)
            refs = [one(b) for b in per]
            torch.cuda.synchronize()
            diff = max(float((got[k][j].float() - refs[j][k].float()).abs().max())
                       for j in range(K) for k in refs[j])
            rel = max(max(_pred_err({k: got[k][j] for k in got}, refs[j]).values())
                      for j in range(K))
            same_replay = all(torch.equal(replayed[k], got[k]) for k in got)
            # the same K bodies and hoist run eagerly: what capture changes
            eager = step.run(sb)
            eager_diff = max(float((eager[k].float() - got[k].float()).abs().max()) for k in got)
            want = expected_launches(coalesced_launches(mode, K), 1)
            (rec,) = census.records
            r = {"graphs_captured": tstep.graphs_captured - captured0,
                 "launches_per_replay": rec["nodes"], "launches_per_replay_expected": want,
                 "counted_at_capture": rec["captured"], "kernel_nodes": rec["kernel_nodes"],
                 "launches_first_call": first,
                 "max_abs_diff_vs_per_batch": diff,
                 "max_err_vs_per_batch": rel, "tol": MODEL_TOL, "replay_repeats": same_replay,
                 "max_abs_diff_replay_vs_eager_coalesced": eager_diff,
                 "staged_into_graph_inputs": staged_in_place,
                 "peak_mem_gib": (peak - base) / 2**30}
            r["ok"] = bool(r["graphs_captured"] == 1 and rel <= MODEL_TOL and diff == 0.0
                           and same_replay and eager_diff == 0.0 and staged_in_place and census.ok()
                           and rec["nodes"] == want)
            turns = []
            for how in COALESCE["turns"]:
                fn = ((lambda: step(sb)) if how == "graph"
                      else (lambda: [one(b) for b in per]))
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(groups):
                    fn()
                torch.cuda.synchronize()
                turns.append((how, B * K * groups / (time.perf_counter() - t0)))
            r["rows_per_s_per_batch"] = [x for h, x in turns if h == "per_batch"]
            r["rows_per_s_graph"] = [x for h, x in turns if h == "graph"]
            pg = profile_step(step, [sb], iters=3)
            pb = profile_step(one, per, iters=K)
            r["graph_profile"] = {"wall_ms_per_batch": pg["wall_ms_per_step"] / K,
                                  "device_ms_per_batch": pg["device_ms_per_step"] / K,
                                  "busy_share": pg["busy_share"],
                                  "kernels_per_batch": pg["kernel_launches_per_step"] / K}
            r["per_batch_profile"] = {"wall_ms_per_batch": pb["wall_ms_per_step"],
                                      "device_ms_per_batch": pb["device_ms_per_step"],
                                      "busy_share": pb["busy_share"],
                                      "kernels_per_batch": pb["kernel_launches_per_step"]}
        res["modes"][mode] = r
        ok = ok and r["ok"]
        del step, sb, got, replayed, refs, eager, census, rec
    res["hoist_rowwise"] = _hoist_rowwise(model, per)
    res["capture_failure_raises"] = _capture_failure_raises(model, hosts[:2])
    res["ok"] = bool(ok and res["capture_failure_raises"]
                     and res["hoist_rowwise"]["ln_dense_max_abs_diff"] == 0.0)
    return res


def _hoist_rowwise(model, per) -> dict:
    """Where the hoist could move a bit: the input projection of the K
    batches' unique videos in one call against batch by batch, on the card
    in "auto": its fused LayerNorm -> Dense block alone (row-wise, and the
    same bits at any row address: must be 0), and the whole projection (its
    second block a LayerNorm and a cuBLAS GEMM over K times the rows,
    reported). Max abs differences."""
    import torch

    from mesm_tpu_torch.ops.ln_dense import ln_dense

    blk, proj = model.input_vid_proj[0], model.input_vid_proj[0].net[1]
    with torch.no_grad():
        rows = [b["video_feat_g"].reshape(-1, b["video_feat_g"].shape[-1]) for b in per]
        whole_rows = torch.cat(rows)

        def fused(x):
            return ln_dense(x, blk.LayerNorm.weight, blk.LayerNorm.bias, proj.weight, proj.bias,
                            relu=blk.relu)

        one, whole = torch.cat([fused(r) for r in rows]), fused(whole_rows)
        p_one = torch.cat([model.input_vid_proj(r) for r in rows])
        p_whole = model.input_vid_proj(whole_rows)
    return {"rows": int(whole_rows.shape[0]),
            "ln_dense_max_abs_diff": float((one.float() - whole.float()).abs().max()),
            "projection_max_abs_diff": float((p_one.float() - p_whole.float()).abs().max())}


def _capture_failure_raises(model, hosts) -> bool:
    """A body that syncs with the host (a .item() on the card) cannot be
    captured: the coalesced step must raise, not run eagerly instead."""
    import torch

    from mesm_tpu_torch.data.pipeline import stage_superbatch
    from mesm_tpu_torch.parallel import step as tstep
    from mesm_tpu_torch.parallel.step import make_eval_step
    from mesm_tpu_torch.scripts.synthetic import encode_cached

    def syncing(b):
        float(b["cached_sentence_feat"].sum())  # a device-to-host copy
        return encode_cached(b)

    step = make_eval_step(model, syncing, torch.bfloat16, coalesce=len(hosts))
    before = tstep.graphs_captured
    try:
        step(stage_superbatch(hosts, True, "cuda"))
    except RuntimeError:
        torch.cuda.synchronize()
        return tstep.graphs_captured == before
    return False


def _submission_rows(result_root: str) -> list:
    import glob

    paths = sorted(glob.glob(os.path.join(result_root, "**", "*_submission.jsonl"), recursive=True))
    rows = []
    for path in paths:
        with open(path) as f:
            rows.extend(f.read().splitlines())
    return rows


def _coalesce_cli_part() -> dict:
    """(b) `evaluate.inference` on a synthetic charades root at the size of
    the Charades-STA test split, the shipped config's batches, bf16 "auto",
    in the turns of COALESCE["cli_turns"] (COALESCE_CLI_RUNS): with
    --eval_coalesce 1 and with the default (auto: 32 capped at the batches
    per bucket), then both in one length bucket, where the default cap
    leaves K = 32 (--eval_coalesce 32). Brief metrics 0.0 apart and equal
    submissions within the 4-bucket runs and within the 1-bucket runs, one
    graph per warmed bucket, warm-up and eval seconds, peak memory (loader,
    staging and graphs included), and the launches on the device
    (GraphCensus: each graph's kernel nodes times its replays)."""
    import re

    import torch

    from mesm_tpu_torch.evaluate import inference
    from mesm_tpu_torch.parallel import step as tstep

    res = {how: [] for how in COALESCE_CLI_RUNS}
    briefs, subs = {}, {}
    with tempfile.TemporaryDirectory(prefix="mesm_chip_coalesce_") as root:
        t0 = time.perf_counter()
        eval_cfg = write_cli_eval(root, n_videos=CHARADES_TEST["videos"],
                                  n_sentences=CHARADES_TEST["sentences"], shipped_batches=True)
        res["setup_s"] = time.perf_counter() - t0
        for turn, how in enumerate(COALESCE["cli_turns"]):
            args, changes = COALESCE_CLI_RUNS[how]
            with open(eval_cfg) as f:
                cfg = json.load(f)
            cfg.update(changes, inference_id=f"coalesce_{turn}",
                       inference_result_dir=os.path.join(root, f"inference_{turn}"))
            path = os.path.join(root, f"eval_{turn}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_launches()
            captured0, replays0 = tstep.graphs_captured, tstep.graph_replays
            t0 = time.perf_counter()
            with _captured_logs("mesm_tpu_torch.evaluate", "INFO") as lines, \
                    GraphCensus() as census:
                metrics, _ = inference(["--config_file", path, "--compute_dtype", "bfloat16",
                                        "--device", "cuda", *args])
                torch.cuda.synchronize()
            r = {"inference_s": time.perf_counter() - t0,
                 "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                 "buckets": cfg.get("eval_len_buckets", COALESCE_BUCKETS),
                 "counted": read_launches(),
                 "graphs_captured": tstep.graphs_captured - captured0,
                 "graph_replays": tstep.graph_replays - replays0,
                 "census": census.summary()}
            r["launches"] = census.device_launches(r["counted"])
            r["census_ok"] = census.ok() if r["graphs_captured"] else not census.records
            del census
            for line in lines:
                m = re.search(r"eval wall time ([0-9.]+)s \(K = (\d+)\)", line)
                if m:
                    r["eval_wall_s"], r["K"] = float(m.group(1)), int(m.group(2))
                m = re.search(r"Warmed the eval step on (\d+) shapes .* in ([0-9.]+)s", line)
                if m:
                    r["warmed_shapes"], r["warm_s"] = int(m.group(1)), float(m.group(2))
            group = r["buckets"]
            subs.setdefault(group, []).append(_submission_rows(cfg["inference_result_dir"]))
            briefs.setdefault(group, []).append(metrics["brief"])
            res[how].append(r)
        res["rows"] = CHARADES_TEST["sentences"]
        res["brief"] = briefs[COALESCE_BUCKETS][0]
        res["brief_max_diff"] = {
            f"{g}_buckets": max(abs(float(b[k]) - float(v)) for b in bs[1:]
                                for k, v in bs[0].items()
                                if v is not None and b.get(k) is not None)
            for g, bs in briefs.items()}
        res["submissions_equal"] = all(s_ == ss[0] for ss in subs.values() for s_ in ss[1:])
        coalesced = [d for how, (args, _) in COALESCE_CLI_RUNS.items() if args != PER_BATCH
                     for d in res[how]]
        per_batch = [d for how, (args, _) in COALESCE_CLI_RUNS.items() if args == PER_BATCH
                     for d in res[how]]
        res["ok"] = bool(all(b == bs[0] for bs in briefs.values() for b in bs)
                         and res["submissions_equal"]
                         and all(d.get("K", 1) > 1 and d["graphs_captured"] >= 1
                                 and d["graphs_captured"] == d.get("warmed_shapes")
                                 and d["census_ok"] for d in coalesced)
                         and all(d["K"] == 32 for d in res["k32_one_bucket"])
                         and all(p["graphs_captured"] == 0 for p in per_batch))
    return res


def _coalesce_train_part() -> dict:
    """(c) The trainer: two epochs on the synthetic charades root, fp32,
    each followed by its coalesced eval (2 length buckets: K = 5). The
    second epoch's eval, replayed from graphs captured after the first
    epoch's updates, must equal a per-batch eval (--eval_coalesce 1's step)
    of the final weights: losses and metrics. A graph replaying the first
    epoch's derived weights would not."""
    import torch

    from mesm_tpu_torch import runner
    from mesm_tpu_torch.evaluate import eval_epoch
    from mesm_tpu_torch.parallel import step as tstep
    from mesm_tpu_torch.parallel.step import make_eval_step
    from mesm_tpu_torch.train import _weight_map, train
    from mesm_tpu_torch.utils import AverageMeter

    with tempfile.TemporaryDirectory(prefix="mesm_chip_coalesce_train_") as root:
        cfg_path = write_charades_root(root)
        with open(cfg_path) as f:
            cfg = json.load(f)
        # 16-row batches: ~10 eval batches over 2 buckets, so K = 5
        cfg.update(n_epoch=2, stop_score="miou", exp_id="chip_smoke_coalesce",
                   eval_len_buckets=2, row_capacity=16)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        captured0, replays0 = tstep.graphs_captured, tstep.graph_replays
        t0 = time.perf_counter()
        with _without_tensorboard(), GraphCensus() as census:
            run = train(["--config_file", cfg_path, "--device", "cuda"])
            torch.cuda.synchronize()
        res = {"train_s": time.perf_counter() - t0, "steps": run["step"],
               "graphs_captured": tstep.graphs_captured - captured0,
               "graph_replays": tstep.graph_replays - replays0, "census": census.summary()}
        census_ok = census.ok()
        del census
        opt, model = run["opt"], run["model"]
        with open(opt.eval_log_filepath) as f:
            logged = f.read().strip().splitlines()
        res["evals"] = len(logged)
        last = logged[-1]
        logged_losses = last.split("[Loss]")[1].split("[Metrics]")[0].split()
        logged_metrics = json.loads(last.split("[Metrics]")[1].strip())
        # the per-batch eval of the final weights, as --eval_coalesce 1 runs it
        device = torch.device("cuda")
        dtype = runner.compute_dtype_from_opt(opt)
        vocab = runner.get_vocab(opt)
        loaders = runner.build_loaders(opt, vocab)[0]
        encode = runner.build_text_encoder(opt, vocab, device, dtype)
        step = make_eval_step(model, encode, dtype, runner.build_criterion_config(opt),
                              with_loss=True, seed=opt.seed)
        split, loader = next(iter(loaders.items()))
        runner.cache_text_features(loader.dataset, encode, device)
        meters = __import__("collections").defaultdict(AverageMeter)
        metrics, _ = eval_epoch(step, loader, opt, "per_batch_reference.jsonl",
                                loader.dataset.data, device, meters)
        weights = _weight_map(opt)
        ref_losses = " ".join(f"{k} {v.avg * weights.get(k, 1.0):.4f}" for k, v in meters.items())
        res["K"] = runner.eval_coalesce_from_opt(opt, len(loader), device)
        res["losses_equal"] = ref_losses.split() == logged_losses
        res["metrics_equal"] = json.loads(json.dumps(metrics)) == logged_metrics
        res["eval_loss"] = dict(zip(logged_losses[::2], logged_losses[1::2]))
        res["ok"] = bool(res["losses_equal"] and res["metrics_equal"] and res["evals"] == 2
                         and res["K"] > 1 and res["graphs_captured"] >= 2 and census_ok)
    return res


def phase_coalesce(card: str) -> dict:
    """The dispatch-coalesced eval path (parallel/step.CoalescedEvalStep, one
    CUDA graph per length bucket): (a) the step at the bench geometry, (b)
    the evaluate entry point at the Charades-STA test size both ways, (c)
    the trainer's eval across an epoch's updates."""
    step = _coalesce_step_part(card)
    res = {"phase": "coalesce", "card": card, "step": step, "cli": _coalesce_cli_part(),
           "train": _coalesce_train_part()}
    res["ok"] = bool(step["ok"] and res["cli"]["ok"] and res["train"]["ok"])
    emit(res)
    if not res["ok"]:
        raise SystemExit("coalesce phase failed")
    return res


def kernel_summary(kernel_results: dict, launches: dict) -> dict:
    """One entry per kernel and dtype instance, from the check that names it
    (`summary_name`: the shapes of its main path) and the launches of the
    phase that drives that path (main)."""
    by_name = {r["summary_name"]: r for r in kernel_results["results"] if r.get("summary_name")}
    src = "mesm_tpu_torch/kernels/csrc/"
    tpu = "mesm_tpu/ops/attention_pallas.py:"
    meta = {
        "ln_dense": (src + "ln_dense.cu", "mesm_tpu/ops/layer_pallas.py:267"),
        "ln_dense_hoisted": (src + "ln_dense.cu", "mesm_tpu/ops/layer_pallas.py:267"),
        "attention_packed": (src + "attention_packed.cu", tpu + "114"),
        "attention_batched": (src + "attention_batched.cu", tpu + "89"),
        "attention_trainable": ("mesm_tpu_torch/ops/attention_trainable.py", tpu + "571"),
        "attention_backward": (src + "attention_backward.cu", tpu + "599"),
        "attention_packed_pair": (src + "attention_packed.cu", tpu + "170"),
        "attention_shortkey": (src + "attention_shortkey.cu", tpu + "213"),
        "attention_shortkey_onematmul": (src + "attention_shortkey.cu", tpu + "262"),
        "ffn_int8": (src + "ffn_int8.cu", "mesm_tpu/ops/ffn_pallas.py:44"),
        "ffn_int8_float32": (src + "ffn_int8.cu", "mesm_tpu/ops/ffn_pallas.py:44"),
        "attention_per_head": (src + "attention_heads.cu", tpu + "44"),
        "attention_per_head_float32": (src + "attention_heads.cu", tpu + "44"),
        "attention_all_heads": (src + "attention_heads.cu", tpu + "66"),
        "attention_all_heads_float32": (src + "attention_heads.cu", tpu + "66"),
        "attention_batched_bfloat16": (src + "attention_batched.cu", tpu + "89"),
        "attention_packed_float32": (src + "attention_packed.cu", tpu + "114"),
        "attention_packed_pair_float32": (src + "attention_packed.cu", tpu + "170"),
        "attention_shortkey_float32": (src + "attention_shortkey.cu", tpu + "213"),
        "attention_shortkey_onematmul_float32": (src + "attention_shortkey.cu", tpu + "262"),
        "stream_layer_encoder": (src + "stream_layer.cu", "mesm_tpu/ops/layer_pallas.py:107"),
        "stream_layer_t2v": (src + "stream_layer.cu", "mesm_tpu/ops/layer_pallas.py:107"),
        "stream_layer_encoder_float32": (src + "stream_layer.cu", "mesm_tpu/ops/layer_pallas.py:107"),
        "stream_layer_t2v_float32": (src + "stream_layer.cu", "mesm_tpu/ops/layer_pallas.py:107"),
        "layout_anchor": (src + "anchor.cu", "mesm_tpu/ops/anchor.py:27"),
    }
    return {"kernels": [
        {"name": name, "route": "cuda", "source": path, "replaces": rep,
         "launches": launches[name], "max_abs_err": by_name[name]["max_abs_err"],
         "ms": by_name[name]["ms"], "plain_ms": by_name[name]["plain_ms"],
         "bound_ms": by_name[name]["bound_ms"], "bound_by": by_name[name]["bound_by"],
         "library_ms": by_name[name]["library_ms"]}
        for name, (path, rep) in meta.items()
    ]}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mesm_tpu_torch")):
        raise SystemExit("chip_smoke: mesm_tpu_torch/ not found; run from a checkout of the repository")
    sys.path.insert(0, HERE)
    device = phase_device()
    card = device["nvidia_smi"]
    phase_build()
    kernels = phase_kernels()
    head_dims = phase_head_dims(card)
    phase_model(card)
    phase_dot_stats(card)
    phase_profile(card)
    cli = phase_cli()
    phase_native()
    tacos = phase_tacos_eval(card)
    qvh = phase_qvh_eval(card)
    long_query = phase_long_query(card)
    with tempfile.TemporaryDirectory(prefix="mesm_chip_clip_tower_") as tower_dir:
        tower_path = os.path.join(tower_dir, "clip_text_encoder.pth")
        write_clip_tower(tower_path)
        phase_clip(card, tower_path)
        phase_clip_cli(tower_path)
    phase_resume_v1()
    trained = phase_train(card)
    phase_remat(card)
    phase_train_cli()
    phase_distributed()
    phase_seq_sharding(card)
    phase_qvh_train(card)
    int8 = phase_int8_eval(card)
    phase_int8_dense(card)
    variants = phase_attn_variants(card)
    stream = phase_stream_layer(card)
    coalesce = phase_coalesce(card)
    phase_processes()
    # the fp32 body's and the head-dim timings again, short, where the end of
    # the output keeps them
    emit({"phase": "fp32_body_timed", "card": card, "timed": [
        {k: c.get(k) for k in ("shape", "head_dim", "max_err_rel_to_max1", "ms", "kernel_ms",
                               "regtile_ms", "library_ms", "bound_ms", "bound_fp32_ms")}
        for c in kernels["results"] if c.get("body") == "3xtf32"]})
    emit({"phase": "head_dims_timed", "card": card, "timed": [
        {k: c.get(k) for k in ("kernel", "dtype", "head_dim", "shape", "max_err_rel_to_max1", "ms",
                               "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        for c in head_dims["timed"]]})
    print(card, flush=True)
    launches = dict(cli["launches"])
    for name in ("attention_batched", "attention_trainable", "attention_backward"):
        launches[name] = trained["tacos"]["launches"][name]
    launches["attention_shortkey"] = qvh["modes"]["on"]["launches"]["attention_shortkey"]
    launches["attention_shortkey_onematmul"] = (
        qvh["modes"]["auto+kernel"]["launches"]["attention_shortkey_onematmul"])
    launches["attention_packed_pair"] = (
        long_query["modes"]["on"]["launches"]["attention_packed_pair"])
    launches["ffn_int8"] = int8["charades"]["launches"]["ffn_int8"]
    launches["ffn_int8_float32"] = int8["tacos"]["launches"]["ffn_int8"]
    for variant, name in (("per_head", "attention_per_head"), ("all_heads", "attention_all_heads")):
        launches[name] = variants[f"{variant}_charades"]["launches"][name]
    launches["attention_per_head_float32"] = (
        variants["per_head_train_tacos_fp32"]["launches"]["attention_per_head"])
    launches["attention_all_heads_float32"] = (
        variants["all_heads_tacos"]["launches"]["attention_all_heads"])
    launches["attention_batched_bfloat16"] = (
        variants["batched_charades"]["launches"]["attention_batched"])
    launches["attention_packed_float32"] = variants["packed_tacos"]["launches"]["attention_packed"]
    launches["attention_packed_pair_float32"] = (
        variants["packed_on_long_query_fp32"]["launches"]["attention_packed_pair"])
    launches["attention_shortkey_float32"] = (
        variants["packed_on_tacos_fp32"]["launches"]["attention_shortkey"])
    launches["attention_shortkey_onematmul_float32"] = (
        tacos["modes"]["auto+kernel"]["launches"]["attention_shortkey_onematmul"])
    for flavor in ("encoder", "t2v"):
        for dtype_name, suffix in (("bfloat16", ""), ("float32", "_float32")):
            launches[f"stream_layer_{flavor}{suffix}"] = (
                stream[f"bench_{flavor}_{dtype_name}"]["launches"]["stream_layer"])
    launches["layout_anchor"] = stream["model_layers"]["layer_launches"]["layout_anchor"]
    # measured on the device: the graphs' kernel nodes times their replays
    launches["ln_dense_hoisted"] = coalesce["cli"]["default"][0]["launches"]["ln_dense"]
    emit(kernel_summary(kernels, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
