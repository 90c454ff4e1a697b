#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (mesm_tpu_torch) on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the CUDA kernels from
mesm_tpu_torch/kernels/csrc with nvcc, holds each kernel against its plain
torch version at the main paths' shapes, drives charades C+SF_C bf16
inference through the port's eval step and through its
`python -m mesm_tpu_torch.evaluate` entry point (the eval step also in the
"on" mode and with the one-matmul short-key kernel), the TACoS fp32 eval
step, QVHighlights C+SF_C bf16 inference in every dispatch mode, the
charades model with 64-80-word queries (the pair-masked kernel), the
kernel-engaged TACoS fp32 train step (attention dropout 0) with the
kernels on and off, the charades C+SF_C fp32 train step as shipped,
`python -m mesm_tpu_torch.train` on a synthetic root whose checkpoint the
evaluate entry point then scores, and the QVHighlights fp32 train step and
both entry points on a synthetic QVHighlights root, and checks that each
path went through its kernels. Each phase prints one JSON line; the line
before the last is the kernel summary, the last line names the device:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Any failure raises and the script exits non-zero without that line; so does
a host with no GPU. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over the
# peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# kernel-vs-plain tolerances, each in units of max(1, |plain|):
#   ln_dense bf16: 2**-6, two bf16 steps at 1.0 (the output is rounded to bf16,
#     and a sum of 2818 products taken in another order can move it one step);
#   ln_dense fp32: 1e-4 (2818-term f32 sums in another order);
#   attention bf16: 3e-2 abs (bf16 logits, exp and divide; one-step flips).
#   attention fp32: 1e-5 (f32 sums of 601 terms in another order);
#   trainable fp32 gradients: 1e-5 (the same recomputed plain backward).
#   pair-masked and short-key attention bf16: 3e-2 abs (f32 softmax, but the
#     probabilities and the output are rounded to bf16: one-step flips);
#   the one-matmul short-key kernel in fp32: 1e-5 (f32 sums in another order).
TOL = {"ln_dense_bfloat16": 2.0**-6, "ln_dense_float32": 1e-4, "attention_packed": 3e-2,
       "attention_batched": 1e-5, "attention_trainable": 1e-5, "attention_packed_pair": 3e-2,
       "attention_shortkey": 3e-2, "attention_shortkey_onematmul": 3e-2,
       "attention_shortkey_onematmul_float32": 1e-5}
# the model's bf16 predictions with the kernels against (a) kernels off in
# bf16 and (b) the fp32 plain path, in units of max(1, max |reference|) per
# output: the packed kernel's bf16 softmax and the fused LayerNorm -> Dense
# round at other points than the plain path, and bf16 keeps 8 mantissa bits
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
# TACoS (bench.py:753-754, 780-795): 16 rows, 600 clips (601 with the global
# token) of 4098-wide C3D + TEF features, 16 words of 300-d GloVe; the train
# step stacks the negative pass, so its DETR encoder sees 32 rows
TACOS = dict(B=16, Lv=600, Dv=4098, Lw=16, Dt=300, L=601, E=256, H=8)
# kernels on vs off in fp32, in units of max(1, max |off|) per output
FP32_MODEL_TOL = 1e-4
# the train step's first loss, kernels "auto" vs "off": relative; its
# gradients in units of max(1, max |g|) over all parameters. Per parameter
# that scale sits below the step's own fp32 noise: a 1e-7 relative change of
# the input features moves the input projection's gradients by ~6e-4 of
# their own scale on an H100, so the phase reports that floor too.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4


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


def device_kernel_ms(fn, key: str, iters: int = 20):
    """Device time per call of the kernels whose name holds `key`, from
    torch.profiler over `iters` calls after a warm-up: the kernel alone,
    without the host's time between launches (which the CUDA events of
    cuda_time_ms include where a call is shorter than its host overhead).
    None when the profiler sees no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key)
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


def phase_build() -> dict:
    from mesm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    out = {
        "phase": "build", "seconds": time.perf_counter() - t0,
        "kernels": {
            name: {
                "seconds": r["seconds"], "compiled": r["compiled"],
                "ptxas": [l.strip() for l in r["log"].splitlines() if "Used" in l or "spill" in l],
            }
            for name, r in report.items()
        },
    }
    emit(out)
    return out


def _rel_err(got, want) -> float:
    import torch

    g, w = got.float(), want.float()
    return float(((g - w).abs() / torch.clamp(w.abs(), min=1.0)).max())


def check_ln_dense(dtype_name: str, relu: bool, time_it: bool, N: int = MAIN_PATH["N"],
                   D: int = MAIN_PATH["D"]) -> dict:
    import torch

    from mesm_tpu_torch.ops import ln_dense as ld

    dt = getattr(torch, dtype_name)
    F = MAIN_PATH["F"]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(N, D, generator=g, device="cuda") * 2 + 0.3).to(dt)
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
    beta = 0.1 * torch.randn(D, generator=g, device="cuda")
    w = torch.randn(F, D, generator=g, device="cuda") / D**0.5
    b = 0.1 * torch.randn(F, generator=g, device="cuda")
    got = ld.ln_dense(x, gamma, beta, w, b, relu)
    want = ld.ln_dense_reference(x, gamma, beta, w, b, relu)
    torch.cuda.synchronize()
    err = _rel_err(got, want)
    tol = TOL[f"ln_dense_{dtype_name}"]
    res = {
        "kernel": "ln_dense", "dtype": dtype_name, "relu": relu, "shape": [N, D, F],
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "max_err_rel_to_max1": err, "tol": tol, "finite": bool(torch.isfinite(got).all()),
    }
    if not (err <= tol and res["finite"]):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"ln_dense {dtype_name} relu={relu}: error {err} > {tol}")
    if time_it:
        item = x.element_size()
        res["ms"] = cuda_time_ms(lambda: ld.ln_dense(x, gamma, beta, w, b, relu))
        res["plain_ms"] = cuda_time_ms(lambda: ld.ln_dense_reference(x, gamma, beta, w, b, relu))
        res["library_ms"] = None  # no single PyTorch call computes LN -> Dense
        moved = N * D * item + 2 * D * 4 + F * D * 4 + F * 4 + N * F * item
        res["bound_ms"], res["bound_by"] = bound(moved, 2.0 * N * D * F, dtype_name)
    return res


def check_attention(time_it: bool) -> dict:
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.ops import attention_packed as ap

    B, L, E, H = MAIN_PATH["B"], MAIN_PATH["L"], MAIN_PATH["E"], MAIN_PATH["H"]
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(B, L, E, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    lengths = torch.randint(20, L, (B,), generator=g, device="cuda")
    mask = torch.arange(L, device="cuda")[None] <= lengths[:, None]
    mask[:, 0] = False  # the global token is never attendable
    mask[5] = False  # padded rows: every key masked
    mask[77] = False
    got = ap.attention_packed(q, k, v, H, mask)
    want = ap.attention_packed_reference(q, k, v, H, mask)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    finite = bool(torch.isfinite(got).all())
    uniform = float((got[5].float() - v[5].float().mean(0)).abs().max())
    res = {
        "kernel": "attention_packed", "dtype": "bfloat16", "shape": [B, L, E, H],
        "max_abs_err": err, "tol": TOL["attention_packed"], "finite": finite,
        "masked_row_vs_mean_v": uniform,
    }
    if not (err <= TOL["attention_packed"] and finite and uniform <= TOL["attention_packed"]):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"attention_packed: error {err}, finite {finite}, masked row {uniform}")
    if time_it:
        res["ms"] = cuda_time_ms(lambda: ap.attention_packed(q, k, v, H, mask))
        res["plain_ms"] = cuda_time_ms(lambda: ap.attention_packed_reference(q, k, v, H, mask))
        hd = E // H
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
        am = mask[:, None, None, :]
        res["library_ms"] = cuda_time_ms(
            lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
        )
        moved = 4 * B * L * E * 2 + B * L
        res["bound_ms"], res["bound_by"] = bound(moved, 2.0 * B * H * L * L * 2 * hd, "bfloat16")
    return res


def _tacos_qkv(B: int, seed: int):
    """q, k, v at the TACoS encoder shape and a key mask: varied lengths,
    the global token never a key, one padded row with every key masked."""
    import torch

    L, E = TACOS["L"], TACOS["E"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, L, E, generator=g, device="cuda") for _ in range(3))
    lengths = torch.randint(60, L + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(L, device="cuda")[None] < lengths[:, None]
    mask[:, 0] = False
    mask[3] = False
    return q, k, v, mask


def _sdpa_mask(mask):
    """SDPA's boolean mask for the same keys, with no fully masked row (SDPA
    gives NaN there, the kernels the uniform average)."""
    m = mask.clone()
    m[:, 1] = True
    return m[:, None, None, :]


def check_attention_batched(B: int) -> dict:
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.ops import attention_batched as ab

    L, E, H = TACOS["L"], TACOS["E"], TACOS["H"]
    hd = E // H
    q, k, v, mask = _tacos_qkv(B, seed=1)
    with torch.no_grad():
        got = ab.attention_batched(q, k, v, H, mask)
        want = ab.attention_batched_reference(q, k, v, H, mask)
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        res = {
            "kernel": "attention_batched", "dtype": "float32", "shape": [B, L, E, H],
            "max_abs_err": float((got - want).abs().max()), "max_err_rel_to_max1": err,
            "tol": TOL["attention_batched"], "finite": bool(torch.isfinite(got).all()),
            "masked_row_vs_mean_v": float((got[3] - v[3].mean(0)).abs().max()),
        }
        if not (err <= TOL["attention_batched"] and res["finite"]
                and res["masked_row_vs_mean_v"] <= TOL["attention_batched"]):
            emit(dict(res, phase="kernels", ok=False))
            raise SystemExit(f"attention_batched B={B}: {res}")
        res["ms"] = cuda_time_ms(lambda: ab.attention_batched(q, k, v, H, mask))
        res["plain_ms"] = cuda_time_ms(lambda: ab.attention_batched_reference(q, k, v, H, mask))
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
        am = _sdpa_mask(mask)
        res["library_ms"] = cuda_time_ms(
            lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
        )
    moved = 4 * B * L * E * 4 + B * L
    res["bound_ms"], res["bound_by"] = bound(moved, 2.0 * B * H * L * L * 2 * hd, "float32")
    return res


def check_attention_trainable() -> dict:
    """The trainable Function at the stacked train shape (32 rows): forward
    (the batched kernel) plus backward (attention_core recomputed), against
    plain autograd through attention_core and SDPA's forward and backward."""
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.models.attention import attention_core
    from mesm_tpu_torch.ops.attention_trainable import attention_trainable

    B, L, E, H = 2 * TACOS["B"], TACOS["L"], TACOS["E"], TACOS["H"]
    hd = E // H
    q, k, v, mask = _tacos_qkv(B, seed=2)
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
    res["plain_ms"] = cuda_time_ms(lambda: run(plain), iters=10)
    res["library_ms"] = cuda_time_ms(lambda: run(sdpa), iters=10)
    # inputs q, k, v, mask, d_out read once; out, dq, dk, dv written once;
    # the forward's two products and the backward's four (dV, dP, dQ, dK)
    moved = 4 * B * L * E * 8 + B * L
    res["bound_ms"], res["bound_by"] = bound(moved, 6 * 2.0 * B * H * L * L * hd, "float32")
    return res


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


def check_pair_attention(name: str, site: str, B: int, Lq: int, Lk: int, pair: bool,
                         dtype_name: str = "bfloat16", time_it: bool = True, seed: int = 4) -> dict:
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
    tol = TOL[name if dtype_name == "bfloat16" else f"{name}_{dtype_name}"]
    err = _rel_err(got, want)
    dead_err, dead_rows = _dead_rows_vs_mean_v(got, v, mask, pf, H)
    res = {
        "kernel": name, "site": site, "dtype": dtype_name, "shape": [B, Lq, Lk, E, H],
        "pair": pair, "max_abs_err": float((got.float() - want.float()).abs().max()),
        "max_err_rel_to_max1": err, "tol": tol, "finite": bool(torch.isfinite(got).all()),
        "masked_rows": dead_rows, "masked_rows_vs_mean_v": dead_err,
    }
    if not (err <= tol and res["finite"] and dead_rows > 0 and dead_err <= tol):
        emit(dict(res, phase="kernels", ok=False))
        raise SystemExit(f"{name} at {site}: {res}")
    if time_it:
        res["ms"] = cuda_time_ms(lambda: fn(q, k, v, H, mask, pf))
        res["kernel_ms"] = device_kernel_ms(
            lambda: fn(q, k, v, H, mask, pf),
            "attention_packed_kernel" if name == "attention_packed_pair" else "attention_shortkey_kernel",
        )
        res["plain_ms"] = cuda_time_ms(lambda: ref(q, k, v, H, mask, pf))
        am = torch.zeros(B, H, Lq, Lk, dtype=q.dtype, device="cuda").masked_fill(
            _dead_pairs(mask, pf, H, Lq), -1e9)
        qh, kh, vh = (t.view(B, -1, H, hd).transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = cuda_time_ms(
            lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
        )
        item = q.element_size()
        moved = 2 * B * (Lq + Lk) * E * item + B * Lk + (B * H * (Lq + Lk) if pair else 0)
        res["bound_ms"], res["bound_by"] = bound(moved, 2.0 * B * H * Lq * Lk * 2 * hd, dtype_name)
    return res


def phase_kernels() -> dict:
    results = []
    for dtype_name in ("bfloat16", "float32"):
        for relu in (True, False):
            # the main path runs bf16 with ReLU (input_vid_proj.block0)
            results.append(check_ln_dense(dtype_name, relu, time_it=(relu or dtype_name == "float32")))
    # the TACoS eval input projection: fp32, 6 videos x 600 clips of 4098
    results.append(check_ln_dense("float32", True, time_it=True, N=6 * TACOS["Lv"], D=TACOS["Dv"]))
    results.append(check_attention(time_it=True))
    for B in (TACOS["B"], 2 * TACOS["B"]):  # eval, and the stacked train pass
        results.append(check_attention_batched(B))
    results.append(check_attention_trainable())
    for name in ("attention_shortkey", "attention_shortkey_onematmul"):
        for site, B, Lq, Lk, pair in SHORT_KEY_SITES:
            results.append(check_pair_attention(name, site, B, Lq, Lk, pair))
    # the one-matmul kernel in fp32 ("auto" with SHORTKEY_VARIANT "kernel" on
    # an fp32 model, e.g. TACoS: 16 x 600 video queries x 17 text keys)
    results.append(check_pair_attention("attention_shortkey_onematmul", "tacos_fp32", TACOS["B"],
                                        TACOS["Lv"], 17, True, "float32", time_it=False))
    results.append(check_pair_attention("attention_packed_pair", *LONG_KEY_SITE))
    out = {"phase": "kernels", "ok": True, "results": results}
    emit(out)
    return out


def _model_config():
    from mesm_tpu_torch.models.mesm import MESMConfig

    # charades C+SF_C (config/charades/C+SF_C.json) at full width and depth,
    # cached 512-d text features as in the bench geometry (bench.py:740-742)
    return MESMConfig(
        hidden_dim=256, v_feat_dim=2818, t_feat_dim=512, nheads=8, dim_feedforward=1024,
        num_recfw_layers=2, t2v_layers=2, enc_layers=2, dec_layers=2, num_recss_layers=4,
        num_queries=10, max_words_l=16, max_video_l=194, num_classes=1114,
    )


def make_eval_batch(seed: int, B=128, NG=53, Lv=194, Dv=2818, Lw=16, Dt=512, min_words=3):
    """A collated eval batch (deduplicated videos, cached text) on the card:
    NG unique videos (~2.4 sentences each, as real charades eval batches),
    one row per sentence, features from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    counts = 1 + rng.multinomial(B - NG, np.full(NG, 1.0 / NG))
    group_id = np.repeat(np.arange(NG), counts)
    g_len = rng.integers(Lv // 4, Lv + 1, NG)
    g_len[0] = Lv
    mask_g = np.arange(Lv)[None] < g_len[:, None]
    w_len = rng.integers(min_words, Lw + 1, B)
    words_mask = np.arange(Lw)[None] < w_len[:, None]
    G = int(counts.max())
    ss_idx = np.zeros((B, G), np.int64)
    ss_mask = np.zeros((B, G), bool)
    own = np.zeros(B, np.int64)
    for i in range(B):
        rows = np.flatnonzero(group_id == group_id[i])
        ss_idx[i, : len(rows)] = rows
        ss_idx[i, len(rows):] = i
        ss_mask[i, : len(rows)] = True
        own[i] = int(np.flatnonzero(rows == i)[0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    mg, wm = t(mask_g), t(words_mask)
    return {
        "video_feat_g": torch.randn(NG, Lv, Dv, generator=g, device=dev) * mg[..., None],
        "video_mask_g": mg,
        "video_slot": t(group_id.astype(np.int64)),
        "video_mask": mg[t(group_id)],
        "cached_words_feat": 0.1 * torch.randn(B, Lw, Dt, generator=g, device=dev) * wm[..., None],
        "cached_words_mask": wm,
        "cached_sentence_feat": 0.1 * torch.randn(B, Dt, generator=g, device=dev),
        "ss_sent_idx": t(ss_idx), "ss_sent_mask": t(ss_mask), "ss_own_pos": t(own),
        "group_id": t(group_id),
    }


def _tacos_config(dropout: float = 0.1):
    from mesm_tpu_torch.models.mesm import MESMConfig

    # TACoS C3D_GloVe (config/TACoS/C3D_GloVe.json) at full width and depth:
    # the TwoMLP enhance encoder (share_MLP false), 4096 + 2 TEF video
    # channels, 300-d GloVe text, 1111 + 1 MLM classes
    return MESMConfig(
        hidden_dim=256, v_feat_dim=TACOS["Dv"], t_feat_dim=TACOS["Dt"], nheads=8,
        dim_feedforward=1024, num_recfw_layers=2, t2v_layers=2, enc_layers=2, dec_layers=2,
        num_recss_layers=4, num_queries=10, max_words_l=TACOS["Lw"], max_video_l=TACOS["Lv"],
        num_classes=1112, share_mlp=False, dropout=dropout,
    )


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
    """A collated train batch on the card: ~2.4 sentences per video (the
    groups the out-of-group negatives need), each row's video replicated as
    the train collate does, GT spans inside the video, MLM labels and word
    weights, the saliency triplet's clip indices, features from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_groups = max(2, int(B / 2.4))
    group_id = np.sort(rng.integers(0, n_groups, B))
    group_id[0], group_id[-1] = 0, n_groups - 1
    g_len = rng.integers(Lv // 2, Lv + 1, n_groups)
    vid_len = g_len[group_id]
    video_mask = np.arange(Lv)[None] < vid_len[:, None]
    w_len = rng.integers(3, Lw + 1, B)
    words_mask = np.arange(Lw)[None] < w_len[:, None]
    st = rng.integers(1, np.maximum(vid_len // 2, 2))
    ed = np.minimum(st + rng.integers(1, np.maximum(vid_len // 2, 2)), vid_len - 1)
    clip_mask = (np.arange(Lv)[None] >= st[:, None]) & (np.arange(Lv)[None] <= ed[:, None])
    norm_moment = np.stack([st / vid_len, (ed + 1) / vid_len], -1).astype(np.float32)
    norm_span = np.stack([norm_moment.mean(-1), norm_moment[:, 1] - norm_moment[:, 0]], -1)
    ss_idx, ss_mask, own = np.zeros((B, G), np.int64), np.zeros((B, G), bool), np.zeros(B, np.int64)
    for i in range(B):
        rows = np.flatnonzero(group_id == group_id[i])
        if len(rows) > G:  # a window of G rows of the group holding row i
            pos = int(np.flatnonzero(rows == i)[0])
            start = min(max(pos - G + 1, 0), len(rows) - G)
            rows = rows[start:start + G]
        ss_idx[i, : len(rows)], ss_idx[i, len(rows):] = rows, i
        ss_mask[i, : len(rows)] = True
        own[i] = int(np.flatnonzero(rows == i)[0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    vm, wm = t(video_mask), t(words_mask)
    feat_g = torch.randn(n_groups, Lv, Dv, generator=g, device=dev)
    return {
        "video_feat": feat_g[t(group_id)] * vm[..., None],
        "video_mask": vm,
        "words_feat": 0.1 * torch.randn(B, Lw, Dt, generator=g, device=dev) * wm[..., None],
        "words_mask": wm,
        "sentence_feat": 0.1 * torch.randn(B, Dt, generator=g, device=dev),
        "words_weight": t(rng.integers(1, 3, (B, Lw)).astype(np.float32) * words_mask),
        "unknown_mask": t((rng.random((B, Lw)) < 0.1) & words_mask),
        "words_label": t(rng.integers(0, num_classes, (B, Lw)) * words_mask),
        "clip_mask": t(clip_mask), "group_id": t(group_id), "row_mask": t(np.ones(B, bool)),
        "norm_moment": t(norm_moment), "norm_span": t(norm_span.astype(np.float32)),
        "pos_idx": t(np.stack([st, ed], -1)), "neg_idx": t(np.stack([st - 1, ed], -1)),
        "ss_sent_idx": t(ss_idx), "ss_sent_mask": t(ss_mask), "ss_own_pos": t(own),
    }


def _pred_err(a, b):
    import torch

    out = {}
    for k in a:
        x, y = a[k].float(), b[k].float()
        out[k] = float(((x - y).abs() / torch.clamp(y.abs().max(), min=1.0)).max())
    return out


def _launch_counters():
    """Each kernel's launch counter: (module, attribute)."""
    from mesm_tpu_torch.ops import (attention_batched, attention_packed, attention_shortkey,
                                    attention_trainable, ln_dense)

    return {"ln_dense": (ln_dense, "launches"), "attention_packed": (attention_packed, "launches"),
            "attention_batched": (attention_batched, "launches"),
            "attention_trainable": (attention_trainable, "launches"),
            "attention_packed_pair": (attention_packed, "pair_launches"),
            "attention_shortkey": (attention_shortkey, "launches"),
            "attention_shortkey_onematmul": (attention_shortkey, "onematmul_launches")}


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


def drive_modes(step, batches, per_batch: dict, n_batches: int, refs: dict):
    """n_batches eval steps in each dispatch mode of `per_batch`, the launch
    counts set to 0 just before and read just after each mode's run; the
    first batch's predictions against each reference (MODEL_TOL). Returns
    ({mode: report}, all ok)."""
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
            max(r[f"vs_{name}"].values()) <= MODEL_TOL for name in refs))
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
    LayerNorm -> Dense."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_eval_step

    torch.manual_seed(0)
    model = MESM(_tacos_config()).cuda().eval()
    step = make_eval_step(model, _encode_batch, torch.float32)
    B, Lv = TACOS["B"], TACOS["Lv"]
    batches = [make_eval_batch(s, B=B, NG=max(2, int(B / 2.4)), Lv=Lv, Dv=TACOS["Dv"],
                               Lw=TACOS["Lw"], Dt=TACOS["Dt"]) for s in range(2)]
    reset_launches()
    outs = [step(batches[i % 2]) for i in range(n_batches)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_launches({"ln_dense": 1, "attention_batched": 2}, n_batches)
    with kernels.pallas_scope("off"):
        off = step(batches[0])
    res = {"phase": "tacos_eval", "batches": n_batches, "rows_per_batch": B, "launches": launches,
           "launches_expected": want, "kernels_vs_off_fp32": _pred_err(outs[0], off),
           "tol": FP32_MODEL_TOL}
    res["shapes_ok"] = tuple(outs[0]["saliency_scores"].shape) == (B, Lv)
    res["finite"] = all(bool(torch.isfinite(v.float()).all()) for o in outs for v in o.values())

    def rows_per_s(mode, iters=6):
        with kernels.pallas_scope(mode):
            step(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                step(batches[i % 2])
            torch.cuda.synchronize()
            return B * iters / (time.perf_counter() - t0)

    turns = [(m, rows_per_s(m)) for m in ("auto", "off", "off", "auto")]
    res["rows_per_s_kernels_auto"] = [r for m, r in turns if m == "auto"]
    res["rows_per_s_kernels_off"] = [r for m, r in turns if m == "off"]
    res["card"] = card
    res["ok"] = bool(launches == want and res["shapes_ok"] and res["finite"]
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
    pair mask, so they launch the pair-masked packed kernel; predictions
    against "off" and fp32 "off"."""
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


def phase_train(card: str, steps: int = 4) -> dict:
    """The train step: the kernel-engaged TACoS fp32 step (bench.py:780-795:
    B = 16, attention dropout 0, input dropout 0.5 as shipped) with the
    kernels "auto" and "off" from one init and the same draws, then the
    charades C+SF_C fp32 step at B = 32 with dropout 0.1 as shipped."""
    import torch

    from mesm_tpu_torch import kernels
    from mesm_tpu_torch.losses import CriterionConfig
    from mesm_tpu_torch.models.mesm import MESM
    from mesm_tpu_torch.parallel.step import make_micro_grads, step_draws

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
    first = {}
    for name, mode, b in (("auto", "auto", batch), ("off", "off", batch), ("floor", "off", perturbed)):
        model = fresh()
        neg_gen, mask_gen = step_draws(TRAIN_SEED, 0, "cuda")
        with kernels.pallas_scope(mode):
            total, _ = make_micro_grads(model, ccfg, _encode_batch)(b, neg_gen, mask_gen)
        first[name] = (float(total.detach()), {n: p.grad for n, p in model.named_parameters()
                                               if p.grad is not None})
    torch.cuda.synchronize()
    (loss_a, g_a), (loss_o, g_o), (_, g_f) = first["auto"], first["off"], first["floor"]
    scale = max(1.0, max(float(g.abs().max()) for g in g_o.values()))

    def grad_err(g):
        return max(float((g[n] - g_o[n]).abs().max()) for n in g_o) / scale

    res = {"phase": "train", "card": card, "tacos": {
        "rows": TACOS["B"], "stacked_rows": 2 * TACOS["B"], "first_loss_auto": loss_a,
        "first_loss_off": loss_o, "first_loss_rel_err": abs(loss_a - loss_o) / max(1.0, abs(loss_o)),
        "grad_max_abs": scale, "grad_max_err_rel_to_max1": grad_err(g_a),
        "grad_noise_floor_rel_to_max1": grad_err(g_f),
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
    want = expected_launches({"attention_batched": 2, "attention_trainable": 2}, steps)
    t["launches_expected"] = want
    ok_tacos = (t["launches"] == want and t["grads_same_params"]
                and t["first_loss_rel_err"] <= TRAIN_LOSS_TOL
                and t["grad_max_err_rel_to_max1"] <= TRAIN_GRAD_TOL
                and all(math.isfinite(x) for x in t["last_loss"]))

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


def phase_train_cli() -> dict:
    """`python -m mesm_tpu_torch.train` through its train() entry on the
    synthetic charades root at full width (fp32 on the card, one epoch and
    its eval), then `mesm_tpu_torch.evaluate` scoring the run's best
    checkpoint."""
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
        run = train(["--config_file", cfg_path, "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_launches()
        opt = run["opt"]
        with open(opt.train_log_filepath) as f:
            train_log = f.read().strip().splitlines()
        eval_cfg = os.path.join(root, "eval.json")
        with open(eval_cfg, "w") as f:
            json.dump({
                "ann_path": opt.ann_path, "feat_files": opt.feat_files,
                "text_model_path": opt.text_model_path, "bpe_path": "",
                "trained_result_dir": opt.result_dir, "inference_id": "chip_smoke_trained",
                "inference_result_dir": os.path.join(root, "inference"), "num_workers": 4,
            }, f)
        t0 = time.perf_counter()
        metrics, _ = inference(["--config_file", eval_cfg, "--device", "cuda"])
        res = {"phase": "train_cli", "train_s": train_s, "steps": run["step"],
               "launches": launches, "train_log_last": train_log[-1] if train_log else None,
               "best_ckpt": os.path.exists(os.path.join(opt.result_dir, "model_test_best.ckpt")),
               "evaluate_s": time.perf_counter() - t0, "brief": metrics["brief"]}
        res["ok"] = bool(run["step"] > 0 and res["best_ckpt"] and res["brief"]
                         and res["brief"].get("MR-full-miou") is not None)
        emit(res)
        if not res["ok"]:
            raise SystemExit("train_cli phase failed")
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
        run = train(["--config_file", cfg_path, "--device", "cuda"])
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
                                "--device", "cuda"])
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
    the share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        and not e.key.startswith("Optimizer.")
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


def write_charades_root(root: str, n_videos: int = 64, seed: int = 0) -> str:
    """A synthetic charades root at full video width: CLIP image (512) and
    SlowFast (2304) features, 2818 wide with the two TEF channels, up to 194
    clips; GloVeSimple 300-d text. The features are stored as directories of
    per-video .npy arrays, which the port's FeatureStore reads like its HDF5
    files (the GPU host has no h5py). Returns the train config path."""
    import numpy as np

    from mesm_tpu_torch.data import Vocabulary

    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    rng = np.random.default_rng(seed)
    vids = [f"V{i:04d}" for i in range(n_videos)]
    durations = {v: float(rng.integers(30, 195)) for v in vids}
    lines = []
    for i, v in enumerate(vids):
        for j in range(1 + (i % 3) + (i % 2)):  # 1..4 sentences, ~2.5 on average
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
            np.save(os.path.join(path, f"{v}.npy"), rng.normal(size=(L, width)).astype(np.float32))
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


def phase_cli() -> dict:
    """`python -m mesm_tpu_torch.evaluate` through its inference() entry:
    bf16 on the card, a torch-layout checkpoint from seeded weights."""
    import torch

    from mesm_tpu_torch import runner
    from mesm_tpu_torch.config import BaseOptions
    from mesm_tpu_torch.evaluate import inference

    with tempfile.TemporaryDirectory(prefix="mesm_chip_smoke_") as root:
        t0 = time.perf_counter()
        cfg_path = write_charades_root(root)
        opt = BaseOptions().parse(["--config_file", cfg_path])  # writes the run's opt.json
        torch.manual_seed(1)
        model = runner.build_model(opt)
        torch.save({"model": model.state_dict(), "epoch": 0},
                   os.path.join(opt.result_dir, "model_test_best.ckpt"))
        eval_cfg = os.path.join(root, "eval.json")
        with open(eval_cfg, "w") as f:
            json.dump({
                "ann_path": opt.ann_path, "feat_files": opt.feat_files,
                "text_model_path": opt.text_model_path, "bpe_path": "",
                "trained_result_dir": opt.result_dir, "inference_id": "chip_smoke",
                "inference_result_dir": os.path.join(root, "inference"),
                "row_capacity": 128, "eval_len_buckets": 1, "num_workers": 4,
            }, f)
        setup_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        metrics, _ = inference(["--config_file", eval_cfg, "--compute_dtype", "bfloat16",
                                "--device", "cuda"])
        torch.cuda.synchronize()
        launches = read_launches()
        brief = metrics["brief"]
        res = {"phase": "cli", "setup_s": setup_s, "inference_s": time.perf_counter() - t0,
               "launches": launches, "brief": brief}
        res["ok"] = bool(launches["ln_dense"] > 0 and launches["attention_packed"] > 0 and brief)
        emit(res)
        if not res["ok"]:
            raise SystemExit("cli phase failed: a kernel of the main path never ran")
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


def kernel_summary(kernel_results: dict, launches: dict) -> dict:
    """One entry per kernel, at the shapes of its main path: ln_dense bf16
    with ReLU and attention_packed (charades inference, launches of the CLI
    phase), attention_batched at the 32 stacked rows and attention_trainable
    (the kernel-engaged TACoS train step, launches of its timed steps), the
    short-key kernels at the QVHighlights site with the pair mask (launches
    of the qvh_eval phase: "on" for the packed short-key kernel,
    "auto+kernel" for the one-matmul kernel) and the pair kernel at the
    long-query site (launches of the long_query phase)."""
    by_name = {}
    for r in kernel_results["results"]:
        if "ms" not in r:
            continue
        if r["kernel"] == "ln_dense" and not (r["dtype"] == "bfloat16" and r["relu"]):
            continue
        if r["kernel"] == "attention_batched" and r["shape"][0] != 2 * TACOS["B"]:
            continue
        if r["kernel"] in ("attention_shortkey", "attention_shortkey_onematmul") and not (
                r["site"] == "qvh" and r["pair"]):
            continue
        by_name[r["kernel"]] = r
    src = "mesm_tpu_torch/kernels/csrc/"
    tpu = "mesm_tpu/ops/attention_pallas.py:"
    meta = {
        "ln_dense": (src + "ln_dense.cu", "mesm_tpu/ops/layer_pallas.py:267"),
        "attention_packed": (src + "attention_packed.cu", tpu + "114"),
        "attention_batched": (src + "attention_batched.cu", tpu + "89"),
        "attention_trainable": ("mesm_tpu_torch/ops/attention_trainable.py", tpu + "571"),
        "attention_packed_pair": (src + "attention_packed.cu", tpu + "170"),
        "attention_shortkey": (src + "attention_shortkey.cu", tpu + "213"),
        "attention_shortkey_onematmul": (src + "attention_shortkey.cu", tpu + "262"),
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
    phase_model(card)
    cli = phase_cli()
    phase_tacos_eval(card)
    qvh = phase_qvh_eval(card)
    long_query = phase_long_query(card)
    trained = phase_train(card)
    phase_train_cli()
    phase_qvh_train(card)
    phase_processes()
    print(card, flush=True)
    launches = dict(cli["launches"])
    for name in ("attention_batched", "attention_trainable"):
        launches[name] = trained["tacos"]["launches"][name]
    launches["attention_shortkey"] = qvh["modes"]["on"]["launches"]["attention_shortkey"]
    launches["attention_shortkey_onematmul"] = (
        qvh["modes"]["auto+kernel"]["launches"]["attention_shortkey_onematmul"])
    launches["attention_packed_pair"] = (
        long_query["modes"]["on"]["launches"]["attention_packed_pair"])
    emit(kernel_summary(kernels, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
