#!/usr/bin/env python3
"""Per-launch times of the fp32 short-key kernels (kernels 4 and 5) of
checkouts compared on one GPU.

    python3 compare_shortkey.py [CHECKOUT ...]

Each checkout (a directory that holds mesm_tpu_torch/; default: the one this
script sits in) is measured in a process of its own, in the order given, so
`python3 compare_shortkey.py parent . . parent` compares two commits on one
card in turns. The harness is this file's: in each process it imports the
checkout's `mesm_tpu_torch.ops.attention_shortkey`, builds its
`attention_shortkey` library, and at every fp32 site of SITES (TACoS 16 x
600 x 17, charades 128 x 194 x 17, QVHighlights 30 x 75 x 33; E = 256, H =
8, with and without pair factors) and at TACoS with head_dim 16, 128 and 256
(E = 256 with 16, 2 and 1 heads) holds `attention_shortkey` and
`attention_shortkey_onematmul` against their plain versions on the same
seeded inputs (the plain versions are the same in every checkout), then
times each: CUDA events over 20 launches after 3 warm-ups, the mean of 3
such runs (`ms`, which holds the wrapper's host time where that is longer
than the kernel's), and the kernel alone from torch.profiler over 20
launches (`kernel_ms`). Beside the first checkout's cases it times SDPA on the same
function (an additive -1e9 mask) and gives the bound (q, k, v, out and the
masks over 3.35 TB/s, or 3xTF32 products over 494.7 TFLOP/s). It also
reports, per (heads, head_dim), the most keys each fp32 kernel takes (the
source's shared-memory size up to 227 KB), so that a later checkout can be
held to take every shape an earlier one took. It prints the card's name and
power limit, one JSON line a checkout, then one line comparing the key
limits of the first checkout with every other. Needs a GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (site, B, Lq, Lk, head_dim) at E = 256
SITES = (("tacos", 16, 600, 17, 32), ("charades", 128, 194, 17, 32), ("qvh", 30, 75, 33, 32),
         ("tacos_hd16", 16, 600, 17, 16), ("tacos_hd128", 16, 600, 17, 128),
         ("tacos_hd256", 16, 600, 17, 256))
E = 256
MAX_SMEM = 232448
HBM_BYTES_PER_S, TF32_OPS_PER_S = 3.35e12, 494.7e12
# (heads, head_dim) whose key limits are compared
LIMIT_GRID = [(h, d) for h in (1, 2, 4, 8, 16) for d in (16, 32, 64, 128, 256)]


def events_ms(fn, iters: int = 20, warmup: int = 3, runs: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sum(times) / len(times)


def kernel_ms(fn, iters: int = 20) -> float:
    """Device time per call of the kernels named attention_shortkey*, from
    torch.profiler over `iters` calls after a warm-up: the kernel alone,
    without the host's time between launches, which the CUDA events of
    events_ms include where a call is shorter than its host overhead. A spin
    kernel and a 50 ms wait open the window (the tracer can drop a window's
    first kernel and kernels dated before it began)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "attention_shortkey" in e.key)
    return us / iters / 1e3


def inputs(B: int, Lq: int, Lk: int, H: int, pair: bool, seed: int):
    """q, k, v (fp32), a key mask with padded keys and sample 1 fully masked,
    and pair factors (sample 2's head 0: every key and every other query
    flagged), from a seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda")
    k, v = (torch.randn(B, Lk, E, generator=g, device="cuda") for _ in range(2))
    lengths = torch.randint(max(1, Lk // 3), Lk + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None] < lengths[:, None]
    mask[1] = False
    pf = None
    if pair:
        qf = torch.rand(B, H, Lq, generator=g, device="cuda") < 0.4
        kf = torch.rand(B, H, Lk, generator=g, device="cuda") < 0.4
        kf[2, 0] = True
        qf[2, 0, ::2] = True
        pf = (qf, kf)
    return q, k, v, mask, pf


def key_limits(lib) -> dict:
    """The most keys (up to 4096) each fp32 kernel's block holds, per
    (heads, head_dim): {"H x hd": [short-key, one-matmul]}."""
    import ctypes

    fn = lib.attention_shortkey_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5
    out = {}
    for H, hd in LIMIT_GRID:
        limits = []
        for onematmul in (0, 1):
            lk = 0
            while lk < 4096 and 0 < fn(0, onematmul, H, lk + 1, H * hd) <= MAX_SMEM:
                lk += 1
            limits.append(lk)
        out[f"{H}x{hd}"] = limits
    return out


def measure(tree: str, library: bool) -> dict:
    """Every case of one checkout, in this process."""
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as Fn

    from mesm_tpu_torch.kernels import build
    from mesm_tpu_torch.ops import attention_shortkey as sk

    if not os.path.abspath(sk.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise SystemExit(f"compare_shortkey: imported {sk.__file__}, not the checkout {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_shortkey: torch.cuda.is_available() is False; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.load("attention_shortkey")
    out = {"checkout": tree, "cases": [], "key_limits": key_limits(lib)}
    kernels = {"attention_shortkey": (sk.attention_shortkey, sk.attention_shortkey_reference),
               "attention_shortkey_onematmul": (sk.attention_shortkey_onematmul,
                                                sk.attention_shortkey_onematmul_reference)}
    with torch.no_grad():
        for site, B, Lq, Lk, hd in SITES:
            H = E // hd
            for pair in ((True, False) if hd == 32 else (True,)):
                q, k, v, mask, pf = inputs(B, Lq, Lk, H, pair, seed=B + Lq + Lk + hd + pair)
                case = {"site": site, "shape": [B, Lq, Lk, E, H], "head_dim": hd, "pair": pair}
                for name, (fn, ref) in kernels.items():
                    got, want = fn(q, k, v, H, mask, pf), ref(q, k, v, H, mask, pf)
                    torch.cuda.synchronize()
                    case[name] = {
                        "max_abs_err": float((got - want).abs().max()),
                        "max_err_rel_to_max1": float((got - want).abs().max()
                                                     / want.abs().max().clamp(min=1.0)),
                        "ms": events_ms(lambda: fn(q, k, v, H, mask, pf)),
                        "kernel_ms": kernel_ms(lambda: fn(q, k, v, H, mask, pf))}
                if library:
                    dead = ~mask[:, None, None, :]
                    if pf is not None:
                        dead = dead | (pf[0][..., :, None] & pf[1][..., None, :])
                    am = torch.zeros(B, H, Lq, Lk, device="cuda").masked_fill(dead, -1e9)
                    qh, kh, vh = (t.view(B, -1, H, hd).transpose(1, 2) for t in (q, k, v))
                    case["library_ms"] = events_ms(
                        lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=am))
                    case["plain_ms"] = {name: events_ms(lambda: ref(q, k, v, H, mask, pf), iters=5)
                                        for name, (_, ref) in kernels.items()}
                    moved = 8 * B * (Lq + Lk) * E + B * Lk + (B * H * (Lq + Lk) if pair else 0)
                    t_bytes = moved / HBM_BYTES_PER_S
                    t_ops = 3 * 2 * 2.0 * B * H * Lq * Lk * hd / TF32_OPS_PER_S
                    case["bound_ms"] = max(t_bytes, t_ops) * 1e3
                    case["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                out["cases"].append(case)
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]), sys.argv[3] == "1")), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in (sys.argv[1:] or [HERE])]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    results = []
    for i, tree in enumerate(trees):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              "1" if i == 0 else "0"], capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            raise SystemExit(f"compare_shortkey: {tree} failed")
        results.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    first = results[0]["key_limits"]
    print(json.dumps({"key_limits_vs_first": {
        r["checkout"]: {k: [a - b for a, b in zip(r["key_limits"][k], first[k])] for k in first}
        for r in results[1:]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
