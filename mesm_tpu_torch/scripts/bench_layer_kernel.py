"""Probe: the fused stream-layer kernel against the port's own layers.

    python -m mesm_tpu_torch.scripts.bench_layer_kernel [encoder|t2v] [B L N]
        [--dtype bfloat16|float32] [--device cuda|cpu]

The port of scripts/bench_layer_kernel.py. It builds the port's
TransformerEncoderLayer (encoder) or T2VLayer (t2v) in eval at the charades
widths (D 256, H 8, FFN 1024, 17 text keys; B 128, L 195, N 32 by default)
from a seed, and chains N applications of each implementation inside one
synchronised timing: the module chain, under the default kernel mode
"auto", and ops/stream_layer.fused_stream_layer on the same weights
(stream_layer_params). It prints ms per layer of both, then the largest
difference of one application, and on CUDA the card's name and power limit.
Inputs are seeded numpy draws: the stream and its position, valid lengths
from L/2 to L; for t2v the text (its position zero, 3 to 17 valid words)
and the model's scrambled pair factors. `--device cpu` runs the plain
version in place of the kernel.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..models.detr import TransformerEncoderLayer
from ..models.t2v import T2VLayer, scrambled_pair_factors
from ..ops import stream_layer
from ..ops.stream_layer import fused_stream_layer, stream_layer_params

D, H, F, LT = 256, 8, 1024, 17
DEFAULT_SIZES = (128, 195, 32)  # B, L, N


def make_case(flavor: str, B: int, L: int, dtype: torch.dtype, device, seed: int = 0) -> dict:
    """One flavour's layer in eval (weights from torch.manual_seed(seed)) and
    inputs (numpy's default_rng(seed)): {"x", "args", "module"},
    where fused_stream_layer(x, *args) and stream_layer_reference(x, *args)
    compute the layer that module(x) computes."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x = t(rng.normal(size=(B, L, D)).astype(np.float32)).to(dtype)
    pos = t(rng.normal(size=(B, L, D)).astype(np.float32)).to(dtype)
    lens = rng.integers(L // 2, L + 1, B)
    vmask = t(np.arange(L)[None] < lens[:, None])
    torch.manual_seed(seed)
    if flavor == "encoder":
        layer = TransformerEncoderLayer(D, H, F, dropout=0.0).to(dev).eval()
        return {"x": x, "args": (pos, None, None, vmask, None, stream_layer_params(layer), H, True),
                "module": lambda c: layer(c, vmask, pos)}
    if flavor != "t2v":
        raise ValueError(f"flavor must be encoder or t2v, got {flavor!r}")
    txt = t(rng.normal(size=(B, LT, D)).astype(np.float32)).to(dtype)
    pos_t = torch.zeros_like(txt)
    tlens = rng.integers(3, LT + 1, B)
    tmask = t(np.arange(LT)[None] < tlens[:, None])
    layer = T2VLayer(D, H, F, dropout=0.0).to(dev).eval()
    pair = scrambled_pair_factors(vmask, tmask, H)
    return {"x": x, "args": (pos, txt + pos_t, txt, tmask, pair, stream_layer_params(layer), H, False),
            "module": lambda c: layer(txt, c, tmask, pos_t, pos, vmask)}


def _chain(fn, x, n: int):
    c = x
    for _ in range(n):
        c = fn(c)
    return c


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run(flavor: str = "encoder", B: int = 128, L: int = 195, N: int = 32,
        dtype: torch.dtype = torch.bfloat16, device="cuda", iters: int = 5) -> dict:
    """ms per layer of the module chain and of the fused kernel, each over
    `iters` chains of N layers after one warm-up chain (host clock around
    synchronised work), the kernel's launches in one chain, and the largest
    difference of one application (absolute, and in units of max(1,
    |module|))."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is False; "
                           "pass --device cpu for the plain version")
    res = {"flavor": flavor, "B": B, "L": L, "N": N, "dtype": str(dtype).replace("torch.", ""),
           "device": str(dev), "iters": iters}
    with torch.no_grad():
        case = make_case(flavor, B, L, dtype, dev)
        x, module_fn = case["x"], case["module"]

        def kernel_fn(c):
            return fused_stream_layer(c, *case["args"])

        for name, fn in (("module", module_fn), ("kernel", kernel_fn)):
            before = stream_layer.launches
            _chain(fn, x, N)  # warm-up: allocator, the kernel's build
            _sync(dev)
            if name == "kernel":
                res["kernel_launches_per_chain"] = stream_layer.launches - before
            t0 = time.perf_counter()
            for _ in range(iters):
                _chain(fn, x, N)
            _sync(dev)
            res[f"{name}_ms_per_layer"] = (time.perf_counter() - t0) / iters / N * 1e3
        rm, rk = module_fn(x).float(), kernel_fn(x).float()
        res["max_diff"] = float((rm - rk).abs().max())
        res["max_err_rel_to_max1"] = float(((rm - rk).abs() / rm.abs().clamp(min=1.0)).max())
        res["finite"] = bool(torch.isfinite(rk).all())
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("flavor", nargs="?", default="encoder", choices=("encoder", "t2v"))
    ap.add_argument("sizes", nargs="*", type=int, help="B L N (defaults 128 195 32)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if len(args.sizes) > 3:
        ap.error("at most three sizes: B L N")
    B, L, N = list(args.sizes) + list(DEFAULT_SIZES[len(args.sizes):])
    res = run(args.flavor, B, L, N, getattr(torch, args.dtype), args.device)
    if torch.device(args.device).type == "cuda":
        res["card"] = card()
        print(res["card"])
    else:
        print("device cpu: the plain version in place of the kernel")
    for name, label in (("module", "module chain"), ("kernel", "fused kernel")):
        print(f"{args.flavor} {label:13s} {res[f'{name}_ms_per_layer']:7.3f} ms/layer  "
              f"(B={B} L={L} N={N} {args.dtype})")
    print(f"{args.flavor} maxdiff module-vs-kernel on {args.device}: {res['max_diff']:.3e}")
    return res


if __name__ == "__main__":
    main()
