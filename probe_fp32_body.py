#!/usr/bin/env python3
"""Where the time of the float32 attention forward goes, on the GPU.

    python3 probe_fp32_body.py

Builds mesm_tpu_torch/kernels/probes/fp32_body.cu with nvcc (into the
kernels' gitignored build directory) and, on the TACoS encoder's inputs
(32 x 601 x 601, E = 256, chip_smoke._encoder_qkv), times with CUDA events:

- the repo's kernel (ops.attention_batched.attention_batched, float32);
- the probes of its body with one part left out (no S product, no P . V
  product, no products, no online softmax, no split of the K / V tiles), at
  head_dim 32, and the body with and without its products at head_dim 128;
- the wgmma TF32 variant at head_dim 32 (32 and 16 rows), held against the
  plain version within chip_smoke.TOL's 1e-5 first.

The repo's kernel is timed before and after the probes, so drift shows. It
prints the card's name and power limit, then one JSON line a shape. Needs a
GPU.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PROBE_VARIANTS = {32: ("p_full", "p_nos", "p_nopv", "p_noprod", "p_nosm", "p_nosplit"),
                  128: ("p128_full", "p128_noprod")}


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from mesm_tpu_torch.kernels import build
    from mesm_tpu_torch.ops import attention_batched as ab

    cs.phase_device()
    src = os.path.join(HERE, "mesm_tpu_torch", "kernels", "probes", "fp32_body.cu")
    so = build.BUILD_DIR / "libfp32_body_probes.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), src],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:])
        return 1
    lib = ctypes.CDLL(str(so))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def entry(name):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    ok = True
    for hd, names in PROBE_VARIANTS.items():
        B, L, H = 32, 601, 256 // hd
        q, k, v, mask = cs._encoder_qkv(B, L, "float32", seed=hd + B)
        m8 = mask.to(torch.uint8).contiguous()
        scale = float(torch.tensor(hd**-0.5))
        repo = lambda: ab.attention_batched(q, k, v, H, mask)  # noqa: E731
        res = {"probe": "parts", "shape": [B, L, L, 256, H], "head_dim": hd,
               "repo_kernel_ms": cs.cuda_time_ms(repo)}
        o = torch.empty_like(q)
        for name in names:
            fn = entry(name)
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),  # noqa: E731
                              o.data_ptr(), B, H, L, L, 256, scale, stream())
            if call() != 0:
                raise SystemExit(f"{name}: launch failed")
            res[f"{name}_ms"] = cs.cuda_time_ms(call)
        res["repo_kernel_again_ms"] = cs.cuda_time_ms(repo)
        print(json.dumps(res), flush=True)

    wg = entry("wg_fwd")
    for B in (32, 16):
        H, L, hd = 8, 601, 32
        q, k, v, mask = cs._encoder_qkv(B, L, "float32", seed=B + L)
        m8 = mask.to(torch.uint8).contiguous()
        o = torch.full_like(q, float("nan"))
        scale = float(torch.tensor(hd**-0.5))
        call = lambda: wg(q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),  # noqa: E731
                          o.data_ptr(), B, H, L, L, 256, scale, stream())
        if call() != 0:
            raise SystemExit("wg_fwd: launch failed")
        torch.cuda.synchronize()
        err = cs._rel_err(o, ab.attention_batched_reference(q, k, v, H, mask))
        res = {"probe": "wgmma", "shape": [B, L, L, 256, H], "head_dim": hd,
               "max_err_rel_to_max1": err, "tol": cs.TOL["attention_batched_float32"],
               "finite": bool(torch.isfinite(o).all())}
        res["ok"] = res["finite"] and err <= res["tol"]
        ok = ok and res["ok"]
        repo = lambda: ab.attention_batched(q, k, v, H, mask)  # noqa: E731
        res["repo_kernel_ms"] = cs.cuda_time_ms(repo)
        res["wgmma_ms"] = cs.cuda_time_ms(call)
        res["repo_kernel_again_ms"] = cs.cuda_time_ms(repo)
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
