"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` has a plain C interface and becomes one shared
library `_build/lib<name>-<hash>.so`, where the hash covers the source, the
shared device-code headers `csrc/*.cuh` and the compiler flags, so an edited
source or header is rebuilt and an unchanged one is reused. Libraries are
built at first use (never at import: the CPU tests import every module on a
host with no nvcc) and cached per process.
`build_all` starts one nvcc per source at once, for scripts that want every
kernel ready before they start timing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("ln_dense", "attention_packed", "attention_batched", "attention_shortkey",
           "attention_heads", "ffn_int8", "stream_layer", "anchor", "attention_backward")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report each kernel's registers and shared memory
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """The library of source `name`. Its hash covers the source, every
    shared header `csrc/*.cuh` (a source may include any of them) and the
    compiler flags."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns, per name, the
    library path, whether it was compiled now, the seconds until its nvcc
    ended and nvcc's own output (the registers and shared memory of each
    kernel). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        report[name] = {"path": str(out), "compiled": False, "seconds": 0.0, "log": ""}
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name].update(compiled=True, seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
