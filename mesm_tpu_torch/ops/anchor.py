"""The layout anchor: an identity copy that pins a (B, L, D) tensor in
row-major memory.

Counterpart of mesm_tpu/ops/anchor.py::layout_anchor, with "on the TPU"
read as "on CUDA". It returns x itself on the CPU, for x.ndim != 3 and in
kernel mode "off" (which keeps every call site free of custom kernels);
otherwise it launches kernels/csrc/anchor.cu, a tiled copy over (B, L, D)
that reads x through its strides (16-byte accesses along D where D has the
unit stride, a shared-memory transpose where L has it, element copies for
other strides) and writes a fresh row-major (B, L, D) tensor.
A strided view (a slice or a transpose of the stream) is the case it is
for. Its plain version, `layout_anchor_reference`, is
x.clone(memory_format=torch.contiguous_format): the same bits. The JAX
package wires it into no path; neither does the port. Eval only: no
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..kernels import refuse_autograd

# kernel launches since import (or since the caller last set it to 0)
launches = 0


def layout_anchor_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: a row-major copy of x."""
    return x.clone(memory_format=torch.contiguous_format)


def layout_anchor(x: torch.Tensor) -> torch.Tensor:
    """Identity, through the copy kernel on CUDA: a row-major (B, L, D)
    tensor with x's values. x itself on the CPU, for other ranks and in
    kernel mode "off"; raises for an input that requires grad in grad mode
    and for a device that is neither CPU nor CUDA."""
    global launches
    if x.device.type == "cpu" or x.ndim != 3 or kernels.pallas_mode() == "off":
        return x
    refuse_autograd("layout_anchor", x)
    if x.device.type != "cuda":
        raise ValueError(f"layout_anchor: unsupported device {x.device}")
    if x.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"layout_anchor: the kernel copies 1, 2, 4 or 8-byte elements, got {x.dtype}")
    B, L, D = x.shape
    out = torch.empty(B, L, D, dtype=x.dtype, device=x.device)
    from ..kernels.build import load

    fn = load("anchor").layout_anchor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p,
    ]
    err = fn(x.data_ptr(), out.data_ptr(), B, L, D, *x.stride(), x.element_size(),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layout_anchor kernel launch failed: cudaError {err}")
    launches += 1
    return out
