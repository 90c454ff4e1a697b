"""Kernel dispatch: which call sites launch a hand-written CUDA kernel.

Counterpart of mesm_tpu/kernels.py:50-73. The mode is "off" (plain torch
everywhere), "on" (the kernel wherever it takes the shapes) or "auto" (the
default: the kernel where the JAX package's measured gates put its Pallas
kernel). `--pallas_attention` keeps its meaning and sets this mode. The
gates are the JAX package's thresholds, not yet re-measured on the H100.

Where the JAX package asks "is this on the TPU", the port asks "is the
tensor on CUDA". A kernel wrapper given CPU tensors runs its plain torch
version (ops/ln_dense.py, ops/attention_packed.py, ops/attention_batched.py),
so "on" with CPU tensors computes the same values as "off" by the kernels'
own arithmetic. Every decision is taken here, before the call; a wrapper
never falls back after a failure. A wrapper builds no autograd graph, so it
refuses inputs that need a gradient (`refuse_autograd`); training reaches the
attention kernels through ops/attention_trainable.py.

Sites whose JAX kernel is not ported yet run plain torch on CUDA too: the
pair-masked and short-key packed variants, and the short-key / short-query
formulations (kernels.py:284-334), which attention_core computes with the
same values.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

_DEFAULT_MODE = "auto"  # "auto" | "on" | "off"
_MODE_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "mesm_torch_kernel_mode", default=None
)

# fp32 "batched" attention tier (kernels.py:75-78, 379): long geometries only
AUTO_MIN_LEN = 512
AUTO_MIN_BATCH = 16
# bf16 "packed" attention tier: both sides long, enough samples
PACKED_MIN_LEN = 128
PACKED_MIN_BATCH = 8
# the smallest sequence the attention kernels take under "on"
# (attention_pallas.py MIN_FUSED_LQ / MIN_FUSED_LK)
MIN_FUSED_LEN = 64
# fused LayerNorm -> Dense: only the wide raw-feature input projection
LN_DENSE_MIN_D = 1024


def _normalize_mode(enabled) -> str:
    if enabled is None or enabled == "auto":
        return "auto"
    if enabled in (True, "on"):
        return "on"
    return "off"


@contextlib.contextmanager
def pallas_scope(enabled):
    """Context-local dispatch mode: True/'on', False/'off', None/'auto'."""
    token = _MODE_OVERRIDE.set(_normalize_mode(enabled))
    try:
        yield
    finally:
        _MODE_OVERRIDE.reset(token)


def pallas_mode() -> str:
    override = _MODE_OVERRIDE.get()
    return override if override is not None else _DEFAULT_MODE


def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def use_fused_ln_dense(D: int, device) -> bool:
    """LayerNorm -> Dense site (models/layers.py LinearBlock, eval only):
    kernels.py:257 with "on the TPU" read as "on CUDA"."""
    mode = pallas_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    return _on_cuda(device) and D >= LN_DENSE_MIN_D


def attention_kernel(B: int, Lq: int, Lk: int, dtype, device) -> Optional[str]:
    """Which attention kernel a site takes (kernels.py:337-379), or None for
    attention_core: "packed" (the bf16 tier, both sides >= 128, B >= 8) or
    "batched" (the fp32 tier, both sides >= 512, B >= 16). Under "on" either
    takes every shape with both sides >= 64. The caller has already excluded
    split_qk, pair masks and active dropout, which neither kernel takes."""
    mode = pallas_mode()
    if mode == "off":
        return None
    if dtype == torch.bfloat16:
        variant, min_len, min_batch = "packed", PACKED_MIN_LEN, PACKED_MIN_BATCH
    elif dtype == torch.float32:
        variant, min_len, min_batch = "batched", AUTO_MIN_LEN, AUTO_MIN_BATCH
    else:
        return None
    if mode == "on":
        return variant if min(Lq, Lk) >= MIN_FUSED_LEN else None
    if _on_cuda(device) and min(Lq, Lk) >= min_len and B >= min_batch:
        return variant
    return None


def refuse_autograd(name: str, *tensors) -> None:
    """A kernel wrapper writes its result into a fresh tensor with no
    autograd graph: in grad mode, an input that needs a gradient would have
    it silently dropped, so the wrapper raises instead. Training reaches the
    attention kernels through ops/attention_trainable.attention_trainable."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel builds no autograd graph; "
            "call it under torch.no_grad() or through ops.attention_trainable"
        )
