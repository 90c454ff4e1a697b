"""Kernel dispatch: which call sites launch a hand-written CUDA kernel.

Counterpart of mesm_tpu/kernels.py. The mode is "off" (plain torch
everywhere), "on" (the kernel wherever it takes the shapes) or "auto" (the
default: the kernel where the JAX package's measured gates put its Pallas
kernel). `--pallas_attention` keeps its meaning and sets this mode. The
gates are the JAX package's thresholds, not yet re-measured on the H100.

Where the JAX package asks "is this on the TPU", the port asks "is the
tensor on CUDA". A kernel wrapper given CPU tensors runs its plain torch
version (ops/ln_dense.py, ops/attention_packed.py, ops/attention_shortkey.py,
ops/attention_batched.py), so "on" with CPU tensors computes the same values
as the kernels' own arithmetic. Every decision is taken here, before the
call; a wrapper never falls back after a failure. A wrapper builds no
autograd graph, so it refuses inputs that need a gradient
(`refuse_autograd`); training reaches the attention kernels through
ops/attention_trainable.py.

The attention dispatch takes the JAX package's decisions in its order
(mesm_tpu/models/attention.py:322-375): first the Pallas tier
(`use_pallas_attention`, kernels.py:337-379, and the kernel that
attention_pallas.fused_attention:635-674 picks for the operands,
`fused_route`), then the short-key tier (`use_shortkey_packed`,
kernels.py:284-306, eval only), whose "kernel" variant launches the
one-matmul short-key kernel and whose default "segmm" variant is a TPU
layout rewrite of attention_core's values, which the port runs as
attention_core. The short-query reformulation (kernels.py:309-334) has no
kernel either; its sites take attention_core.
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
# the packed family also takes keys from 8 up (attention_pallas.py:641-643);
# keys shorter than MIN_FUSED_LEN go to its short-key kernel
PACKED_MIN_LK = 8
# fused LayerNorm -> Dense: only the wide raw-feature input projection
LN_DENSE_MIN_D = 1024
# the short-key tier (kernels.py:92-94): the t2v/enhance cross-attention of
# long video queries against short text keys, eval only (SHORTKEY_TRAIN is
# False there)
SHORTKEY_MAX_LK = 64
SHORTKEY_MIN_LQ = 64
SHORTKEY_MIN_B = 8
# its softmax stage (kernels.py:177-192): "segmm" (the default) and
# "reshape" are TPU layout rewrites of attention_core's function, which the
# port runs as attention_core; "kernel" launches the one-matmul short-key
# kernel (ops/attention_shortkey.attention_shortkey_onematmul)
SHORTKEY_VARIANT = "segmm"


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


def use_pallas_attention(B: int, Lq: int, Lk: int, dtype, device) -> bool:
    """The Pallas tier (kernels.py:337-379): every call under "on"; under
    "auto" on CUDA, bf16 with both sides >= PACKED_MIN_LEN and B >=
    PACKED_MIN_BATCH, other dtypes with both sides >= AUTO_MIN_LEN and B >=
    AUTO_MIN_BATCH."""
    mode = pallas_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    if not _on_cuda(device):
        return False
    if dtype == torch.bfloat16:
        return min(Lq, Lk) >= PACKED_MIN_LEN and B >= PACKED_MIN_BATCH
    return min(Lq, Lk) >= AUTO_MIN_LEN and B >= AUTO_MIN_BATCH


def fused_route(Lq: int, Lk: int, dtype, pair: bool) -> Optional[str]:
    """The kernel attention_pallas.fused_attention (:635-674) launches for a
    dropout-free call, or None where it computes attention_core:

    - bf16, the packed family (Lq >= 64, Lk >= 8): "shortkey" for keys
      shorter than 64 (_mha_kernel_packed_shortkey / _shortkey_nopair),
      else "packed_pair" with pair factors (_mha_kernel_packed_pair) and
      "packed" without (_mha_kernel_packed);
    - fp32, "batched" with both sides >= 64 and no pair factors.
    """
    if dtype == torch.bfloat16:
        if Lq < MIN_FUSED_LEN or Lk < PACKED_MIN_LK:
            return None
        if Lk < MIN_FUSED_LEN:
            return "shortkey"
        return "packed_pair" if pair else "packed"
    if dtype == torch.float32:
        if min(Lq, Lk) < MIN_FUSED_LEN or pair:
            return None
        return "batched"
    return None


def use_shortkey_packed(B: int, Lq: int, Lk: int, device, training: bool = False) -> bool:
    """The short-key tier (kernels.py:284-306): eval only (SHORTKEY_TRAIN is
    False in the JAX package), short keys against long queries, enough
    samples; on CUDA under "auto"."""
    mode = pallas_mode()
    if mode == "off" or training:
        return False
    in_range = Lk <= SHORTKEY_MAX_LK and Lq >= SHORTKEY_MIN_LQ and B >= SHORTKEY_MIN_B
    if mode == "on":
        return in_range
    return _on_cuda(device) and in_range


def attention_kernel(B: int, Lq: int, Lk: int, dtype, device, pair: bool = False,
                     training: bool = False) -> Optional[str]:
    """The kernel an attention site launches, or None for attention_core, for
    a call with no split_qk and no active dropout (the caller has excluded
    both: neither tier takes them). In the order of
    mesm_tpu/models/attention.py:322-375: the Pallas tier's kernel
    (`fused_route`: "packed", "packed_pair", "shortkey", "batched"; in
    training it runs as the trainable Function's forward), then, in eval,
    the short-key tier: "shortkey_onematmul" when SHORTKEY_VARIANT is
    "kernel", else attention_core."""
    if use_pallas_attention(B, Lq, Lk, dtype, device):
        return fused_route(Lq, Lk, dtype, pair)
    if use_shortkey_packed(B, Lq, Lk, device, training) and SHORTKEY_VARIANT == "kernel":
        return "shortkey_onematmul"
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
