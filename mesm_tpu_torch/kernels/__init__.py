"""Kernel dispatch: which call sites launch a hand-written CUDA kernel.

Counterpart of mesm_tpu/kernels.py. The mode is "off" (plain torch
everywhere), "on" (the kernel wherever it takes the shapes) or "auto" (the
default: the kernel where the JAX package's measured gates put its Pallas
kernel). `--pallas_attention` keeps its meaning and sets this mode
(`set_pallas_attention` for the process, `pallas_scope` for a block). The
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
kernel either; its sites take attention_core. Within the Pallas tier,
MESM_ATTN_VARIANT picks the kernel layout as it does in the JAX package
(`attention_variant`).

The fused int8 FFN (ops/ffn_int8.py) is off unless `set_int8_ffn(True)`;
then every eval PReLU FFN of at least INT8_FFN_MIN_ROWS rows on CUDA
launches it (`use_int8_ffn`, models/layers.ffn).

Two more switches of the JAX package are off by default and launch no
kernel: the dot-stats LayerNorm (`set_dot_stats_ln`, `use_dot_stats_ln`:
the eval LayerNorm statistics as f32 sums of x and of its squares in the
input dtype, models/layers.apply_ln) and the training attention core
recomputed in the backward (`ATTN_REMAT`, `use_attn_remat`:
torch.utils.checkpoint in models/attention.dispatch_attention_core).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
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
# the fused int8 FFN (kernels.py:109-123, 162-174): off by default, eval
# only, PReLU FFNs of at least INT8_FFN_MIN_ROWS rows (layers.py:304: the
# decoder's and SS-recon's small FFNs stay plain)
INT8_FFN = False
INT8_FFN_MIN_ROWS = 4096
# the dot-stats LayerNorm (kernels.py:125-146): off by default, eval only,
# the sites of many rows and narrow features
DOT_STATS_LN = False
DOT_STATS_MIN_ROWS = 4096
DOT_STATS_MAX_D = 512
# the training attention core under torch.utils.checkpoint (kernels.py:
# 216-243): off by default, the sites whose both sides reach ATTN_REMAT_MIN_L
ATTN_REMAT = False
ATTN_REMAT_MIN_L = 128
# the (B, H, L, hd) attention layouts the JAX package reaches only through
# this environment variable (attention_pallas.py:635-637), read per call
ATTN_VARIANT_ENV = "MESM_ATTN_VARIANT"
# the head dims every attention kernel has an instance for; above the last,
# the wide bodies take any multiple of ATTN_WIDE_STEP in slices of that many
# columns (one block per output chunk of that width). The wrappers zero-pad
# any other head_dim to the next of them (ops/attention_packed.kernel_head_dim),
# so every route takes every head_dim, as the Pallas kernels do
ATTN_HEAD_DIMS = (16, 32, 64, 128)
ATTN_WIDE_STEP = 128


def _normalize_mode(enabled) -> str:
    if enabled is None or enabled == "auto":
        return "auto"
    if enabled in (True, "on"):
        return "on"
    return "off"


def set_pallas_attention(enabled) -> None:
    """Set the process-wide default mode (kernels.py:271-276): True/'on',
    False/'off', None/'auto'. A pallas_scope overrides it within its block."""
    global _DEFAULT_MODE
    _DEFAULT_MODE = _normalize_mode(enabled)


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


def dispatch_state() -> tuple:
    """Every switch a forward reads when it decides which kernel a site
    launches: the mode, the short-key variant, MESM_ATTN_VARIANT, the int8
    FFN, the dot-stats LayerNorm and the attention remat. A CUDA graph records one
    set of those decisions, so the coalesced eval step keys its graphs on
    this (parallel/step.py)."""
    return (pallas_mode(), SHORTKEY_VARIANT, os.environ.get(ATTN_VARIANT_ENV) or "",
            INT8_FFN, DOT_STATS_LN, ATTN_REMAT)


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


def attention_variant(dtype) -> str:
    """The kernel layout attention_pallas.fused_attention (:635-637) takes:
    MESM_ATTN_VARIANT when set and not empty, read at every call, else
    "packed" for bf16 and "batched" for other dtypes."""
    return os.environ.get(ATTN_VARIANT_ENV) or ("packed" if dtype == torch.bfloat16 else "batched")


def fused_route(Lq: int, Lk: int, dtype, pair: bool) -> Optional[str]:
    """The kernel attention_pallas.fused_attention (:635-674) launches for a
    dropout-free bf16 or fp32 call, or None where it computes attention_core:

    - the "packed" variant (the bf16 default), Lq >= 64 and Lk >= 8:
      "shortkey" for keys shorter than 64 (_mha_kernel_packed_shortkey /
      _shortkey_nopair), else "packed_pair" with pair factors
      (_mha_kernel_packed_pair) and "packed" without (_mha_kernel_packed);
    - every other variant needs both sides >= 64 and no pair factors:
      "batched" (the fp32 default, _mha_kernel_batched), "all_heads"
      (_mha_kernel_allheads), and "per_head" (_mha_kernel) for "per_head"
      and any value the JAX package does not name.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        return None
    variant = attention_variant(dtype)
    if variant == "packed":
        if Lq < MIN_FUSED_LEN or Lk < PACKED_MIN_LK:
            return None
        if Lk < MIN_FUSED_LEN:
            return "shortkey"
        return "packed_pair" if pair else "packed"
    if min(Lq, Lk) < MIN_FUSED_LEN or pair:
        return None
    return variant if variant in ("batched", "all_heads") else "per_head"


def set_int8_ffn(enabled: bool) -> None:
    """Turn the fused int8 FFN on or off for the process (kernels.py:162)."""
    global INT8_FFN
    INT8_FFN = bool(enabled)


def use_int8_ffn(device) -> bool:
    """kernels.py:167-174 with "on the TPU" read as "on CUDA": false under
    "off", and false on the CPU even under "on"."""
    return pallas_mode() != "off" and INT8_FFN and _on_cuda(device)


def set_dot_stats_ln(enabled: bool) -> None:
    """Turn the dot-stats LayerNorm on or off for the process (kernels.py:143)."""
    global DOT_STATS_LN
    DOT_STATS_LN = bool(enabled)


def use_dot_stats_ln(n_rows: int, d: int, device) -> bool:
    """kernels.py:148-159 with "on the TPU" read as "on CUDA": never under
    "off" or while the switch is off; under "on" wherever the call is in
    range (at least DOT_STATS_MIN_ROWS rows, at most DOT_STATS_MAX_D
    features); under "auto" only on CUDA tensors in range."""
    mode = pallas_mode()
    if mode == "off" or not DOT_STATS_LN:
        return False
    in_range = n_rows >= DOT_STATS_MIN_ROWS and d <= DOT_STATS_MAX_D
    if mode == "on":
        return in_range
    return _on_cuda(device) and in_range


def use_attn_remat(Lq: int, Lk: int, training: bool) -> bool:
    """kernels.py:246-254: recompute the attention core in the backward of a
    training call whose sides both reach ATTN_REMAT_MIN_L. Not a kernel
    tier, so no device gate and no mode: the JAX package reads the switch
    alone."""
    if not training or not ATTN_REMAT:
        return False
    return Lq >= ATTN_REMAT_MIN_L and Lk >= ATTN_REMAT_MIN_L


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
    (`fused_route`: "packed", "packed_pair", "shortkey", "batched",
    "all_heads", "per_head"; in training it runs as the trainable
    Function's forward), then, in eval,
    the short-key tier: "shortkey_onematmul" when SHORTKEY_VARIANT is
    "kernel", else attention_core. Every route takes every head_dim
    (ATTN_HEAD_DIMS, and multiples of ATTN_WIDE_STEP above), as the Pallas
    kernels do."""
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
