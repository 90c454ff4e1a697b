"""The fused int8 FFN: linear2(prelu(linear1(x))) with int8 x int8 -> int32
products and the wide hidden activation kept on chip.

`ffn_int8` launches the CUDA kernel kernels/csrc/ffn_int8.cu (the port of
mesm_tpu/ops/ffn_pallas.py::ffn_int8 / _ffn_int8_kernel) on CUDA tensors
and runs `ffn_int8_reference`, its plain torch version (ffn_pallas.py:145-173),
on CPU tensors. Both take the kernel's stages:

- weights: per output channel, s = max(amax |w|, 1e-8) / 127 in f32 and
  wq = round(w / s) (half to even), as int8; the quantization is torch ops
  here, as the JAX package does it in XLA outside the pallas_call
  (ffn_pallas.py:107-112);
- activations: per row, xs = max(amax |x|, 1e-8) * (1/127) in f32 and
  xq = round(bf16(x) * bf16(1 / xs));
- h = bf16 chain ((bf16(acc1) * bf16(s1)) * bf16(xs)) + bf16(b1), each op
  rounded to bf16, then PReLU in bf16;
- per row, ah = amax |h| (f32), hq = round(h * bf16(127 / max(ah, 1e-8)));
- out = ((bf16(acc2) * bf16(s2)) * bf16(hs)) + bf16(b2) in bf16, with
  hs = max(ah, 1e-8) * (1/127), returned in x's dtype.

Every round to int8 saturates to [-128, 127], as XLA's float -> int8
conversion does. The integer products are exact at any depth: the plain
version sums them as f64 matrix products (there is no integer matmul on
CUDA; f64 holds every sum below 2**53) and the kernel in int32 (exact up to
MAX_DEPTH). bf(sum) is the JAX kernel's acc.astype(bfloat16), which XLA
computes as int32 -> f32 -> bf16: two roundings once a sum passes 2**24,
and both versions round the same way.

Weights come in torch Linear layout, (out, in); wq rows, whose k run is
contiguous, are the K-major B operands of the kernel's int8 wgmma, which
the wrapper keeps in the order the kernel's stages hold them, zero-padded
to the kernel's tiles (`stage_weights`, `stage_vectors`): any K, N1 and K2
take the kernel, up to what a block's shared memory holds of x's 64-row
tile (K up to 1,248).

The kernel's wrapper takes the quantized weights from `quantized_weights`,
which computes them once per weight version: its cache
(ops/_weight_cache.py) is keyed on the parameters' identity, `data_ptr()`
and `_version`, so an in-place
update (an optimizer step, `load_state_dict`, `copy_` under no_grad) makes
the next call quantize again, and it holds the parameters only by weak
reference, so a freed model leaves no entry behind. The JAX package
computes the same values once per dispatch, hoisted out of its scan
(ffn_pallas.py:18-20); eager PyTorch has no such hoisting. The plain
version quantizes inline on every call, as the JAX oracle does.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..kernels import refuse_autograd
from ._weight_cache import Entry, derived

MAX_SMEM = 232448  # bytes a block may use on sm_90
# the kernel's int32 sums, |sum| <= 128 * 127 * depth, stay exact for depths
# (K, N1) up to this
MAX_DEPTH = 132104

# kernel launches since import (or since the caller last set it to 0)
launches = 0
# weight quantizations by quantized_weights (cache misses), counted alike
weight_quantizations = 0


def _div(a, b) -> torch.Tensor:
    """a / b as an elementwise f32 division, a Python number taken as a full
    tensor: with a scalar operand torch may multiply by a reciprocal
    instead, which rounds otherwise than XLA's division."""
    a = a if isinstance(a, torch.Tensor) else torch.full_like(b, a)
    b = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
    return a / b


def quantize_weight(w: torch.Tensor):
    """(out, in) float weight -> (int8 (out, in), f32 scales (out,)):
    per-output-channel symmetric scales amax / 127 (ffn_pallas.py:107-112)."""
    wf = w.float()
    s = _div(torch.clamp(wf.abs().amax(dim=1), min=1e-8), 127.0)
    return torch.round(wf / s[:, None]).to(torch.int8), s


# id(w1) -> _weight_cache.Entry; an entry goes when its w1 is freed
_weight_cache: Dict[int, Entry] = {}


def quantized_weights(w1, b1, alpha, w2, b2):
    """The kernel's weight operands: (w1q int8 (N1, K), s1 bf16 (N1,), b1
    bf16 (N1,), alpha bf16 (1,), w2q int8 (K2, N1), s2 bf16 (K2,), b2 bf16
    (K2,)), contiguous, none of them sharing memory with a parameter. The
    values are quantize_weight's and the bf16 casts of b1, alpha, b2, computed
    once per version of the five tensors (see the module docstring)."""
    global weight_quantizations
    values = derived(_weight_cache, (w1, b1, alpha, w2, b2))
    if "quantized" not in values:
        bf = torch.bfloat16
        with torch.no_grad():
            w1q, s1 = quantize_weight(w1.detach())
            w2q, s2 = quantize_weight(w2.detach())
            values["quantized"] = (
                w1q.contiguous(), s1.to(bf).contiguous(),
                b1.detach().to(bf, copy=True).contiguous(),
                alpha.detach().to(bf, copy=True).reshape(1).contiguous(),
                w2q.contiguous(), s2.to(bf).contiguous(),
                b2.detach().to(bf, copy=True).contiguous())
        weight_quantizations += 1
    return values["quantized"]


# output columns per block of the kernel's linear2
KO = 256


def stage_weights(w1q: torch.Tensor, w2q: torch.Tensor, nc: int):
    """The int8 weights in the order the kernel's stages hold them, for
    hidden chunks of `nc` columns: (w1s, w2s), flat int8. w1s holds, chunk
    after chunk, the chunk's nc rows of w1q (N1, K), each row K rounded up
    to 32 wide; w2s, for each block of KO output rows and each chunk, those
    rows' nc columns of w2q (K2, N1); zeros past K, N1 and K2. Each (rows x
    cols) piece is in wgmma's K-major layout without swizzle: byte (r, k) at
    (r // 8) * (cols // 16) * 128 + (k // 16) * 128 + (r % 8) * 16 + k % 16."""
    N1, K = w1q.shape
    K2 = w2q.shape[0]
    Kp = -(-K // 32) * 32
    J, nob = -(-N1 // nc), -(-K2 // KO)
    w1p = w1q.new_zeros(J * nc, Kp)
    w1p[:N1, :K] = w1q
    w1s = w1p.view(J, nc // 8, 8, Kp // 16, 16).permute(0, 1, 3, 2, 4).reshape(-1)
    w2p = w2q.new_zeros(nob * KO, J * nc)
    w2p[:K2, :N1] = w2q
    w2s = w2p.view(nob, KO // 8, 8, J, nc // 16, 16).permute(0, 3, 1, 4, 2, 5).reshape(-1)
    return w1s, w2s


def stage_vectors(s1, b1, s2, b2):
    """The bf16 scales and biases as the kernel reads them: s1, b1
    zero-padded to a multiple of 64 hidden columns, s2, b2 to one of KO
    outputs (zero scale and bias: a padded hidden column is h = 0, a padded
    output is not stored)."""
    def pad(v, m):
        out = v.new_zeros(-(-v.numel() // m) * m)
        out[:v.numel()] = v
        return out
    return pad(s1, 64), pad(b1, 64), pad(s2, KO), pad(b2, KO)


def staged_weights(w1, b1, alpha, w2, b2, nc: int):
    """stage_weights of quantized_weights' int8 weights and stage_vectors of
    its scales and biases, (w1s, w2s, s1, b1, s2, b2), kept in the same
    cache entry (computed once per weight version and chunk width)."""
    w1q, s1, b1b, _, w2q, s2, b2b = quantized_weights(w1, b1, alpha, w2, b2)
    values = derived(_weight_cache, (w1, b1, alpha, w2, b2))
    if ("staged", nc) not in values:
        values["staged", nc] = stage_weights(w1q, w2q, nc) + stage_vectors(s1, b1b, s2, b2b)
    return values["staged", nc]


def _to_i8(v: torch.Tensor) -> torch.Tensor:
    """round half to even, saturated to int8, as an f32 tensor of integers."""
    return torch.clamp(torch.round(v.float()), -128.0, 127.0)


def _row_scale(a: torch.Tensor) -> torch.Tensor:
    """max(a, 1e-8) * (1/127) in f32: the per-row dequantization scale."""
    return torch.clamp(a, min=1e-8) * (1.0 / 127.0)


def ffn_int8_reference(x, w1, b1, alpha, w2, b2):
    """Plain torch version. x (..., K) bf16 or fp32; w1 (N1, K), b1 (N1,),
    alpha (1,) the PReLU slope, w2 (K2, N1), b2 (K2,) float -> (..., K2) in
    x's dtype."""
    bf = torch.bfloat16
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(w2)
    ax = x2.float().abs().amax(dim=-1, keepdim=True)
    xs = _row_scale(ax)
    xq = _to_i8(x2.to(bf) * _div(1.0, xs).to(bf))
    acc1 = torch.matmul(xq.double(), w1q.double().t())  # exact integer sums
    h = acc1.float().to(bf) * s1.to(bf) * xs.to(bf) + b1.to(bf)
    a = alpha.to(bf).reshape(())
    h = torch.clamp(h, min=0) + a * torch.clamp(h, max=0)
    ah = h.float().abs().amax(dim=-1, keepdim=True)
    hr = _div(127.0, torch.clamp(ah, min=1e-8)).to(bf)
    hq = _to_i8(h * hr)
    acc2 = torch.matmul(hq.double(), w2q.double().t())
    out = acc2.float().to(bf) * s2.to(bf) * _row_scale(ah).to(bf) + b2.to(bf)
    return out.to(x.dtype).reshape(*shape[:-1], w2.shape[0])


def ffn_int8(x, w1, b1, alpha, w2, b2):
    """linear2(prelu(linear1(x))) with the int8 kernel's numerics. CPU
    tensors take the plain version; CUDA tensors launch the kernel (x bf16
    or fp32; any K2, K and N1 up to MAX_DEPTH, K as far as its 64-row tile
    fits a block's shared memory) or raise, with the weights quantized once
    per version (`quantized_weights`). Raises for an input that requires
    grad in grad mode (no graph)."""
    global launches
    refuse_autograd("ffn_int8", x, w1, b1, alpha, w2, b2)
    if x.device.type == "cpu":
        return ffn_int8_reference(x, w1, b1, alpha, w2, b2)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ffn_int8: the kernel takes bfloat16 or float32 x, got {x.dtype}")
    K = x.shape[-1]
    N1, K2 = w1.shape[0], w2.shape[0]
    if w1.shape != (N1, K) or b1.shape != (N1,) or w2.shape != (K2, N1) or b2.shape != (K2,) \
            or alpha.numel() != 1:
        raise ValueError(
            f"ffn_int8: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"alpha {tuple(alpha.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}"
        )
    if max(K, N1) > MAX_DEPTH:
        raise ValueError(f"ffn_int8: the kernel's int32 sums are exact up to a depth of "
                         f"{MAX_DEPTH}, got K {K}, N1 {N1}")
    if not x.is_contiguous():
        raise ValueError("ffn_int8: x must be contiguous")
    if any(t.device != x.device for t in (w1, b1, alpha, w2, b2)):
        raise ValueError("ffn_int8: every operand must lie on x's device")
    if x.device.type != "cuda":
        raise ValueError(f"ffn_int8: unsupported device {x.device}")
    from ..kernels.build import load

    lib = load("ffn_int8")
    smem_bytes = lib.ffn_int8_smem_bytes
    smem_bytes.restype = ctypes.c_longlong
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    need = smem_bytes(K, N1)
    if need > MAX_SMEM:
        raise ValueError(f"ffn_int8: K {K}, N1 {N1} need {need} bytes of shared memory")
    bf = torch.bfloat16
    chunk_cols = lib.ffn_int8_chunk_cols
    chunk_cols.restype = ctypes.c_int
    chunk_cols.argtypes = [ctypes.c_int, ctypes.c_int]
    alpha_b = quantized_weights(w1, b1, alpha, w2, b2)[3]
    w1s, w2s, s1, b1b, s2, b2b = staged_weights(w1, b1, alpha, w2, b2, chunk_cols(K, N1))
    N = x.numel() // K
    out = torch.empty(*x.shape[:-1], K2, dtype=x.dtype, device=x.device)
    operands = (x, w1s, s1, b1b, alpha_b, w2s, s2, b2b, out)
    fn = lib.ffn_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(operands) + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(*(t.data_ptr() for t in operands), N, K, N1, K2, int(x.dtype == bf),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ffn_int8 kernel launch failed: cudaError {err}")
    launches += 1
    return out
