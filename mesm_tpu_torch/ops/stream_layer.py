"""The fused stream layer: a whole post-norm transformer layer on the
running (B, Lq, D) stream in one kernel launch.

`fused_stream_layer` launches the CUDA kernel kernels/csrc/stream_layer.cu
(the port of mesm_tpu/ops/layer_pallas.py::fused_stream_layer /
_stream_layer_kernel) on CUDA tensors and runs `stream_layer_reference`,
its plain torch version, on CPU tensors. Like the TPU kernel it is on no
path of the model: `python -m mesm_tpu_torch.scripts.bench_layer_kernel`
holds it against the port's own layers (models/detr.TransformerEncoderLayer,
models/t2v.T2VLayer) at the same weights, which `stream_layer_params` maps.

Two flavours, selected by `self_attn`:

- encoder (self-attention): q = k = x + pos, v = x;
  x1 = x + attn; s = LN1(x1); out = LN2(s + ffn(s));
- T2V (cross-attention): q = x + pos, k = k_in (text + its position),
  v = v_in (text); x1 = x + attn; out = LN2(x1 + ffn(LN1(x1))).

Both take the TPU kernel's rounding points ("T" is the stream dtype, x's):

- q_in = x + pos, rounded to T; for the encoder k_in = q_in and v_in = x
  (layer_pallas.py:127-132);
- every dense product (`_dot2`, :61-72) takes T operands, the weight
  rounded to T, sums in f32, adds the f32 bias and rounds to T;
- attention (:75-104), per head: q_h in f32 times (D // heads) ** -0.5
  (an f32 product, not rounded), f32 logits; -1e9 where both pair factors
  are set, then -1e9 where the key is masked; an exact f32 softmax over
  all Lk keys, the probabilities rounded to T after the division; p . v
  summed in f32, the concatenated heads rounded to T. A row whose keys are
  all masked takes the mean of v over all Lk keys;
- the out projection is a dense product; x1 = x + attn rounded to T;
- LayerNorm (:53-58): f32 statistics with var = E[x^2] - mean^2
  (unclamped; not F.layer_norm's two-pass variance), eps 1e-5, the
  result rounded to T;
- the FFN (:146-150): a dense product (T), then PReLU in f32 with the
  single slope, rounded to T, then a dense product; the residual sums are
  rounded to T before LN2.

Weights come in torch's (out, in) layout, float32 as the port keeps its
parameters: wq, wk, wv, wo (D, D); w1 (F, D); w2 (D, F); biases, LayerNorm
scales and biases as vectors; alpha the PReLU slope (1,). Masks come in the
port's forms: the (B, Lk) bool valid mask (True = attendable) and the
model's (B, H, Lq) / (B, H, Lk) pair factors (models/t2v.py
scrambled_pair_factors), which either flavour takes, as the TPU kernel does.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..kernels import refuse_autograd
from ..models.layers import PReLU
from .attention_packed import factors_u8, mask_u8

NEG_INF = -1e9
LN_EPS = 1e-5
# the dense products step through the depth in whole tiles of 32
K_STEP = 32
WEIGHT_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln1s", "ln1b",
                "w1", "b1", "alpha", "w2", "b2", "ln2s", "ln2b")

# kernel launches since import (or since the caller last set it to 0)
launches = 0


def _dot2(x, w, b):
    """x (..., Din) in the stream dtype times w (Dout, Din) rounded to it,
    f32 sums plus the f32 bias, rounded to the stream dtype."""
    y = torch.matmul(x.float(), w.to(x.dtype).float().t()) + b.float()
    return y.to(x.dtype)


def _layernorm(x, scale, bias):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(x.dtype)


def stream_layer_reference(x, pos, k_in, v_in, valid_mask: Optional[torch.Tensor],
                           pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]],
                           params: Dict[str, torch.Tensor], heads: int, self_attn: bool):
    """Plain torch version. x, pos (B, Lq, D) in the stream dtype; k_in, v_in
    (B, Lk, D) for the T2V flavour (ignored for the encoder, whose keys are
    the queries); valid_mask (B, Lk) bool or None; pair_factors ((B, H, Lq),
    (B, H, Lk)) bool or None -> (B, Lq, D) in x's dtype."""
    dt = x.dtype
    B, Lq, D = x.shape
    p = params
    q_in = x + pos.to(dt)
    if self_attn:
        k_in, v_in = q_in, x
    qp = _dot2(q_in, p["wq"], p["bq"])
    kp = _dot2(k_in, p["wk"], p["bk"])
    vp = _dot2(v_in, p["wv"], p["bv"])
    Lk, hd = kp.shape[1], D // heads
    qh = qp.reshape(B, Lq, heads, hd).transpose(1, 2).float() * (hd**-0.5)
    kh = kp.reshape(B, Lk, heads, hd).transpose(1, 2).float()
    vh = vp.reshape(B, Lk, heads, hd).transpose(1, 2).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # (B, H, Lq, Lk)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=x.device)
    if pair_factors is not None:
        qf, kf = pair_factors
        logits = torch.where(qf.bool()[..., :, None] & kf.bool()[..., None, :], neg, logits)
    if valid_mask is not None:
        logits = torch.where(valid_mask.bool()[:, None, None, :], logits, neg)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    prob = (e / e.sum(-1, keepdim=True)).to(dt)
    o = torch.matmul(prob.float(), vh).transpose(1, 2).reshape(B, Lq, D).to(dt)
    x1 = x + _dot2(o, p["wo"], p["bo"])
    s = _layernorm(x1, p["ln1s"], p["ln1b"])
    h = _dot2(s, p["w1"], p["b1"]).float()
    a = p["alpha"].float().reshape(())
    h = (torch.clamp_min(h, 0.0) + a * torch.clamp_max(h, 0.0)).to(dt)
    f = _dot2(h, p["w2"], p["b2"])
    return _layernorm((s if self_attn else x1) + f, p["ln2s"], p["ln2b"])


def stream_layer_params(layer, is_mlm: bool = False) -> Dict[str, torch.Tensor]:
    """The kernel's operands from a port layer: models/detr.TransformerEncoderLayer
    or models/t2v.T2VLayer (the counterpart of tests/test_layer_kernel.py
    map_params). in_proj_weight is split in three row blocks, in torch's
    (out, in) layout: views, no copies. Raises for an activation other than
    the single-slope PReLU, and for a two_mlp T2V layer with is_mlm, whose
    forward takes the other FFN and norms."""
    if not isinstance(layer.activation, PReLU) or layer.activation.weight.numel() != 1:
        raise ValueError(f"stream_layer_params: the kernel's FFN is a single-slope PReLU, "
                         f"got {layer.activation}")
    if is_mlm and getattr(layer, "two_mlp", False):
        raise ValueError("stream_layer_params: a two_mlp layer with is_mlm runs its second FFN")
    attn = layer.self_attn
    wq, wk, wv = attn.in_proj_weight.chunk(3)
    bq, bk, bv = attn.in_proj_bias.chunk(3)
    return dict(
        wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
        wo=attn.out_proj.weight, bo=attn.out_proj.bias,
        ln1s=layer.norm1.weight, ln1b=layer.norm1.bias,
        w1=layer.linear1.weight, b1=layer.linear1.bias, alpha=layer.activation.weight,
        w2=layer.linear2.weight, b2=layer.linear2.bias,
        ln2s=layer.norm2.weight, ln2b=layer.norm2.bias,
    )


def _check(x, pos, k_in, v_in, valid_mask, params, heads: int, self_attn: bool):
    """The checks before a launch. Returns (B, Lq, Lk, D, F)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_stream_layer: the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"fused_stream_layer: x must be (B, Lq, D), got {tuple(x.shape)}")
    B, Lq, D = x.shape
    streams = [x, pos] if self_attn else [x, pos, k_in, v_in]
    if any(t is None or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
           for t in streams):
        raise ValueError("fused_stream_layer: x, pos (and k_in, v_in) must be contiguous, "
                         "of one dtype, on one device")
    Lk = Lq if self_attn else k_in.shape[1]
    F = params["w1"].shape[0]
    shapes = {"wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,), "wv": (D, D), "bv": (D,),
              "wo": (D, D), "bo": (D,), "ln1s": (D,), "ln1b": (D,), "w1": (F, D), "b1": (F,),
              "alpha": (1,), "w2": (D, F), "b2": (D,), "ln2s": (D,), "ln2b": (D,)}
    bad = [n for n, s in shapes.items() if tuple(params[n].shape) != s]
    if (pos.shape != x.shape or bad or D % heads
            or (not self_attn and (k_in.shape != (B, Lk, D) or v_in.shape != (B, Lk, D)))
            or (valid_mask is not None and tuple(valid_mask.shape) != (B, Lk))):
        raise ValueError(
            f"fused_stream_layer: shapes x {tuple(x.shape)}, pos {tuple(pos.shape)}, "
            f"k_in {None if k_in is None else tuple(k_in.shape)}, heads {heads}, "
            f"mask {None if valid_mask is None else tuple(valid_mask.shape)}, params {bad}"
        )
    if D % K_STEP or F % K_STEP:
        raise ValueError(f"fused_stream_layer: the kernel takes D and F multiples of {K_STEP}, "
                         f"got D {D}, F {F}")
    if x.device.type != "cuda":
        raise ValueError(f"fused_stream_layer: unsupported device {x.device}")
    if any(t.device != x.device for t in params.values()):
        raise ValueError("fused_stream_layer: every weight must lie on x's device")
    return B, Lq, Lk, D, F


def fused_stream_layer(x, pos, k_in, v_in, valid_mask: Optional[torch.Tensor],
                       pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]],
                       params: Dict[str, torch.Tensor], heads: int, self_attn: bool):
    """One post-norm layer (the encoder flavour when self_attn, else T2V) with
    the TPU kernel's numerics. CPU tensors take the plain version; CUDA
    tensors launch the kernel (float32 or bf16; D and F multiples of 32) or
    raise. Raises for an input that requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("fused_stream_layer", x, pos, k_in, v_in, *params.values())
    if x.device.type == "cpu":
        return stream_layer_reference(x, pos, k_in, v_in, valid_mask, pair_factors, params,
                                      heads, self_attn)
    B, Lq, Lk, D, F = _check(x, pos, k_in, v_in, valid_mask, params, heads, self_attn)
    from ..kernels.build import load

    lib = load("stream_layer")
    scratch_elems = lib.stream_layer_scratch_elems
    scratch_elems.restype = ctypes.c_longlong
    scratch_elems.argtypes = [ctypes.c_int] * 4
    dev = x.device
    mask = mask_u8(valid_mask, B, Lk, dev)
    qf = kf = None
    if pair_factors is not None:
        qf, kf = factors_u8(pair_factors, B, heads, Lq, Lk, dev)
    weights = [params[n].float().contiguous() for n in WEIGHT_NAMES]
    out = torch.empty_like(x)
    scratch = torch.empty(B * scratch_elems(Lq, Lk, D, F), dtype=x.dtype, device=dev)
    logits = torch.empty(B, Lq, Lk, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    operands = [x, pos, None if self_attn else k_in, None if self_attn else v_in, mask, qf, kf,
                *weights, out, scratch, logits]
    fn = lib.stream_layer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(operands) + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    err = fn(*(ptr(t) for t in operands), B, Lq, Lk, D, heads, F,
             int(x.dtype == torch.bfloat16), int(bool(self_attn)), float((D // heads) ** -0.5),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stream_layer kernel launch failed: cudaError {err}")
    launches += 1
    return out
