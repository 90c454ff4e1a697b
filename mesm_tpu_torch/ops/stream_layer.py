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

The kernel reads its weights as tiles in the order it walks them
(`kernel_weights`, kept once per weight version in the cache of
ops/_weight_cache.py): each head's Wk, Wv, Wq rows padded to the head_dim
of an attention instance (`padded_head_dim`: 16, 32, 64 or 128), then one
stream of Wo, W1 and W2 tiles; every width padded with zeros (D and the
attention width H * hdp to 64, F to 64), bf16 tiles of 64 columns with
their 16-byte chunks swizzled, fp32 tiles of 32 columns split into hi and
lo (3xTF32). So the kernel takes any D whose head_dim is at most 128, any
F, Lq and Lk: bf16 as many keys as fit a block's shared memory, fp32 any
(`stream_layer_config` says).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..kernels import refuse_autograd
from ..models.layers import PReLU
from ._weight_cache import Entry, derived
from .attention_packed import factors_u8, mask_u8

NEG_INF = -1e9
LN_EPS = 1e-5
# the head dims of the kernel's attention instances; a smaller head_dim is
# zero-padded to the next of them
HEAD_DIMS = (16, 32, 64, 128)
# rows of a weight tile of the kernel's second phase, hidden columns of an
# FFN chunk; D, F and the attention width are padded to a multiple of it
TILE = 64
WEIGHT_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln1s", "ln1b",
                "w1", "b1", "alpha", "w2", "b2", "ln2s", "ln2b")

# kernel launches since import (or since the caller last set it to 0)
launches = 0
# weight layouts computed by kernel_weights (cache misses), counted alike
weight_layouts = 0


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
    if padded_head_dim(D // heads) is None:
        raise ValueError(f"fused_stream_layer: the kernel takes a head_dim up to {HEAD_DIMS[-1]}, "
                         f"got D {D} / {heads} heads")
    if x.device.type != "cuda":
        raise ValueError(f"fused_stream_layer: unsupported device {x.device}")
    if any(t.device != x.device for t in params.values()):
        raise ValueError("fused_stream_layer: every weight must lie on x's device")
    return B, Lq, Lk, D, F


def padded_head_dim(hd: int) -> Optional[int]:
    """The head_dim of the kernel instance a head of hd columns runs on (the
    smallest of HEAD_DIMS at least hd), or None above them."""
    return next((p for p in HEAD_DIMS if p >= hd), None)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 as the kernels round (half a tf32 ulp added to the
    magnitude, the 13 low bits cleared: attention_tf32.cuh tf32())."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def weight_tiles(w: torch.Tensor, rows: int, bf16: bool) -> torch.Tensor:
    """The tiles of a padded weight w (N, K) (N a multiple of rows; K of 64
    in bf16, of 32 in fp32), (N // rows, K // depth, tile elements), tile
    (n0, k0) holding rows n0 * rows.. and depth k0 * depth..:
    bf16: rows x 64, element (n, k) at n * 64 + ((k // 8) ^ (n % 8)) * 8 +
    k % 8 (the 16-byte chunks of a row swizzled by the row);
    fp32: rows x 36 of hi = tf32(w), then rows x 36 of lo = tf32(w - hi),
    columns 32-35 zero."""
    N, K = w.shape
    nb = N // rows
    if bf16:
        t = w.to(torch.bfloat16).reshape(nb, rows, K // 64, 8, 8).permute(0, 2, 1, 3, 4)
        n = torch.arange(rows, device=w.device)[:, None]
        chunk = torch.arange(8, device=w.device)[None, :] ^ (n % 8)
        return t[:, :, n, chunk].reshape(nb, K // 64, rows * 64)
    t = w.float().reshape(nb, rows, K // 32, 32).permute(0, 2, 1, 3)
    hi = _tf32(t)
    lo = _tf32(t - hi)
    out = t.new_zeros(nb, K // 32, 2, rows, 36)
    out[:, :, 0, :, :32] = hi
    out[:, :, 1, :, :32] = lo
    return out.reshape(nb, K // 32, 2 * rows * 36)


def _pad(t: torch.Tensor, *shape: int) -> torch.Tensor:
    out = t.new_zeros(*shape, dtype=torch.float32)
    out[tuple(slice(0, n) for n in t.shape)] = t.float()
    return out


def layout_weights(params: Dict[str, torch.Tensor], heads: int, bf16: bool,
                   group: int = 1) -> Dict[str, torch.Tensor]:
    """The kernel's weight operands (stream_layer.cu stream_layer_launch),
    computed from the parameters, for phase-1 items of `group` heads:

    - w1s: phase 1's tiles, (Hp / group, 3, Dq // depth) tiles of group hdp
      rows: the group's rows of wk, wv, wq (k, v, q), each head's hd rows
      padded to hdp, the heads padded with zeros to Hp = heads rounded up
      to `group`;
    - bqkv: (3, Hp, hdp) f32, bk, bv, bq the same way;
    - w2s: phase 2's stream of 64-row tiles, in the order the kernel takes
      them: Wo (Dq, Ka) by (row tile, depth tile), with the head columns at
      h * hdp; then for each chunk j of 64 hidden columns W1's rows of the
      chunk (depth D), and W2's columns of the chunk by (row tile, depth
      tile);
    - bo, b2 (Dq), b1 (Fp) f32 zero-padded; ln1s, ln1b, ln2s, ln2b (D) and
      alpha (1,) f32.

    hdp = padded_head_dim(D // heads), Dq = D and Ka = H * hdp rounded up to
    64, Fp = F rounded up to 64; the weights are rounded to the stream dtype
    (bf16), or split into tf32 hi and lo (fp32). Flat tensors, contiguous."""
    p = params
    D, F = p["w1"].shape[1], p["w1"].shape[0]
    hd = D // heads
    hdp = padded_head_dim(hd)
    Dq, Ka, Fp = _round_up(D, TILE), _round_up(heads * hdp, TILE), _round_up(F, TILE)
    Hp = _round_up(heads, group)
    depth = 64 if bf16 else 32
    qkv = []
    for name in ("wk", "wv", "wq"):
        w = p[name].float().reshape(heads, hd, D)
        wp = w.new_zeros(Hp, hdp, Dq)
        wp[:heads, :hd, :D] = w
        wp = wp.reshape(Hp // group, group * hdp, Dq)
        qkv.append(torch.stack([weight_tiles(wg, group * hdp, bf16)[0] for wg in wp]))
    w1s = torch.stack(qkv, 1).reshape(-1)
    bqkv = torch.zeros(3, Hp, hdp, device=p["bq"].device)
    for i, name in enumerate(("bk", "bv", "bq")):
        bqkv[i, :heads, :hd] = p[name].float().reshape(heads, hd)
    wo = torch.zeros(Dq, Ka, device=p["wo"].device)
    wo[:D, :heads * hdp].view(D, heads, hdp)[:, :, :hd] = p["wo"].float().reshape(D, heads, hd)
    wo_t = weight_tiles(wo, TILE, bf16)
    w1_t = weight_tiles(_pad(p["w1"], Fp, Dq), TILE, bf16)
    w2_t = weight_tiles(_pad(p["w2"], Dq, Fp), TILE, bf16)
    per = TILE // depth  # depth tiles of a hidden chunk
    stream = [wo_t.reshape(-1)]
    for j in range(Fp // TILE):
        stream += [w1_t[j].reshape(-1), w2_t[:, j * per:(j + 1) * per].reshape(-1)]
    vec = lambda n: p[n].detach().float().contiguous().clone()  # noqa: E731
    return dict(
        w1s=w1s.contiguous(), bqkv=bqkv.reshape(-1), w2s=torch.cat(stream).contiguous(),
        bo=_pad(p["bo"], Dq), b1=_pad(p["b1"], Fp), b2=_pad(p["b2"], Dq),
        ln1s=vec("ln1s"), ln1b=vec("ln1b"), ln2s=vec("ln2s"), ln2b=vec("ln2b"),
        alpha=vec("alpha").reshape(1),
    )


# id(wq) -> _weight_cache.Entry; an entry goes when its wq is freed
_weight_cache: Dict[int, Entry] = {}


def kernel_weights(params: Dict[str, torch.Tensor], heads: int, dtype: torch.dtype,
                   group: int = 1):
    """layout_weights of this version of the 17 parameters for the stream
    dtype, computed once per version, dtype, head count and head group (the
    cache of ops/_weight_cache.py: keyed on the tensors' identity, refreshed
    after an in-place update, holding them by weak reference only)."""
    global weight_layouts
    values = derived(_weight_cache, [params[n] for n in WEIGHT_NAMES])
    key = (dtype, heads, group)
    if key not in values:
        with torch.no_grad():
            values[key] = layout_weights({n: params[n].detach() for n in WEIGHT_NAMES}, heads,
                                         dtype == torch.bfloat16, group)
        weight_layouts += 1
    return values[key]


def fused_stream_layer(x, pos, k_in, v_in, valid_mask: Optional[torch.Tensor],
                       pair_factors: Optional[Tuple[torch.Tensor, torch.Tensor]],
                       params: Dict[str, torch.Tensor], heads: int, self_attn: bool):
    """One post-norm layer (the encoder flavour when self_attn, else T2V) with
    the TPU kernel's numerics. CPU tensors take the plain version; CUDA
    tensors launch the kernel (float32 or bf16; a head_dim up to 128; bf16
    keys as many as fit a block's shared memory) or raise, with the weights
    laid out once per version (`kernel_weights`). Raises for an input that
    requires grad in grad mode (no graph)."""
    global launches
    refuse_autograd("fused_stream_layer", x, pos, k_in, v_in, *params.values())
    if x.device.type == "cpu":
        return stream_layer_reference(x, pos, k_in, v_in, valid_mask, pair_factors, params,
                                      heads, self_attn)
    B, Lq, Lk, D, F = _check(x, pos, k_in, v_in, valid_mask, params, heads, self_attn)
    from ..kernels.build import load

    lib = load("stream_layer")
    is_bf16 = int(x.dtype == torch.bfloat16)
    hdp = padded_head_dim(D // heads)
    cfg = (ctypes.c_int * 7)()  # smem, R, keys, stages 1 and 2, query rows, heads an item
    config = lib.stream_layer_config
    config.restype = ctypes.c_int
    config.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    if config(is_bf16, hdp, Lk, D, heads, F, ctypes.addressof(cfg)) != 0:
        raise ValueError(f"fused_stream_layer: {Lk} keys of head_dim {hdp} at D {D} do not fit a "
                         f"block's shared memory in {x.dtype}")
    dev = x.device
    mask = mask_u8(valid_mask, B, Lk, dev)
    qf = kf = None
    if pair_factors is not None:
        qf, kf = factors_u8(pair_factors, B, heads, Lq, Lk, dev)
    w = kernel_weights(params, heads, x.dtype, cfg[6])
    out = torch.empty_like(x)
    att = torch.empty(B, Lq, _round_up(heads * hdp, TILE), dtype=x.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    operands = [x, pos, None if self_attn else k_in, None if self_attn else v_in, mask, qf, kf,
                w["w1s"], w["bqkv"], w["w2s"], w["bo"], w["b1"], w["b2"], w["ln1s"], w["ln1b"],
                w["ln2s"], w["ln2b"], w["alpha"], att, out]
    fn = lib.stream_layer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(operands) + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    err = fn(*(ptr(t) for t in operands), B, Lq, Lk, D, heads, F, hdp, is_bf16,
             int(bool(self_attn)), float((D // heads) ** -0.5),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stream_layer kernel launch failed: cudaError {err}")
    launches += 1
    return out
