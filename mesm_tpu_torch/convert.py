"""Carry weights into the port: JAX-package parameter trees and upstream
torch checkpoints -> the port's state dict.

The port's modules use the upstream torch state-dict names, so an upstream
`.ckpt` ({model, optimizer, lr_scheduler, epoch, opt}, text encoder
stripped) loads with no conversion. A parameter tree of the JAX package
(numpy arrays, e.g. a flax init) goes through `state_dict_from_jax_params`,
which reads this module's copy of the name mapping of
mesm_tpu/convert.py:92-182: Linear kernels transpose ((in, out) -> (out, in)),
LayerNorm scale -> weight.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .models.mesm import MESMConfig

# entry: (torch_key, flax_path, transpose)
MapEntry = Tuple[str, Tuple[str, ...], bool]


def _linear(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    return [
        (torch_prefix + ".weight", flax_path + ("kernel",), True),
        (torch_prefix + ".bias", flax_path + ("bias",), False),
    ]


def _norm(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    return [
        (torch_prefix + ".weight", flax_path + ("scale",), False),
        (torch_prefix + ".bias", flax_path + ("bias",), False),
    ]


def _linear_block(torch_prefix: str, flax_path: Tuple[str, ...], layer_norm=True) -> List[MapEntry]:
    """reference LinearLayer: LayerNorm + net.1 Linear (model/model.py:412-434)."""
    out = []
    if layer_norm:
        out += _norm(torch_prefix + ".LayerNorm", flax_path + ("norm",))
    out += _linear(torch_prefix + ".net.1", flax_path + ("proj", "linear"))
    return out


def _mlp(torch_prefix: str, flax_path: Tuple[str, ...], n_layers: int) -> List[MapEntry]:
    out = []
    for i in range(n_layers):
        out += _linear(f"{torch_prefix}.layers.{i}", flax_path + (f"layer{i}",))
    return out


def _proj_attention(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    """torch nn.MultiheadAttention -> ProjAttention (out_proj is a bare Dense)."""
    return [
        (torch_prefix + ".in_proj_weight", flax_path + ("in_proj_kernel",), True),
        (torch_prefix + ".in_proj_bias", flax_path + ("in_proj_bias",), False),
    ] + _linear(torch_prefix + ".out_proj", flax_path + ("out_proj",))


def _core_attention(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    """projection-free MultiheadAttention -> CoreAttention (out_proj only)."""
    return _linear(torch_prefix + ".out_proj", flax_path + ("out_proj",))


def _ffn(torch_prefix: str, flax_path: Tuple[str, ...], suffix: str = "") -> List[MapEntry]:
    """linear1/linear2 + PReLU slope. `suffix` handles the TwoMLP `_1` names."""
    out = _linear(f"{torch_prefix}.linear1{suffix}", flax_path + ("linear1",))
    out += _linear(f"{torch_prefix}.linear2{suffix}", flax_path + ("linear2",))
    # the reference creates one PReLU per layer via the activation factory;
    # TwoMLP layers share the single `activation` module between both FFNs.
    out += [(f"{torch_prefix}.activation.weight", flax_path + ("PReLU_0", "alpha"), False)]
    return out


def _t2v_layer(tp: str, fp: Tuple[str, ...], two_mlp: bool) -> List[MapEntry]:
    out = _proj_attention(tp + ".self_attn", fp + ("cross_attn",))
    out += _norm(tp + ".norm1", fp + ("norm1",))
    out += _norm(tp + ".norm2", fp + ("norm2",))
    out += _ffn(tp, fp + ("ffn",))
    if two_mlp:
        out += _norm(tp + ".norm1_1", fp + ("norm1_mlm",))
        out += _norm(tp + ".norm2_1", fp + ("norm2_mlm",))
        out += _linear(tp + ".linear1_1", fp + ("ffn_mlm", "linear1"))
        out += _linear(tp + ".linear2_1", fp + ("ffn_mlm", "linear2"))
        out += [(tp + ".activation.weight", fp + ("ffn_mlm", "PReLU_0", "alpha"), False)]
    return out


def build_mapping(cfg: MESMConfig) -> List[MapEntry]:
    m: List[MapEntry] = []
    # input projections
    for name in ("input_txt_proj", "input_vid_proj"):
        for i in range(cfg.n_input_proj):
            m += _linear_block(f"{name}.{i}", (name, f"block{i}"))
    # heads and small params
    m += _mlp("span_embed", ("span_embed",), 3)
    m += _linear("class_embed", ("class_embed", "linear"))
    m += [("query_embed.weight", ("query_embed",), False)]
    m += _linear("saliency_proj1", ("saliency_proj1", "linear"))
    m += _linear("saliency_proj2", ("saliency_proj2", "linear"))
    m += [
        ("global_rep_token", ("global_rep_token",), False),
        ("global_rep_pos", ("global_rep_pos",), False),
    ]
    if cfg.use_txt_pos:
        m += [
            ("txt_position_embed.position_embeddings.weight",
             ("txt_position_embed", "embedding"), False),
        ]
        m += _norm("txt_position_embed.LayerNorm", ("txt_position_embed", "norm"))
    # enhance encoder (TwoMLP when share_mlp False). The reference constructs
    # it even with rec_fw off (runner.py:268) but never runs it; flax only
    # materializes params for modules that are called, so gate on rec_fw.
    if cfg.rec_fw:
        for i in range(cfg.num_recfw_layers):
            m += _t2v_layer(
                f"enhance_encoder.t2v_encoder.layers.{i}",
                ("enhance_encoder", f"layer{i}"),
                two_mlp=not cfg.share_mlp,
            )
    # aligner
    for i in range(cfg.t2v_layers):
        m += _t2v_layer(
            f"t2v_encoder.t2v_encoder.layers.{i}", ("t2v_encoder", f"layer{i}"), False
        )
    # DETR encoder
    for i in range(cfg.enc_layers):
        tp = f"transformer.encoder.layers.{i}"
        fp = ("transformer", "encoder", f"layer{i}")
        m += _proj_attention(tp + ".self_attn", fp + ("self_attn",))
        m += _norm(tp + ".norm1", fp + ("norm1",))
        m += _norm(tp + ".norm2", fp + ("norm2",))
        m += _ffn(tp, fp + ("ffn",))
    # DETR decoder
    for i in range(cfg.dec_layers):
        tp = f"transformer.decoder.layers.{i}"
        fp = ("transformer", "decoder", f"layer{i}")
        for proj in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                     "sa_kpos_proj", "sa_v_proj"):
            m += _linear(f"{tp}.{proj}", fp + (proj,))
        m += _core_attention(tp + ".self_attn", fp + ("self_attn",))
        ca = ["ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj", "ca_kpos_proj",
              "ca_qpos_sine_proj"]
        if i == 0:  # keep_query_pos=False strips ca_qpos_proj from layers > 0
            ca.append("ca_qpos_proj")
        for proj in ca:
            m += _linear(f"{tp}.{proj}", fp + (proj,))
        m += _core_attention(tp + ".cross_attn", fp + ("cross_attn",))
        for n in ("norm1", "norm2", "norm3"):
            m += _norm(f"{tp}.{n}", fp + (n,))
        m += _ffn(tp, fp + ("ffn",))
    dp = ("transformer", "decoder")
    m += _mlp("transformer.decoder.ref_point_head", dp + ("ref_point_head",), 2)
    m += _mlp("transformer.decoder.query_scale", dp + ("query_scale",), 2)
    m += _mlp("transformer.decoder.bbox_embed", dp + ("bbox_embed",), 3)
    m += _mlp("transformer.decoder.ref_anchor_head", dp + ("ref_anchor_head",), 2)
    m += _norm("transformer.decoder.norm", dp + ("norm",))
    # MLM pieces
    if cfg.rec_fw:
        m += [
            ("masked_token", ("masked_token",), False),
            ("unknown_token", ("unknown_token",), False),
        ]
        m += _linear_block("output_txt_proj.0", ("output_txt_proj0",))
        m += _linear("output_txt_proj.1", ("output_txt_proj1", "linear"))
    # SS-MESM
    if cfg.rec_ss:
        sp = ("ss_reconstructor",)
        m += [("ss_reconstructor.masked_sent_token", sp + ("masked_sent_token",), False)]
        for i in range(cfg.num_recss_layers):
            m += _t2v_layer(
                f"ss_reconstructor.recon_trans.layers.{i}",
                sp + ("recon_trans", f"layer{i}"),
                False,
            )
        m += _linear_block("ss_reconstructor.output_sent_proj.0", sp + ("out_proj0",))
        m += _linear_block("ss_reconstructor.output_sent_proj.1", sp + ("out_proj1",))
    return m


def _scanned_stacks(cfg: MESMConfig):
    """(tree path, num layers) of every stack folded by cfg.scan_layers.
    Stacks of 1 layer stay unrolled (T2VEncoder/TransformerEncoder fall back
    to the loop there)."""
    out = []
    if cfg.rec_fw and cfg.num_recfw_layers > 1:
        out.append((("enhance_encoder",), cfg.num_recfw_layers))
    if cfg.t2v_layers > 1:
        out.append((("t2v_encoder",), cfg.t2v_layers))
    if cfg.rec_ss and cfg.num_recss_layers > 1:
        out.append((("ss_reconstructor", "recon_trans"), cfg.num_recss_layers))
    if cfg.enc_layers > 1:
        out.append((("transformer", "encoder"), cfg.enc_layers))
    return out


def unstack_scanned(params: Dict, cfg: MESMConfig) -> Dict:
    """A scan-layout tree ('layers'/'layer' with a leading layer axis, from
    scan_layers=True) -> per-layer 'layer{i}' subtrees. In place; returns it."""

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for path, n in _scanned_stacks(cfg):
        node = _get_path(params, path)
        if "layers" not in node:
            continue
        stacked = node.pop("layers")["layer"]
        for i in range(n):
            node[f"layer{i}"] = take(stacked, i)
    return params


def _get_path(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def state_dict_from_jax_params(params_np: Dict, cfg: MESMConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's MESM parameter tree (nested dicts of arrays) -> the
    port's state dict (float32 tensors). Scan-layout trees are unstacked
    first. Every entry of the mapping must be present."""
    params = unstack_scanned(_copy_tree(params_np), cfg)
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, transpose in build_mapping(cfg):
        if tkey in out:  # TwoMLP layers share one PReLU slope
            continue
        arr = np.asarray(_get_path(params, fpath), dtype=np.float32)
        out[tkey] = torch.from_numpy(np.array(arr.T if transpose else arr, order="C"))
    return out


def model_state_from_checkpoint(state_dict: Dict, cfg: MESMConfig) -> Dict[str, torch.Tensor]:
    """An upstream model state dict -> the keys the port's MESM has for `cfg`:
    drops the modules the upstream model constructs but this config never
    runs (as mesm_tpu/convert.py:264-275 allows them), so that
    load_state_dict(strict=True) sees exactly the port's keys."""
    allowed = ["text_encoder", "vid_position_embed"]
    if not cfg.use_txt_pos:
        allowed.append("txt_position_embed")
    if not cfg.rec_fw:
        allowed += ["enhance_encoder", "output_txt_proj", "masked_token", "unknown_token"]
    if not cfg.rec_ss:
        allowed.append("ss_reconstructor")
    return {
        k: torch.as_tensor(v).float()
        for k, v in state_dict.items()
        if not any(k.startswith(a) for a in allowed)
    }


def load_mesm_checkpoint(path: str, cfg: MESMConfig):
    """An upstream-layout torch checkpoint -> (model state dict, epoch)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    state = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    epoch = payload.get("epoch", -1) if isinstance(payload, dict) else -1
    return model_state_from_checkpoint(state, cfg), epoch
