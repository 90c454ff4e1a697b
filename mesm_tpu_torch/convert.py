"""Carry weights into the port: JAX-package parameter trees and upstream
torch checkpoints -> the port's state dict.

The port's modules use the upstream torch state-dict names, so an upstream
`.ckpt` ({model, optimizer, lr_scheduler, epoch, opt}, text encoder
stripped) loads with no conversion. A parameter tree of the JAX package
(numpy arrays, e.g. a flax init) goes through `state_dict_from_jax_params`,
which reads this module's copy of the name mapping of
mesm_tpu/convert.py:92-182: Linear kernels transpose ((in, out) -> (out, in)),
LayerNorm scale -> weight.

`python -m mesm_tpu_torch.convert to-native|to-torch` is the JAX package's
checkpoint CLI (mesm_tpu/convert.py:310-357; see `_main`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .models.mesm import MESMConfig
from .utils.checkpoint import V1_FORMAT, find_state, load_checkpoint

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


def stack_scanned(params: Dict, cfg: MESMConfig) -> Dict:
    """Per-layer 'layer{i}' subtrees -> the scan layout ('layers'/'layer',
    each leaf with a leading layer axis) of mesm_tpu/convert.py:200. In
    place; returns it."""

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([np.asarray(t) for t in trees])

    for path, n in _scanned_stacks(cfg):
        node = _get_path(params, path)
        node["layers"] = {"layer": stack([node.pop(f"layer{i}") for i in range(n)])}
    return params


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
    return _convert(unstack_scanned(_copy_tree(params_np), cfg), build_mapping(cfg))


def _convert(params: Dict, mapping: List[MapEntry], optional: bool = False,
             last_wins: bool = False, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The tensors of `mapping` read from `params`. Where two paths map to
    one key (the TwoMLP layers' one PReLU slope) the first wins, or the last
    with `last_wins`; with `optional` a path the tree lacks is left out; a
    `dtype` of None keeps each array's."""
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, transpose in mapping:
        if tkey in out and not last_wins:
            continue
        try:
            arr = np.asarray(_get_path(params, fpath), dtype=dtype)
        except KeyError:
            if optional:
                continue
            raise
        out[tkey] = torch.from_numpy(np.array(arr.T if transpose else arr, order="C"))
    return out


def layer_state_dict_from_jax_params(params_np: Dict, flavour: str) -> Dict[str, torch.Tensor]:
    """One layer's parameter tree of the JAX package -> the state dict of the
    port's layer: a TransformerEncoderLayer ("encoder", attention
    `self_attn`) or a single-FFN T2VLayer ("t2v", attention `cross_attn`),
    with the names and layouts of the whole-model mapping above."""
    attn = {"encoder": "self_attn", "t2v": "cross_attn"}[flavour]
    mapping = (_proj_attention("L.self_attn", (attn,)) + _norm("L.norm1", ("norm1",))
               + _norm("L.norm2", ("norm2",)) + _ffn("L", ("ffn",)))
    out = _convert(_copy_tree(params_np), mapping)
    return {key[len("L."):]: value for key, value in out.items()}


def clip_state_dict_from_jax_params(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP tower parameters (mesm_tpu/models/
    text_encoder.py CLIPTextEncoder, numpy) -> the port's tower state dict,
    the inverse of mesm_tpu/runner.py:178 convert_clip_torch_weights."""
    n_layers = sum(1 for k in params_np if k.startswith("resblock"))
    mapping: List[MapEntry] = [
        ("token_embedding.weight", ("token_embedding",), False),
        ("positional_embedding", ("positional_embedding",), False),
        ("text_projection", ("text_projection",), False),
    ] + _norm("ln_final", ("ln_final",))
    for i in range(n_layers):
        tp, fp = f"transformer.resblocks.{i}", (f"resblock{i}",)
        mapping += _norm(tp + ".ln_1", fp + ("ln_1",)) + _norm(tp + ".ln_2", fp + ("ln_2",))
        mapping += [(tp + ".attn.in_proj_weight", fp + ("attn_in_proj_kernel",), True),
                    (tp + ".attn.in_proj_bias", fp + ("attn_in_proj_bias",), False)]
        mapping += _linear(tp + ".attn.out_proj", fp + ("attn_out_proj",))
        mapping += _linear(tp + ".mlp.c_fc", fp + ("mlp_c_fc",))
        mapping += _linear(tp + ".mlp.c_proj", fp + ("mlp_c_proj",))
    return _convert(_copy_tree(params_np), mapping)


def model_state_from_checkpoint(state_dict: Dict, cfg: MESMConfig) -> Dict[str, torch.Tensor]:
    """An upstream model state dict -> the keys the port's MESM has for `cfg`:
    drops the modules the upstream model constructs but this config never
    runs (as mesm_tpu/convert.py:264-275 allows them), so that
    load_state_dict(strict=True) sees exactly the port's keys."""
    unrun = _unrun_modules(cfg)
    return {k: torch.as_tensor(v).float() for k, v in state_dict.items() if not k.startswith(unrun)}


def _unrun_modules(cfg: MESMConfig) -> Tuple[str, ...]:
    """The key prefixes of the modules the upstream model constructs but
    `cfg` never runs (mesm_tpu/convert.py:264-269): the text encoder, the
    video position embedding, the text one without use_txt_pos, the
    enhance path without rec_fw, SS-MESM without rec_ss."""
    unrun = ["text_encoder", "vid_position_embed"]
    if not cfg.use_txt_pos:
        unrun.append("txt_position_embed")
    if not cfg.rec_fw:
        unrun += ["enhance_encoder", "output_txt_proj", "masked_token", "unknown_token"]
    if not cfg.rec_ss:
        unrun.append("ss_reconstructor")
    return tuple(unrun)


def jax_params_from_state_dict(state_dict: Dict, cfg: MESMConfig) -> Dict:
    """The port's state dict -> the JAX package's MESM parameter tree
    (nested dicts of float32 numpy), per-layer (no scan layout): the inverse
    of state_dict_from_jax_params, as mesm_tpu/convert.py:240
    torch_state_dict_to_params. The TwoMLP layers' one PReLU slope fills
    both of the JAX package's."""
    params: Dict = {}
    for tkey, fpath, transpose in build_mapping(cfg):
        arr = torch.as_tensor(state_dict[tkey]).detach().float().cpu().numpy()
        node = params
        for p in fpath[:-1]:
            node = node.setdefault(p, {})
        node[fpath[-1]] = np.array(arr.T if transpose else arr, order="C")
    return params


def model_state_from_payload(payload, cfg: MESMConfig) -> Dict[str, torch.Tensor]:
    """A checkpoint's model state in the port's keys, from either format
    (utils/checkpoint.load_checkpoint): a `mesm_tpu.v1` tree goes through
    state_dict_from_jax_params (scan layouts unstacked), an upstream state
    dict as it is."""
    if isinstance(payload, dict) and payload.get("format") == V1_FORMAT:
        return model_state_from_checkpoint(state_dict_from_jax_params(payload["model"], cfg), cfg)
    state = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    return model_state_from_checkpoint(state, cfg)


def adamw_state_from_optax(opt_state, cfg: MESMConfig):
    """The optax chain state of a v1 checkpoint (clip_by_global_norm, then
    inject_hyperparams(adamw): mesm_tpu/parallel/step.py:33-55) -> ({port
    parameter name: torch AdamW state}, learning rate): mu -> exp_avg and
    nu -> exp_avg_sq through the parameters' mapping and transposes, the
    Adam count -> step. The TwoMLP layers' shared PReLU slope takes the
    moments of the JAX package's first one."""
    adam = find_state(opt_state, "ScaleByAdamState")
    if adam is None:
        raise ValueError("no ScaleByAdamState in the checkpoint's optimizer state")
    hyper = None
    for name in ("InjectStatefulHyperparamsState", "InjectHyperparamsState"):
        node = find_state(opt_state, name)
        if node is not None:
            hyper = node.hyperparams
            break
    lr = None if hyper is None else float(np.asarray(hyper["learning_rate"]))
    mu = state_dict_from_jax_params(adam.mu, cfg)
    nu = state_dict_from_jax_params(adam.nu, cfg)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {k: {"step": step.clone(), "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}, lr


def load_mesm_checkpoint(path: str, cfg: MESMConfig):
    """A checkpoint of either format (upstream torch layout or the JAX
    package's mesm_tpu.v1) -> (model state dict, epoch)."""
    payload = load_checkpoint(path)
    epoch = payload.get("epoch", -1) if isinstance(payload, dict) else -1
    return model_state_from_payload(payload, cfg), epoch


def jax_params_from_checkpoint(state_dict: Dict, cfg: MESMConfig, scan_layers: bool = False) -> Dict:
    """An upstream model state dict -> the JAX package's parameter tree, as
    mesm_tpu/convert.py:240 torch_state_dict_to_params builds it: every
    mapped key must be there, and every other key must belong to a module
    the upstream model constructs but `cfg` never runs; the scan layout
    where `scan_layers`."""
    missing = [k for k, _, _ in build_mapping(cfg) if k not in state_dict]
    if missing:
        raise KeyError(f"torch checkpoint missing {missing[:10]} (+{max(len(missing) - 10, 0)})")
    used = {k for k, _, _ in build_mapping(cfg)}
    unrun = _unrun_modules(cfg)
    leftovers = [k for k in state_dict if k not in used and not k.startswith(unrun)]
    if leftovers:
        raise KeyError(f"unmapped torch keys: {leftovers[:10]} (+{max(len(leftovers) - 10, 0)})")
    params = jax_params_from_state_dict(state_dict, cfg)
    return stack_scanned(params, cfg) if scan_layers else params


def checkpoint_state_from_jax_params(params: Dict, cfg: MESMConfig) -> Dict[str, torch.Tensor]:
    """A JAX-package parameter tree (either layout) -> the upstream-named
    state dict, as mesm_tpu/convert.py:281 params_to_torch_state_dict
    writes it: paths the tree lacks are left out, where two paths map to one
    key (the TwoMLP layers' one PReLU slope) the last one wins, and each
    array keeps its dtype."""
    return _convert(unstack_scanned(_copy_tree(params), cfg), build_mapping(cfg), optional=True,
                    last_wins=True, dtype=None)


def _main(argv=None):
    """Convert checkpoints between the upstream torch layout and the JAX
    package's mesm_tpu.v1 format (mesm_tpu/convert.py:310-357), on the host:

        python -m mesm_tpu_torch.convert to-native ref.ckpt out.ckpt --opt_json opt.json
        python -m mesm_tpu_torch.convert to-torch  native.ckpt out.pt

    to-native writes a v1 file (no optimizer state) in the layout the run's
    opt.json asks for (scan_layers on: the stacks' scan layout); opt.json is
    written before the TEF bump, so use_tef adds the 2 TEF channels to
    v_feat_dim here, as the runtime does. to-torch writes {"model": the
    upstream-named state dict, "epoch"}, from the runtime opt the v1 file
    keeps."""
    import argparse
    import json
    import types

    from .runner import build_model_config
    from .utils.checkpoint import save_v1_checkpoint

    p = argparse.ArgumentParser(prog="python -m mesm_tpu_torch.convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("to-native")
    a.add_argument("src")
    a.add_argument("dst")
    a.add_argument("--opt_json", required=True,
                   help="the training run's opt.json (defines the architecture)")
    b = sub.add_parser("to-torch")
    b.add_argument("src")
    b.add_argument("dst")
    args = p.parse_args(argv)

    if args.cmd == "to-native":
        with open(args.opt_json) as f:
            opt = types.SimpleNamespace(**json.load(f))
        if getattr(opt, "use_tef", False):
            opt.v_feat_dim += 2
        cfg = build_model_config(opt)
        payload = torch.load(args.src, map_location="cpu", weights_only=False)
        state = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
        epoch = payload.get("epoch", -1) if isinstance(payload, dict) else -1
        params = jax_params_from_checkpoint(state, cfg,
                                            getattr(opt, "scan_layers", "off") == "on")
        save_v1_checkpoint(args.dst, params, epoch=epoch, opt=vars(opt))
        print(f"wrote {args.dst} (epoch {epoch})")
    else:
        payload = load_checkpoint(args.src)
        opt = types.SimpleNamespace(**payload["opt"])
        state = checkpoint_state_from_jax_params(payload["model"], build_model_config(opt))
        torch.save({"model": state, "epoch": payload.get("epoch", -1)}, args.dst)
        print(f"wrote {args.dst}")


if __name__ == "__main__":
    _main()
