"""The cases of tests/test_torch_seq_sharding.py, shared by the test process
(the single-process references) and its gloo workers
(tests/torch_seq_worker.py): one narrow fp32 model per config family from a
torch seed, dropout 0, one staged batch each, and the port's train step.

- charades: C+SF_C's criterion (shared MLP, no triplet);
- tacos: the TwoMLP enhance encoder and the saliency triplet, with the
  kernel dispatch "on", so the DETR encoder takes the fp32 batched route
  (kernel 6's plain version on the CPU) and its backward (kernel 9's);
- qvh: multi-clip targets, 3-annotator saliency labels and each row's
  SS-MESM video (`ss_video_feat`, a video-length key of its own length).

Each family is a case at grad_accum 1; TACoS is one at grad_accum 2 as well
(two microbatches of half the rows, each rank holding its rows of each).

Each family's video axes divide over 2 model ranks; the last row of each
batch is padding. `JAX_CASE` is tests/test_seq_sharding.py's geometry, with
dropout 0 so that the JAX step's draws (negatives, MLM masks) can be given
to the port's step."""
from __future__ import annotations

import numpy as np
import torch

from mesm_tpu_torch import kernels
from mesm_tpu_torch.data.pipeline import stage_batch
from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.models.mesm import MESM, MESMConfig
from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step

from synth import make_batch

BASE = dict(hidden_dim=32, v_feat_dim=70, t_feat_dim=20, nheads=4, dim_feedforward=64,
            num_recfw_layers=1, t2v_layers=2, enc_layers=2, dec_layers=2, num_recss_layers=1,
            num_queries=5, max_words_l=8, max_video_l=64, num_classes=30, dropout=0.0,
            input_dropout=0.0)
B, LV, LSS, T = 8, 64, 96, 5
FAMILIES = {
    "charades": dict(
        cfg=BASE, mode="auto",
        criterion=dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=4.0,
                       recfw_coef=0.1, recss_coef=0.1, cost_class=4.0, rank_coef=12.0)),
    "tacos": dict(
        cfg=dict(BASE, share_mlp=False, num_recfw_layers=2), mode="on",
        criterion=dict(span_coef=10.0, giou_coef=1.0, label_coef=6.0, saliency_coef=1.0,
                       recfw_coef=0.1, recss_coef=0.1, cost_class=6.0, rank_coef=1.0,
                       use_triplet=True)),
    "qvh": dict(
        cfg=BASE, mode="auto",
        criterion=dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=1.0,
                       recfw_coef=0.5, recss_coef=0.1, cost_class=4.0, rank_coef=12.0,
                       use_triplet=True, multi_clip=True)),
}
# case -> (family, grad_accum)
CASES = {**{family: (family, 1) for family in FAMILIES}, "tacos_accum2": ("tacos", 2)}
LR, WD, CLIP, SEED = 2e-4, 1e-4, 0.1, 5

# tests/test_seq_sharding.py's model, batch, criterion and optimizer
JAX_CASE = dict(
    cfg=dict(hidden_dim=32, v_feat_dim=24, t_feat_dim=20, nheads=4, dim_feedforward=64,
             num_queries=5, max_words_l=10, max_video_l=32, num_classes=50, dropout=0.0,
             input_dropout=0.0),
    batch=dict(B=8, Lv=32, Dv=24, Lw=10, Dt=20, G=2, n_groups=4),
    criterion=dict(recfw_coef=0.1, recss_coef=0.1), lr=2e-4, wd=1e-4, clip=0.1, key=5)


def host_batch(family: str) -> dict:
    """The family's collated host batch (numpy)."""
    rng = np.random.default_rng({"charades": 0, "tacos": 1, "qvh": 2}[family])
    cfg = FAMILIES[family]["cfg"]
    batch = make_batch(rng, B=B, Lv=LV, Dv=cfg["v_feat_dim"], Lw=cfg["max_words_l"],
                       Dt=cfg["t_feat_dim"], G=3, n_groups=4, T=T if family == "qvh" else 0,
                       vocab_classes=cfg["num_classes"])
    for key in ("video_feat_g", "video_mask_g", "video_slot"):  # eval-only fields
        batch.pop(key)
    if family == "qvh":  # each group's SS video, of its own length, stored once
        NG = int(batch["group_id"].max()) + 1
        ss_len = rng.integers(LSS // 2, LSS + 1, NG)
        ss_mask = np.arange(LSS)[None] < ss_len[:, None]
        batch["ss_video_feat_groups"] = (rng.normal(size=(NG, LSS, cfg["v_feat_dim"]))
                                         .astype(np.float32) * ss_mask[..., None])
        batch["ss_video_mask_groups"] = ss_mask
        batch["ss_group_slot"] = batch["group_id"].copy()
    batch["row_mask"] = np.arange(B) < B - 1
    return batch


def staged(family: str) -> dict:
    """The batch as the train loop stages it (the QVH SS video expanded to rows)."""
    return stage_batch(host_batch(family), False, "cpu")


def model(family: str) -> MESM:
    torch.manual_seed(0)
    return MESM(MESMConfig(**FAMILIES[family]["cfg"]))


def encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


class DispatchLog:
    """Records every decision of kernels.attention_kernel: (B, Lq, Lk,
    pair, training, route)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = kernels.attention_kernel

        def recorded(B, Lq, Lk, dtype, device, pair=False, training=False):
            route = self._orig(B, Lq, Lk, dtype, device, pair=pair, training=training)
            self.calls.append((B, Lq, Lk, bool(pair), bool(training), route or ""))
            return route

        kernels.attention_kernel = recorded
        return self

    def __exit__(self, *exc):
        kernels.attention_kernel = self._orig


def run_step(family: str, m, batch: dict, **step_kwargs):
    """One train step of `m` on `batch` (this rank's block under a shard)
    under the family's dispatch mode: (metrics, clipped gradients by name,
    the dispatch decisions)."""
    spec = FAMILIES[family]
    opt = build_optimizer(m, LR, WD)
    step = make_train_step(m, CriterionConfig(**spec["criterion"]), encode, opt, CLIP, SEED,
                           **step_kwargs)
    with kernels.pallas_scope(spec["mode"]), DispatchLog() as log, torch.enable_grad():
        out = step(batch, 0)
    metrics = {k: float(v) for k, v in out.items()}
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    return metrics, grads, log.calls


def jax_case_batch() -> dict:
    c = JAX_CASE["batch"]
    batch = make_batch(np.random.default_rng(0), **c)
    batch = {k: v for k, v in batch.items() if k not in ("video_feat_g", "video_mask_g", "video_slot")}
    batch["row_mask"] = np.ones((c["B"],), bool)
    return batch


def run_jax_case(state: dict, batch: dict, neg, masks, **step_kwargs) -> dict:
    """The port's step on JAX_CASE from the converted init `state`, with the
    JAX step's negatives and MLM masks (rows of this rank's block)."""
    m = MESM(MESMConfig(**JAX_CASE["cfg"]))
    m.load_state_dict(state)
    opt = build_optimizer(m, JAX_CASE["lr"], JAX_CASE["wd"])
    step = make_train_step(m, CriterionConfig(**JAX_CASE["criterion"]), encode, opt,
                           JAX_CASE["clip"], SEED, **step_kwargs)
    with torch.enable_grad():
        out = step(batch, 0, neg_idx_rows=neg, masked_words_loc=masks)
    return {k: float(v) for k, v in out.items()}
