"""Builders: config -> vocab / loaders / model / text encoder / criterion /
optimizer.

Parity targets: mesm_tpu/runner.py:41-176, 266-455 and the reference
runner.py (build_vocab :25, build_dataloader :44, build_model :255,
build_criterion :309, build_optimizer :348).
"""
from __future__ import annotations

import math
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .data import Loader, Vocabulary, build_dataset
from .data.collate import BatchSpec, make_collate
from .data.datasets import VAL_SPLITS
from .data.sampler import GroupAwareBatcher, RowBudgetBatcher
from .losses import CriterionConfig
from .models.mesm import MESM, MESMConfig
from .models.text_encoder import (
    CLIPTextEncoder,
    GloVeTextEncoder,
    build_glove_embedding_matrix,
    clip_encode_text,
    glove_encode_text,
    post_process_precomputed_text,
)
from .parallel.step import build_optimizer as build_adamw


def build_vocab(opt) -> Vocabulary:
    """Words from GloVe_tokenized_count.txt (reference runner.py:25-34)."""
    words = set()
    with open(os.path.join(opt.ann_path, "GloVe_tokenized_count.txt")) as f:
        for line in f:
            words.add(line.split(" ")[0])
    return Vocabulary(words)


def build_vocab_from_pkl(opt) -> Dict:
    with open(os.path.join(opt.ann_path, "glove.pkl"), "rb") as f:
        return pickle.load(f)


def get_vocab(opt):
    if opt.tokenizer_type == "GloVeSimple":
        return build_vocab(opt)
    if opt.tokenizer_type == "GloVeNLTK":
        return build_vocab_from_pkl(opt) if opt.load_vocab_pkl else build_vocab(opt)
    return None


def _auto_row_capacity(dataset, batch_size: int) -> int:
    rows = [len(e["video_id"]) for e in dataset.merged_data]
    mean_rows = sum(rows) / max(len(rows), 1)
    cap = int(math.ceil(batch_size * mean_rows))
    return max(cap, max(rows), 2)


def make_batch_spec(opt, dataset, for_eval: bool) -> BatchSpec:
    """The fixed batch geometry of mesm_tpu/runner.py:82-134. The row
    capacity B matters for values, not only for speed: the scrambled T2V
    pair mask reads row (b*H + h) % B. It is rounded up to a multiple of
    --n_devices (0 = one device, the port's single card). The JAX package's
    default rounds to every visible device, so `--n_devices N` scores a
    checkpoint as an N-device JAX run does
    (tests/test_torch_n_devices.py)."""
    group_cap = opt.group_capacity or min(
        dataset.max_group_size(),
        opt.max_gather_size if opt.max_gather_size > 0 else dataset.max_group_size(),
    )
    multi = opt.dataset_name == "qvhighlights"
    row_cap = opt.row_capacity or _auto_row_capacity(
        dataset, opt.eval_batch_size if for_eval else opt.batch_size
    )
    n_dev = max(int(getattr(opt, "n_devices", 0) or 0), 1)
    row_cap = ((row_cap + n_dev - 1) // n_dev) * n_dev
    # per-video batches: at eval unique videos are projected once, rows
    # gathered after the wide input projection; in training each video is
    # staged once and its rows are gathered on the device
    ded_cap = 0
    if not multi and getattr(opt, "dedup_video", "on") != "off":
        rows = [len(e["video_id"]) for e in dataset.merged_data]
        avg = sum(rows) / max(len(rows), 1)
        if avg >= 1.5:
            # a training batch holds at most row_cap entries, one row each at least
            ded_cap = min(row_cap, int(math.ceil(row_cap / avg * 1.3))) if for_eval else row_cap
    buckets: tuple = ()
    n_buckets = getattr(opt, "eval_len_buckets", 1) or 1
    if for_eval and n_buckets > 1:
        # quantiles of the estimated video lengths, rounded up to multiples
        # of 8, the last bucket the hard cap
        ests = sorted(dataset.estimated_length(i) for i in range(len(dataset)))
        edges = set()
        for j in range(1, n_buckets):
            q = ests[min(int(len(ests) * j / n_buckets), len(ests) - 1)]
            edges.add(min(-8 * (-q // 8), opt.max_video_l))
        edges.add(opt.max_video_l)
        buckets = tuple(e for e in sorted(edges) if e > 0)
    return BatchSpec(
        row_capacity=row_cap,
        max_video_l=opt.max_video_l,
        group_capacity=group_cap,
        multi_clip=multi,
        max_windows=opt.max_windows,
        ss_video_l=(group_cap * opt.max_video_l) if (multi and opt.rec_ss) else 0,
        contra_pairs=2 if multi else max(opt.contra_samples, 1),
        recfw=opt.rec_fw,
        with_targets=not (multi and dataset.split == "test"),
        video_buckets=buckets,
        video_groups_cap=ded_cap,
        video_groups_exact=not for_eval,
    )


def build_train_loader(opt, vocab=None):
    """The train loader (the train half of mesm_tpu/runner.py:137-151):
    shuffled row-budget batches, group-aware (no two chunks of one video in
    a batch) when max_gather_size > 0; batches with one video group are
    dropped, since the negatives come from other groups."""
    ds = build_dataset(opt, "train", recfw=opt.rec_fw, vocab=vocab)
    spec = make_batch_spec(opt, ds, for_eval=False)
    batcher_cls = GroupAwareBatcher if opt.max_gather_size > 0 else RowBudgetBatcher
    batcher = batcher_cls(ds, spec.row_capacity, shuffle=True, seed=opt.seed)
    loader = Loader(
        ds, batcher, make_collate(spec), num_workers=min(opt.num_workers, 4),
        mode=getattr(opt, "loader_mode", "thread"),
    )
    return loader, spec


def build_loaders(opt, vocab=None):
    """Eval loaders and batch specs, one per eval split (the val half of
    mesm_tpu/runner.py:137-170)."""
    val_loaders, val_specs = {}, {}
    for split in VAL_SPLITS[opt.dataset_name]:
        ds = build_dataset(opt, split, recfw=False, vocab=vocab)
        spec = make_batch_spec(opt, ds, for_eval=True)
        batcher = RowBudgetBatcher(
            ds, spec.row_capacity, shuffle=False, drop_single_group=False,
            max_entries=spec.video_groups_cap,
        )
        batcher.sort_by_length = len(spec.video_buckets) > 1
        val_loaders[split] = Loader(
            ds, batcher, make_collate(spec), num_workers=min(opt.num_workers, 4),
            mode=getattr(opt, "loader_mode", "thread"),
        )
        val_specs[split] = spec
    return val_loaders, val_specs


def load_glove_vectors(path: str) -> Dict[str, np.ndarray]:
    vectors = {}
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            word = " ".join(parts[:-300])
            vectors[word] = np.asarray(parts[-300:], dtype=np.float32)
    return vectors


def convert_clip_torch_weights(state_dict) -> Tuple[Dict[str, torch.Tensor], dict]:
    """An upstream CLIP text state dict (fp16 or fp32) -> (the port's tower
    state dict in float32, arch). The architecture is inferred from the
    shapes, as mesm_tpu/runner.py:178 and the reference (runner.py:167-187)
    do: heads = width // 64. Keys the tower does not have are left out."""
    arch = dict(
        embed_dim=state_dict["text_projection"].shape[1],
        context_length=state_dict["positional_embedding"].shape[0],
        vocab_size=state_dict["token_embedding.weight"].shape[0],
        width=state_dict["ln_final.weight"].shape[0],
    )
    arch["heads"] = max(arch["width"] // 64, 1)
    arch["layers"] = len(
        {k.split(".")[2] for k in state_dict if k.startswith("transformer.resblocks")}
    )
    with torch.device("meta"):
        keys = CLIPTextEncoder(**arch).state_dict().keys()
    return {k: torch.as_tensor(state_dict[k]).detach().float() for k in keys}, arch


def build_clip_text_encoder(path: str, device="cpu") -> CLIPTextEncoder:
    """The frozen CLIP tower of an upstream `clip_text_encoder.pth`
    (mesm_tpu/runner.py:235): float32 parameters on `device`, eval mode, no
    gradients."""
    state_dict = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    state_dict = dict(state_dict)
    for key in ("input_resolution", "context_length", "vocab_size"):
        state_dict.pop(key, None)
    weights, arch = convert_clip_torch_weights(state_dict)
    with torch.device("meta"):
        clip = CLIPTextEncoder(**arch)
    clip.load_state_dict(weights, strict=True, assign=True)
    return clip.to(device).eval().requires_grad_(False)


def build_text_encoder(opt, vocab=None, device="cpu", compute_dtype=torch.float32):
    """encode(batch) -> (words_feat, words_mask, sentence_feat) on `device`,
    batch fields as tensors. Cached features in the batch (see
    cache_text_features) are returned as they are: the encoders are frozen,
    so per-query encodings are run constants. The CLIP tower runs in
    `compute_dtype` and returns float32 features."""
    normalize_txt = opt.normalize_txt

    def cached(batch):
        if "cached_words_feat" in batch:
            return batch["cached_words_feat"], batch["cached_words_mask"], batch["cached_sentence_feat"]
        return None

    if opt.tokenizer_type == "CLIP":
        clip = build_clip_text_encoder(opt.text_model_path, device)

        @torch.no_grad()
        def encode(batch):
            hit = cached(batch)
            if hit is not None:
                return hit
            ids = batch["words_id"]
            wf, sf, _, mask = clip_encode_text(clip, ids, ids != 0, opt.max_words_l,
                                               normalize_txt, compute_dtype)
            return wf, mask, sf

        return encode

    if opt.tokenizer_type == "GloVeSimple" or (
        opt.tokenizer_type == "GloVeNLTK" and not opt.load_vocab_pkl
    ):
        vectors = load_glove_vectors(opt.text_model_path)
        table = build_glove_embedding_matrix(vocab.itow, vectors, seed=opt.seed)
        glove = GloVeTextEncoder(len(vocab), table.shape[1])
        glove.embedding.weight.data.copy_(torch.from_numpy(table))
        glove = glove.to(device).eval()

        @torch.no_grad()
        def encode(batch):
            hit = cached(batch)
            if hit is not None:
                return hit
            ids = batch["words_id"]
            mask = ids != 0
            wf, sf = glove_encode_text(glove, ids, mask, normalize_txt)
            return wf, mask, sf

        return encode

    @torch.no_grad()
    def encode(batch):  # GloVeNLTK + load_vocab_pkl: precomputed 300-d features
        hit = cached(batch)
        if hit is not None:
            return hit
        return post_process_precomputed_text(batch["words_id"].float(), normalize_txt)

    return encode


def cache_text_features(dataset, encode_text, device="cpu", chunk: int = 256):
    """Precompute the frozen-text encodings of every sentence of the dataset
    and attach them to the merged entries (consumed by collate and encode)."""
    entries = dataset.merged_data
    flat_ids, owners = [], []
    for ei, e in enumerate(entries):
        for si, wid in enumerate(e["words_id"]):
            flat_ids.append(np.asarray(wid[0] if wid.ndim > 1 else wid))
            owners.append((ei, si))
    if not flat_ids:
        return dataset
    ids = np.stack(flat_ids)
    feats, masks, sents = [], [], []
    for start in range(0, len(ids), chunk):
        part = torch.from_numpy(ids[start : start + chunk]).to(device)
        wf, m, sf = encode_text({"words_id": part})
        feats.append(wf.float().cpu().numpy())
        masks.append(m.cpu().numpy())
        sents.append(sf.float().cpu().numpy())
    wf, m, sf = np.concatenate(feats), np.concatenate(masks), np.concatenate(sents)
    for row, (ei, si) in enumerate(owners):
        e = entries[ei]
        e.setdefault("cached_words_feat", [None] * len(e["words_id"]))
        e.setdefault("cached_words_mask", [None] * len(e["words_id"]))
        e.setdefault("cached_sentence_feat", [None] * len(e["words_id"]))
        e["cached_words_feat"][si] = wf[row]
        e["cached_words_mask"][si] = m[row]
        e["cached_sentence_feat"][si] = sf[row]
    return dataset


def build_model_config(opt) -> MESMConfig:
    num_classes = opt.vocab_size + 3 if opt.tokenizer_type == "CLIP" else opt.vocab_size + 1
    return MESMConfig(
        hidden_dim=opt.hidden_dim,
        v_feat_dim=opt.v_feat_dim,
        t_feat_dim=opt.t_feat_dim,
        nheads=opt.nheads,
        dim_feedforward=opt.dim_feedforward,
        num_recfw_layers=opt.num_recfw_layers,
        t2v_layers=opt.t2v_layers,
        enc_layers=opt.enc_layers,
        dec_layers=opt.dec_layers,
        num_recss_layers=opt.num_recss_layers,
        num_queries=opt.num_queries,
        dropout=opt.dropout,
        input_dropout=opt.input_dropout,
        n_input_proj=opt.n_input_proj,
        use_txt_pos=opt.use_txt_pos,
        max_words_l=opt.max_words_l,
        max_video_l=opt.max_video_l,
        rec_fw=opt.rec_fw,
        rec_ss=opt.rec_ss,
        share_mlp=opt.share_MLP,
        aux_loss=opt.aux_loss,
        num_classes=num_classes,
    )


def build_model(opt) -> MESM:
    return MESM(build_model_config(opt))


def compute_dtype_from_opt(opt) -> torch.dtype:
    return torch.bfloat16 if getattr(opt, "compute_dtype", "float32") == "bfloat16" else torch.float32


def device_from_opt(opt) -> torch.device:
    """The device the run asks for (--device, default cuda). Asking for cuda
    on a host without a GPU raises: the port never moves to the CPU on its
    own."""
    name = getattr(opt, "device", "cuda") or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but no CUDA device is available")
    return torch.device(name)


def eval_coalesce_from_opt(opt, n_batches: Optional[int], device) -> int:
    """Batches per eval call (--eval_coalesce; -1 = auto), the port of
    mesm_tpu/runner.py:461-488. Auto is 32 on a CUDA device, where one CUDA
    graph replay then covers 32 batches, and 1 on the CPU. With the epoch's
    batch count known, K is capped at the batches per length bucket,
    n_batches // eval_len_buckets, so that padding the last group of each
    bucket does not dominate."""
    k = int(getattr(opt, "eval_coalesce", 1) or 1)
    if k == -1:
        k = 32 if torch.device(device).type == "cuda" else 1
    if n_batches is not None and k > 1:
        buckets = max(1, int(getattr(opt, "eval_len_buckets", 1) or 1))
        k = min(k, max(1, n_batches // buckets))
    return max(1, k)


def build_criterion_config(opt) -> CriterionConfig:
    return CriterionConfig(
        span_coef=opt.loss_span_coef,
        giou_coef=opt.loss_giou_coef,
        label_coef=opt.loss_label_coef,
        saliency_coef=opt.loss_saliency_coef,
        recfw_coef=opt.loss_recfw_coef,
        recss_coef=opt.loss_recss_coef,
        cost_span=opt.set_cost_span,
        cost_giou=opt.set_cost_giou,
        cost_class=opt.set_cost_class,
        eos_coef=opt.eos_coef,
        rank_coef=opt.rank_coef,
        use_triplet=opt.use_triplet,
        saliency_margin=opt.saliency_margin,
        multi_clip=opt.dataset_name == "qvhighlights",
        iou_gamma=opt.iou_gamma,
        recss_tau=opt.recss_tau,
        rec_fw=opt.rec_fw,
        rec_ss=opt.rec_ss,
        aux_loss=opt.aux_loss,
        dec_layers=opt.dec_layers,
    )


def build_optimizer(opt, model):
    """AdamW + global-norm clip (reference runner.py:348-352 + train.py:70-72);
    the clip is applied by the train step (parallel/step.py apply_update)."""
    return build_adamw(model, lr=opt.lr, weight_decay=opt.weight_decay)


def step_lr(base_lr: float, epoch: int, lr_drop: int, gamma: float) -> float:
    """torch StepLR: lr * gamma^(epoch // lr_drop)."""
    return base_lr * (gamma ** (epoch // lr_drop))
