"""The cases of tests/test_torch_distributed.py, shared by the test process
(the single-process references) and its gloo workers
(tests/torch_dist_worker.py): a small charades model from a torch seed,
dropout 0, one batch of 8 rows (the last one padding) with its injected
negatives and MLM masks, and the port's train step."""
from __future__ import annotations

import numpy as np
import torch

from mesm_tpu_torch.losses import CriterionConfig
from mesm_tpu_torch.models.mesm import MESM, MESMConfig
from mesm_tpu_torch.parallel.step import build_optimizer, make_train_step

from synth import make_batch, sample_neg_rows

CFG = dict(hidden_dim=32, v_feat_dim=70, t_feat_dim=20, nheads=4, dim_feedforward=64,
           num_recfw_layers=1, t2v_layers=2, enc_layers=2, dec_layers=2, num_recss_layers=1,
           num_queries=5, max_words_l=8, max_video_l=64, num_classes=30, dropout=0.0,
           input_dropout=0.0, share_mlp=False)
B, K = 8, 2
CRITERION = CriterionConfig(recfw_coef=0.1, recss_coef=0.1, use_triplet=True, rank_coef=1.0)
LR, WD, CLIP, SEED = 2e-4, 1e-4, 0.1, 5
STEPS = 2


def host_batch() -> dict:
    batch = make_batch(np.random.default_rng(0), B=B, Lv=CFG["max_video_l"], Dv=CFG["v_feat_dim"],
                       Lw=CFG["max_words_l"], Dt=CFG["t_feat_dim"], G=3, n_groups=4)
    for key in ("video_feat_g", "video_mask_g", "video_slot"):  # eval-only fields
        batch.pop(key, None)
    batch["row_mask"] = np.arange(B) < B - 1
    batch["words_label"] = batch["words_label"] % CFG["num_classes"]
    return batch


def injected(k: int):
    """Per microbatch of B/k rows: its negatives (rows of the microbatch) and
    MLM masks, as numpy arrays of a leading axis k."""
    batch = host_batch()
    rng = np.random.default_rng(1)
    n = B // k
    neg = np.stack([sample_neg_rows(rng, batch["group_id"][i * n:(i + 1) * n]) for i in range(k)])
    words = batch["words_mask"].reshape(k, n, -1)
    masks = words & (rng.random(words.shape) < 0.4)
    return neg.astype(np.int64), masks


def model() -> MESM:
    torch.manual_seed(0)
    return MESM(MESMConfig(**CFG))


def encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


def run_steps(m, batch: dict, k: int, inject: bool, rows: slice = None, **step_kwargs):
    """STEPS train steps of `m` on `batch` (tensors): the metrics of each
    step and the parameters after the last. `rows` (this rank's rows of
    each microbatch) cuts the injected draws as the batch was cut."""
    opt = build_optimizer(m, LR, WD)
    step = make_train_step(m, CRITERION, encode, opt, CLIP, SEED, grad_accum=k, **step_kwargs)
    metrics = []
    for i in range(STEPS):
        kwargs = {}
        if inject and i == 0:
            neg, masks = injected(k)
            if rows is not None:
                neg, masks = neg[:, rows], masks[:, rows]
            neg, masks = torch.from_numpy(neg), torch.from_numpy(masks)
            kwargs = ({"neg_idx_rows": neg[0], "masked_words_loc": masks[0]} if k == 1
                      else {"neg_idx_rows": neg, "masked_words_loc": masks})
        with torch.enable_grad():
            out = step(batch, i, **kwargs)
        metrics.append({key: float(v) for key, v in out.items()})
    return metrics
