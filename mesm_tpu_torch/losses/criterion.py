"""Set-prediction criterion: span / gIoU / label / saliency / rec_ss / rec_fw
losses and their aux copies.

Parity target: mesm_tpu/losses/criterion.py:41-307 (and the reference
model/criterion.py). Every loss is a function of (outputs, batch) with a
static config; batches are padded to a fixed row capacity with `row_mask`
marking the real rows, and every reduction is a masked mean over real rows,
which gives the reference's unpadded means. The reference's quirks are kept:
the weighted CE divides by the element count, the rank-contrastive loop over
thresholds 1..11 averages over the whole batch, the +1e-6 inside the InfoNCE
log-denominators, label smoothing 0.1 over the MLM classes.

Both regimes are ported: single-target (one moment per row, matched by the
cost argmin) and multi-clip (QVHighlights: up to max_windows moments per
row, `tgt_mask` marking the real ones, matched by the Hungarian solver;
mesm_tpu/losses/criterion.py:87-99, 172-178, 228-250, 265-277).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.masking import l2_normalize
from ..ops.matcher import hungarian_match, single_target_match
from ..ops.span import generalized_temporal_iou, pairwise_generalized_temporal_iou, span_cxw_to_xx


@dataclass(frozen=True)
class CriterionConfig:
    span_coef: float = 10.0
    giou_coef: float = 1.0
    label_coef: float = 4.0
    saliency_coef: float = 1.0
    recfw_coef: float = 0.0
    recss_coef: float = 0.0
    cost_span: float = 10.0
    cost_giou: float = 1.0
    cost_class: float = 4.0
    eos_coef: float = 0.1
    rank_coef: float = 12.0
    use_triplet: bool = False
    saliency_margin: float = 0.2
    multi_clip: bool = False
    iou_gamma: float = 0.9
    recss_tau: float = 0.5
    rec_fw: bool = True
    rec_ss: bool = True
    aux_loss: bool = True
    dec_layers: int = 2


def _row_mask(batch, like: torch.Tensor) -> torch.Tensor:
    rm = batch.get("row_mask")
    if rm is None:
        return torch.ones(like.shape[0], dtype=torch.float32, device=like.device)
    return rm.float()


def _span_losses_single(pred_spans, src_idx, tgt_span, tgt_moment, rm):
    """One target per sample. pred_spans (B, nq, 2), src_idx (B,), rm (B,)."""
    src = torch.take_along_dim(pred_spans, src_idx[:, None, None], dim=1)[:, 0]
    n = rm.sum().clamp(min=1.0)
    loss_span = ((src - tgt_span).abs().sum(-1) * rm).sum() / (n * 2.0)
    giou = pairwise_generalized_temporal_iou(span_cxw_to_xx(src), tgt_moment)
    loss_giou = ((1.0 - giou) * rm).sum() / n
    return loss_span, loss_giou


def _span_losses_multi(pred_spans, src_idx, tgt_spans, tgt_moments, tgt_mask, rm):
    """Several targets per sample, matched queries src_idx (B, T)."""
    src = torch.take_along_dim(pred_spans, src_idx[..., None], dim=1)  # (B, T, 2)
    tm = tgt_mask.bool()
    m = tm.float() * rm[:, None]
    n = m.sum().clamp(min=1.0)
    loss_span = ((src - tgt_spans).abs().sum(-1) * m).sum() / (n * 2.0)
    # padded targets are (0, 0): a benign span keeps a degenerate prediction
    # from a 0/0 gIoU that would poison the masked sum
    safe = torch.where(tm[..., None], tgt_moments, torch.tensor([0.0, 1.0], device=tgt_moments.device))
    giou = pairwise_generalized_temporal_iou(span_cxw_to_xx(src), safe)
    loss_giou = ((1.0 - giou) * m).sum() / n
    return loss_span, loss_giou


def _label_loss(pred_logits, src_idx, tgt_mask, eos_coef, rm):
    """2-class CE with background weight eos_coef; foreground is class 0.
    src_idx (B,) for one target, (B, T) with tgt_mask for several."""
    B, nq, _ = pred_logits.shape
    if src_idx.ndim == 1:
        fg = F.one_hot(src_idx, nq).float()
    else:
        oh = F.one_hot(src_idx, nq).float()  # (B, T, nq)
        fg = (oh * tgt_mask.float()[..., None]).sum(1).clamp(max=1.0)
    logp = torch.log_softmax(pred_logits, dim=-1)
    nll = -(fg * logp[..., 0] + (1.0 - fg) * logp[..., 1])
    w = fg + (1.0 - fg) * eos_coef
    n = rm.sum().clamp(min=1.0) * nq
    loss = (nll * w * rm[:, None]).sum() / n
    # diagnostic: % of matched queries predicted foreground
    pred_cls = torch.argmax(pred_logits, dim=-1)
    fg_real = fg * rm[:, None]
    correct = ((pred_cls == 0).float() * fg_real).sum()
    class_error = 100.0 * (1.0 - correct / fg_real.sum().clamp(min=1.0))
    return loss, class_error


def _saliency_loss(outputs, batch, cfg: CriterionConfig, rm):
    vid_mask = batch["video_mask"].float()  # (B, L)
    n_rows = rm.sum().clamp(min=1.0)
    neg_scores = outputs["neg_saliency_scores"]
    # -log(1 - sigmoid(x)) == softplus(x)
    loss_neg_pair = ((F.softplus(neg_scores) * vid_mask).sum(1) * rm).sum() / n_rows

    scores = outputs["saliency_scores"]
    label = batch.get("saliency_label")
    if label is None:
        label = batch["clip_mask"]
    label = label.float()

    scores2 = torch.cat([scores, neg_scores], dim=1)
    label2 = torch.cat([label, torch.zeros_like(label)], dim=1) * rm[:, None]
    mask2 = torch.cat([vid_mask, vid_mask], dim=1)
    scores2 = mask2 * scores2 + (1.0 - mask2) * -1e3

    tau = 0.5
    logits_base = scores2 / tau
    logits = logits_base - logits_base.amax(dim=1, keepdim=True)
    log_prob = logits - torch.log(torch.exp(logits).sum(1, keepdim=True) + 1e-6)
    loss_rank = torch.zeros((), dtype=scores2.dtype, device=scores2.device)
    for thd in range(1, 12):
        pos_mask = (label2 >= thd).float()
        any_pos = pos_mask.sum() > 0
        row_has_pos = (pos_mask.sum(1) > 0).float()
        mean_log_prob_pos = (pos_mask * log_prob * mask2).sum(1) / (pos_mask.sum(1) + 1e-6)
        term = (-mean_log_prob_pos * row_has_pos * rm).sum() / n_rows
        loss_rank = loss_rank + torch.where(any_pos, term, torch.zeros_like(term))
    loss_rank = loss_rank / cfg.rank_coef

    loss = loss_rank + loss_neg_pair
    if cfg.use_triplet:
        pos_idx, neg_idx = batch["pos_idx"].long(), batch["neg_idx"].long()  # (B, P)
        pos_s = torch.take_along_dim(scores, pos_idx, dim=1)
        neg_s = torch.take_along_dim(scores, neg_idx, dim=1)
        P = pos_idx.shape[1]
        hinge = (cfg.saliency_margin + neg_s - pos_s).clamp(min=0)
        loss = loss + (hinge.sum(1) * rm).sum() / (n_rows * P) * 2.0
    return loss


def _rec_ss_loss(outputs, batch, cfg: CriterionConfig, rm):
    """Segment-sentence InfoNCE over the batch, positives = same-group pairs
    whose moments have gIoU >= gamma (reference criterion.py:223-274)."""
    group_id = batch["group_id"]
    if cfg.multi_clip:  # the span that covers every target of the row
        tgt_mask = batch["tgt_mask"].bool()[..., None]
        moments = batch["norm_moment"]  # (B, T, 2)
        big = 1e9
        mmin = torch.where(tgt_mask, moments, torch.full_like(moments, big)).amin(dim=(1, 2))
        mmax = torch.where(tgt_mask, moments, torch.full_like(moments, -big)).amax(dim=(1, 2))
        moment = torch.stack([mmin, mmax], dim=-1)  # (B, 2)
    else:
        moment = batch["norm_moment"]  # (B, 2)
    valid_pair = (rm[:, None] * rm[None, :]) > 0
    same_group = (group_id[:, None] == group_id[None, :]) & valid_pair
    giou = generalized_temporal_iou(moment, moment)
    pos_mask = (same_group & (giou >= cfg.iou_gamma)).float()

    clip_mask = batch["clip_mask"].float()[..., None]  # (B, L, 1)
    clip_feat = (outputs["projed_video_feat"] * clip_mask).sum(1) / clip_mask.sum(1)
    words_mask = outputs["expanded_words_mask"].float()[..., None]
    words_feat = (outputs["expanded_words_feat"] * words_mask).sum(1) / words_mask.sum(1)

    cos = l2_normalize(clip_feat) @ l2_normalize(words_feat).T / cfg.recss_tau
    # padded columns are left out of the denominator (they do not exist upstream)
    cos = torch.where(rm[None, :] > 0, cos, torch.full_like(cos, -1e3))
    logits = cos - cos.amax(dim=1, keepdim=True)
    log_prob = logits - torch.log(torch.exp(logits).sum(1, keepdim=True) + 1e-6)
    mean_log_prob_pos = (pos_mask * log_prob).sum(1) / (pos_mask.sum(1) + 1e-6)
    return (-mean_log_prob_pos * rm).sum() / rm.sum().clamp(min=1.0)


def _rec_fw_loss(outputs, batch, rm):
    """Label-smoothed masked NLL over the MLM classes, and the accuracy
    (reference criterion.py:276-306)."""
    logit = outputs["recfw_words_logit"]  # (B, Lw, C)
    label = batch["words_label"].long()  # (B, Lw)
    mask = outputs["words_mask"].float()
    n_rows = rm.sum().clamp(min=1.0)

    acc = (torch.argmax(logit, -1) == label).float()
    mean_acc = (acc * mask * rm[:, None]).sum() / (mask * rm[:, None]).sum().clamp(min=1.0)

    eps = 0.1
    logp = torch.log_softmax(logit, dim=-1)
    nll = -torch.take_along_dim(logp, label[..., None], dim=-1)[..., 0]
    smooth = -logp.sum(-1)
    nll = (1 - eps) * nll + eps / logit.shape[-1] * smooth
    nll = (nll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    return (nll * rm).sum() / n_rows, mean_acc


def compute_losses(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: CriterionConfig,
    is_training: bool = True,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (loss_dict, total). loss_dict values are unweighted, as the
    reference logs them; total is the sum of the weighted terms."""
    losses: Dict[str, torch.Tensor] = {}
    weights: Dict[str, float] = {}
    rm = _row_mask(batch, outputs["pred_logits"])

    def span_label_losses(pred_logits, pred_spans, suffix=""):
        if cfg.multi_clip:
            src_idx = hungarian_match(
                pred_logits, pred_spans, batch["norm_span"], batch["norm_moment"],
                batch["tgt_mask"], cfg.cost_span, cfg.cost_giou, cfg.cost_class,
            )
            l_span, l_giou = _span_losses_multi(
                pred_spans, src_idx, batch["norm_span"], batch["norm_moment"], batch["tgt_mask"], rm
            )
            l_label, class_err = _label_loss(pred_logits, src_idx, batch["tgt_mask"], cfg.eos_coef, rm)
        else:
            src_idx = single_target_match(
                pred_logits, pred_spans, batch["norm_span"], batch["norm_moment"],
                cfg.cost_span, cfg.cost_giou, cfg.cost_class,
            )
            l_span, l_giou = _span_losses_single(
                pred_spans, src_idx, batch["norm_span"], batch["norm_moment"], rm
            )
            l_label, class_err = _label_loss(pred_logits, src_idx, None, cfg.eos_coef, rm)
        losses["loss_span" + suffix] = l_span
        losses["loss_giou" + suffix] = l_giou
        losses["loss_label" + suffix] = l_label
        losses["class_error" + suffix] = class_err
        weights["loss_span" + suffix] = cfg.span_coef
        weights["loss_giou" + suffix] = cfg.giou_coef
        weights["loss_label" + suffix] = cfg.label_coef

    span_label_losses(outputs["pred_logits"], outputs["pred_spans"])

    losses["loss_saliency"] = _saliency_loss(outputs, batch, cfg, rm)
    weights["loss_saliency"] = cfg.saliency_coef

    if cfg.rec_ss:
        losses["loss_rec_ss"] = _rec_ss_loss(outputs, batch, cfg, rm)
        weights["loss_rec_ss"] = cfg.recss_coef

    if cfg.rec_fw and is_training and "recfw_words_logit" in outputs:
        losses["loss_rec_fw"], losses["rec_fw_acc"] = _rec_fw_loss(outputs, batch, rm)
        weights["loss_rec_fw"] = cfg.recfw_coef

    if cfg.aux_loss and "aux_pred_logits" in outputs:
        for i in range(outputs["aux_pred_logits"].shape[0]):
            span_label_losses(
                outputs["aux_pred_logits"][i], outputs["aux_pred_spans"][i], suffix=f"_{i}"
            )

    total = sum(losses[k] * w for k, w in weights.items())
    return losses, total
