"""The plain reference of MESM's training step: the set criterion for one
target a row (lntzm/MESM model/criterion.py, model/matcher.py), the
step's random draws, the global-norm clip and AdamW.

Losses: the matched query of each row is the argmin of cost_span * L1(cxw)
+ cost_giou * (-gIoU) + cost_class * (-P(fg)); span L1 and 1 - gIoU on it,
a two-class cross entropy with background weight eos_coef; the saliency
loss (a contrastive rank loss over thresholds 1..11 on the positive and
negative pass, the negative pass's softplus, and the triplet hinge where
use_triplet); SS-MESM's InfoNCE over the batch (positives: rows of one
video whose moments have gIoU >= iou_gamma); the label-smoothed MLM loss;
each term also on the decoder's earlier layer where aux_loss. Padded rows
(row_mask False) count nowhere.

The draws are those the configuration states for step `step` of a run with
seed `seed`: the negatives are, for each row, the argmax over rows of
another video of Gumbel noise from (B, B) uniforms, and the MLM mask the top
of log(weight) + Gumbel from (B, Lw) uniforms, each from a torch.Generator
on the device seeded by ((seed * 1000003 + step) * 3) mod 2**62 (the
negatives) and that plus 1 (the mask).

The clip scales every gradient by clip / max(norm, clip) over the global
norm; AdamW (betas 0.9 / 0.999, eps 1e-8) decays every parameter by
lr * weight_decay before its Adam step.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .model import l2n


def cxw_to_xx(s):
    return torch.stack([s[..., 0] - 0.5 * s[..., 1], s[..., 0] + 0.5 * s[..., 1]], -1)


def giou_cross(a, b):
    """gIoU between every span of a (..., N, 2) and of b (..., M, 2)."""
    la, lb = a[..., 1] - a[..., 0], b[..., 1] - b[..., 0]
    left = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    right = torch.minimum(a[..., :, None, 1], b[..., None, :, 1])
    inter = (right - left).clamp(min=0)
    union = la[..., :, None] + lb[..., None, :] - inter
    enc = (torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
           - torch.minimum(a[..., :, None, 0], b[..., None, :, 0])).clamp(min=0)
    return inter / union - (enc - union) / enc


def draws(seed: int, step: int, device):
    """(negatives generator, MLM generator) of train step `step`."""
    base = ((int(seed) * 1_000_003 + int(step)) * 3) % (2**62)
    return (torch.Generator(device=device).manual_seed(base),
            torch.Generator(device=device).manual_seed(base + 1))


def negative_rows(u, group_id, row_mask):
    """For each row a row of another video: the argmax of Gumbel(u) over
    them; (i + 1) % B where there is none."""
    B = group_id.shape[0]
    cand = (group_id[None, :] != group_id[:, None]) & row_mask[None, :].bool()
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    idx = torch.argmax(g.masked_fill(~cand, -float("inf")), dim=1)
    return torch.where(cand.any(1), idx, (torch.arange(B, device=u.device) + 1) % B)


def losses(out, b, cc: dict):
    """Every term of the criterion (unweighted) and the weighted total."""
    rm = b["row_mask"].float()
    n = rm.sum().clamp(min=1.0)
    terms, weights = {}, {}
    tspan, tmom = b["norm_span"], b["norm_moment"]

    def span_label(logits, spans, sfx):
        with torch.no_grad():
            pfg = torch.softmax(logits, -1)[..., 0]
            cost = (cc["set_cost_span"] * (spans - tspan[:, None]).abs().sum(-1)
                    - cc["set_cost_giou"] * giou_cross(cxw_to_xx(spans), tmom[:, None])[..., 0]
                    - cc["set_cost_class"] * pfg)
            idx = torch.argmin(cost, -1)
        src = spans[torch.arange(spans.shape[0], device=spans.device), idx]
        terms["loss_span" + sfx] = ((src - tspan).abs().sum(-1) * rm).sum() / (n * 2.0)
        g = giou_cross(cxw_to_xx(src)[:, None], tmom[:, None])[:, 0, 0]
        terms["loss_giou" + sfx] = ((1.0 - g) * rm).sum() / n
        nq = logits.shape[1]
        fg = F.one_hot(idx, nq).float()
        logp = torch.log_softmax(logits, -1)
        nll = -(fg * logp[..., 0] + (1.0 - fg) * logp[..., 1])
        w = fg + (1.0 - fg) * cc["eos_coef"]
        terms["loss_label" + sfx] = (nll * w * rm[:, None]).sum() / (n * nq)
        for k, c in (("loss_span", "loss_span_coef"), ("loss_giou", "loss_giou_coef"),
                     ("loss_label", "loss_label_coef")):
            weights[k + sfx] = cc[c]

    span_label(out["pred_logits"], out["pred_spans"], "")
    # saliency
    vm = b["video_mask"].float()
    neg_s, s = out["neg_saliency_scores"], out["saliency_scores"]
    loss_neg = ((F.softplus(neg_s) * vm).sum(1) * rm).sum() / n
    label = b["clip_mask"].float()
    s2 = torch.cat([s, neg_s], 1)
    l2 = torch.cat([label, torch.zeros_like(label)], 1) * rm[:, None]
    m2 = torch.cat([vm, vm], 1)
    s2 = m2 * s2 + (1.0 - m2) * -1e3
    lg = s2 / 0.5
    lg = lg - lg.amax(1, keepdim=True)
    logp = lg - torch.log(torch.exp(lg).sum(1, keepdim=True) + 1e-6)
    rank = torch.zeros((), device=s.device)
    for thd in range(1, 12):
        pos = (l2 >= thd).float()
        has = (pos.sum(1) > 0).float()
        mean = (pos * logp * m2).sum(1) / (pos.sum(1) + 1e-6)
        term = (-mean * has * rm).sum() / n
        rank = rank + torch.where(pos.sum() > 0, term, torch.zeros_like(term))
    sal = rank / cc["rank_coef"] + loss_neg
    if cc["use_triplet"]:
        pi, ni = b["pos_idx"].long(), b["neg_idx"].long()
        hinge = (cc["saliency_margin"] + torch.take_along_dim(s, ni, 1)
                 - torch.take_along_dim(s, pi, 1)).clamp(min=0)
        sal = sal + (hinge.sum(1) * rm).sum() / (n * pi.shape[1]) * 2.0
    terms["loss_saliency"], weights["loss_saliency"] = sal, cc["loss_saliency_coef"]
    # SS-MESM
    gid = b["group_id"]
    pair_ok = (rm[:, None] * rm[None, :]) > 0
    same = (gid[:, None] == gid[None, :]) & pair_ok
    pos = (same & (giou_cross(tmom, tmom) >= cc["iou_gamma"])).float()
    cm = b["clip_mask"].float()[..., None]
    clip = (out["projed_video_feat"] * cm).sum(1) / cm.sum(1)
    wm = out["expanded_words_mask"].float()[..., None]
    words = (out["expanded_words_feat"] * wm).sum(1) / wm.sum(1)
    cos = l2n(clip) @ l2n(words).T / cc["recss_tau"]
    cos = torch.where(rm[None, :] > 0, cos, torch.full_like(cos, -1e3))
    lg = cos - cos.amax(1, keepdim=True)
    logp = lg - torch.log(torch.exp(lg).sum(1, keepdim=True) + 1e-6)
    mean = (pos * logp).sum(1) / (pos.sum(1) + 1e-6)
    terms["loss_rec_ss"], weights["loss_rec_ss"] = (-mean * rm).sum() / n, cc["loss_recss_coef"]
    # MLM
    logit, lab = out["recfw_words_logit"], b["words_label"].long()
    mask = out["words_mask"].float()
    logp = torch.log_softmax(logit, -1)
    nll = -torch.take_along_dim(logp, lab[..., None], -1)[..., 0]
    nll = 0.9 * nll + 0.1 / logit.shape[-1] * -logp.sum(-1)
    nll = (nll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    terms["loss_rec_fw"], weights["loss_rec_fw"] = (nll * rm).sum() / n, cc["loss_recfw_coef"]
    if "aux_pred_logits" in out:
        for i in range(out["aux_pred_logits"].shape[0]):
            span_label(out["aux_pred_logits"][i], out["aux_pred_spans"][i], f"_{i}")
    total = sum(terms[k] * w for k, w in weights.items())
    return terms, total


def train_steps(model, batches: List[Dict[str, torch.Tensor]], cc: dict, seed: int,
                lr: float, weight_decay: float, grad_clip: float, first_step: int = 0,
                state=None, adam_steps: int = 0):
    """Steps first_step, first_step + 1, ... of training on `batches`, one
    each. Returns per step the total loss and, of the first step, the
    clipped gradient of every parameter by name. `state` maps a
    parameter's name to AdamW's (first, second) moments, updated in place
    (zeros where missing); `adam_steps` is the count of updates they hold."""
    model.train()
    params = dict(model.named_parameters())
    state = {} if state is None else state
    for k, p in params.items():
        if k not in state:
            state[k] = (torch.zeros_like(p), torch.zeros_like(p))
    b1, b2, eps = 0.9, 0.999, 1e-8
    totals, first_grads = [], None
    for i, b in enumerate(batches):
        step, t = first_step + i, adam_steps + i + 1
        dev = b["video_mask"].device
        g_neg, g_mask = draws(seed, step, dev)
        B = b["group_id"].shape[0]
        neg = negative_rows(torch.rand((B, B), generator=g_neg, device=dev), b["group_id"],
                            b["row_mask"])
        u = torch.rand(b["cached_words_mask"].shape, generator=g_mask, device=dev)
        for p in params.values():
            p.grad = None
        out = model(b, neg_rows=neg, mlm_u=u)
        _, total = losses(out, b, cc)
        total.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        factor = grad_clip / torch.clamp(norm, min=grad_clip)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * factor
                m, v = state[k]
                p.mul_(1.0 - lr * weight_decay)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
            if first_grads is None:
                first_grads = {k: grads[k] * factor for k in params}
        totals.append(float(total.detach()))
    return totals, first_grads
