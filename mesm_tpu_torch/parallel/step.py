"""The train step (forward, matcher, losses, backward, global-norm clip,
AdamW) and the eval step (text encode -> MESM forward -> the predictions the
host decodes).

Parity target: mesm_tpu/parallel/step.py: the train step of :33-187 at
grad_accum = 1, and make_eval_step (:233-320) at coalesce=1 and
with_loss=False (no negative pass, deterministic). PyTorch runs eagerly, so
each step is a plain function over one staged batch. Multi-clip
(QVHighlights) batches pass their rows' SS video (`ss_video_feat`,
`ss_video_mask`, expanded by data/pipeline.stage_batch) to the model, as
_model_kwargs does (:81-104).

Optimizer parity: optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
b1=0.9, b2=0.999, eps=1e-8, weight_decay)) (reference runner.py:348-352,
train.py:70-72). The clip is optax's: gradients scale by
max_norm / max(norm, max_norm), not by torch's max_norm / (norm + 1e-6);
optax decays every parameter, so a parameter without a gradient gets a zero
one and is decayed too. The StepLR schedule is set per epoch by the
training loop (set_learning_rate).

Random draws: the JAX step folds the step count into its key; here each
step seeds its own draws from (seed, step) (`step_draws`): the negatives and
the MLM masks from explicit torch.Generators on the batch's device, and the
dropout masks from the default generators (torch.manual_seed), since
F.dropout takes no generator. A resumed run therefore repeats the draws of
the steps it repeats. The draws are not JAX's: the parity tests inject the
negatives and masks into both.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses import CriterionConfig, compute_losses


def build_optimizer(model: torch.nn.Module, lr: float, weight_decay: float = 1e-4):
    """AdamW with optax.adamw's constants over every parameter. torch's
    decoupled decay p *= 1 - lr * wd before the Adam step is optax's
    p -= lr * (adam + wd * p)."""
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def current_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over every tensor."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def apply_update(optimizer, grad_clip: float) -> torch.Tensor:
    """optax.clip_by_global_norm(grad_clip) on the gradients, then the
    optimizer step. Returns the global norm before the clip."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    if grad_clip > 0:
        factor = grad_clip / torch.clamp(norm, min=grad_clip)
        for g in grads:
            g.mul_(factor.to(g.dtype))
    optimizer.step()
    return norm


def sample_out_of_group(generator: torch.Generator, group_id: torch.Tensor,
                        row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """For each row, another valid row of a different group, uniformly
    (mesm_tpu/parallel/step.py:57-73; reference sample_outclass_neg,
    utils/data_utils.py:113-124): the argmax of Gumbel noise over the
    candidates. A row with no candidate takes (i + 1) % B."""
    B = group_id.shape[0]
    cand = group_id[None, :] != group_id[:, None]
    if row_mask is not None:
        cand = cand & (row_mask[None, :] > 0)
    u = torch.rand((B, B), generator=generator, device=group_id.device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    idx = torch.argmax(torch.where(cand, g, torch.full_like(g, -float("inf"))), dim=1)
    fallback = (torch.arange(B, device=group_id.device) + 1) % B
    return torch.where(cand.any(dim=1), idx, fallback)


def step_draws(seed: int, step: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """The random draws of train step `step`: (negatives generator, MLM
    mask generator) on `device`, and the default generators reseeded for
    the step's dropout masks. All three follow from (seed, step) alone."""
    base = ((int(seed) * 1_000_003 + int(step)) * 3) % (2**62)
    neg = torch.Generator(device=device).manual_seed(base)
    mask = torch.Generator(device=device).manual_seed(base + 1)
    torch.manual_seed(base + 2)
    return neg, mask


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def make_micro_grads(model, ccfg: CriterionConfig, encode_text: Callable,
                     compute_dtype: torch.dtype = torch.float32):
    """micro_grads(batch, neg_generator, mask_generator, neg_idx_rows=None,
    masked_words_loc=None) -> (total, losses): one batch forward in train
    mode, the losses, and the backward into the parameters' .grad.
    neg_idx_rows / masked_words_loc, when given, replace the draws."""

    @torch.enable_grad()  # whatever grad mode the caller is in
    def micro_grads(batch, neg_generator=None, mask_generator=None,
                    neg_idx_rows=None, masked_words_loc=None):
        model.train()
        words_feat, words_mask, sentence_feat = encode_text(batch)
        if neg_idx_rows is None:
            neg_idx_rows = sample_out_of_group(neg_generator, batch["group_id"], batch.get("row_mask"))
        out = model(
            batch["video_mask"], words_feat.to(compute_dtype), words_mask, sentence_feat,
            video_feat=_cast(batch.get("video_feat"), compute_dtype),
            ss_sent_idx=batch.get("ss_sent_idx"), ss_sent_mask=batch.get("ss_sent_mask"),
            ss_own_pos=batch.get("ss_own_pos"),
            ss_video_feat=_cast(batch.get("ss_video_feat"), compute_dtype),
            ss_video_mask=batch.get("ss_video_mask"), neg_idx_rows=neg_idx_rows,
            clip_mask=batch.get("clip_mask"), words_weight=batch.get("words_weight"),
            unknown_mask=batch.get("unknown_mask"), masked_words_loc=masked_words_loc,
            mask_generator=mask_generator,
        )
        losses, total = compute_losses(out, batch, ccfg, is_training=True)
        total.backward()
        return total, losses

    return micro_grads


def make_train_step(model, ccfg: CriterionConfig, encode_text: Callable, optimizer,
                    grad_clip: float, seed: int, compute_dtype: torch.dtype = torch.float32):
    """train_step(batch, step, neg_idx_rows=None, masked_words_loc=None) ->
    metrics (device scalars: every loss term, loss_overall, grad_norm).
    One optimizer update per batch (grad_accum = 1)."""
    micro_grads = make_micro_grads(model, ccfg, encode_text, compute_dtype)

    def train_step(batch: Dict[str, torch.Tensor], step: int, neg_idx_rows=None,
                   masked_words_loc=None) -> Dict[str, torch.Tensor]:
        neg_gen, mask_gen = step_draws(seed, step, batch["video_mask"].device)
        optimizer.zero_grad(set_to_none=True)
        total, losses = micro_grads(batch, neg_gen, mask_gen, neg_idx_rows, masked_words_loc)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_overall"] = total.detach()
        metrics["grad_norm"] = apply_update(optimizer, grad_clip)
        return metrics

    return train_step


def make_eval_step(model, encode_text: Callable, compute_dtype: torch.dtype):
    """Returns eval_step(batch) -> {"scores", "pred_spans", "saliency_scores"}
    for a batch of device tensors (data/pipeline.stage_batch). Under bf16
    compute the saliency scores come back in bf16, as the JAX step ships
    them (step.py:302-309); the decode upcasts."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        words_feat, words_mask, sentence_feat = encode_text(batch)
        out = model(
            batch["video_mask"],
            words_feat.to(compute_dtype),
            words_mask,
            sentence_feat,
            video_feat=_cast(batch.get("video_feat"), compute_dtype),
            video_feat_g=_cast(batch.get("video_feat_g"), compute_dtype),
            video_mask_g=batch.get("video_mask_g"),
            video_slot=batch.get("video_slot"),
            ss_sent_idx=batch.get("ss_sent_idx"),
            ss_sent_mask=batch.get("ss_sent_mask"),
            ss_own_pos=batch.get("ss_own_pos"),
            ss_video_feat=_cast(batch.get("ss_video_feat"), compute_dtype),
            ss_video_mask=batch.get("ss_video_mask"),
        )
        prob = torch.softmax(out["pred_logits"], dim=-1)
        sal = out["saliency_scores"]
        if compute_dtype == torch.bfloat16:
            sal = sal.to(torch.bfloat16)
        return {"scores": prob[..., 0], "pred_spans": out["pred_spans"], "saliency_scores": sal}

    return eval_step
