"""The eval step: text encode -> MESM forward -> the predictions the host
decodes.

Parity target: mesm_tpu/parallel/step.py:233-320 (make_eval_step) at
coalesce=1 and with_loss=False: no negative pass, deterministic. PyTorch runs
eagerly, so the step is a plain function over one staged batch.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def make_eval_step(model, encode_text: Callable, compute_dtype: torch.dtype):
    """Returns eval_step(batch) -> {"scores", "pred_spans", "saliency_scores"}
    for a batch of device tensors (data/pipeline.stage_batch). Under bf16
    compute the saliency scores come back in bf16, as the JAX step ships
    them (step.py:302-309); the decode upcasts."""
    model.eval()

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "ss_video_feat_groups" in batch:
            raise NotImplementedError("multi-clip (qvhighlights) eval is not ported yet")
        words_feat, words_mask, sentence_feat = encode_text(batch)
        video_feat = batch.get("video_feat")
        video_feat_g = batch.get("video_feat_g")
        out = model(
            batch["video_mask"],
            words_feat.to(compute_dtype),
            words_mask,
            sentence_feat,
            video_feat=None if video_feat is None else video_feat.to(compute_dtype),
            video_feat_g=None if video_feat_g is None else video_feat_g.to(compute_dtype),
            video_mask_g=batch.get("video_mask_g"),
            video_slot=batch.get("video_slot"),
            ss_sent_idx=batch.get("ss_sent_idx"),
            ss_sent_mask=batch.get("ss_sent_mask"),
            ss_own_pos=batch.get("ss_own_pos"),
        )
        prob = torch.softmax(out["pred_logits"], dim=-1)
        sal = out["saliency_scores"]
        if compute_dtype == torch.bfloat16:
            sal = sal.to(torch.bfloat16)
        return {"scores": prob[..., 0], "pred_spans": out["pred_spans"], "saliency_scores": sal}

    return eval_step
