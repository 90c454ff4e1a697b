"""Inference driver + per-epoch evaluation.

    python -m mesm_tpu_torch.evaluate --config_file <eval.json> \\
        [--resume <model.ckpt>] [--device cuda|cpu] [--compute_dtype bfloat16]

Parity targets: mesm_tpu/evaluate.py:36-464 and the reference eval.py
(eval_epoch :34, compute_mr_results :52, inference :488). One staged batch
per eval step, one device-to-host copy of the predictions per batch; the
post-processing and metrics run on the host. `--resume` takes the upstream
torch layout or the JAX package's mesm_tpu.v1 pickle
(convert.load_mesm_checkpoint). Inference runs without the eval loss, as
the JAX package's does (mesm_tpu/evaluate.py:439); the trainer's eval
takes it (compute_mr_results' loss meters).
"""
from __future__ import annotations

import logging
import os
import pprint
import time

import numpy as np
import torch

from . import kernels
from . import runner as R
from .config import TestOptions
from .convert import load_mesm_checkpoint
from .data.pipeline import device_feed
from .metrics import eval_submission
from .parallel.step import make_eval_step
from .postprocess import SpanPostProcessor, apply_nms
from .utils import save_json, save_jsonl

logger = logging.getLogger(__name__)
logging.basicConfig(
    format="%(asctime)s.%(msecs)03d:%(levelname)s:%(name)s - %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
    level=logging.INFO,
)


def _decode_batch(preds, batch, meta, opt, mr_res):
    """Decode one host-side prediction dict into submission rows."""
    n = meta["n_rows"]
    scores = np.asarray(preds["scores"], dtype=np.float32)[:n]  # (n, nq)
    cxw = np.asarray(preds["pred_spans"], dtype=np.float32)[:n]  # (n, nq, 2)
    spans = np.stack(
        [cxw[..., 0] - 0.5 * cxw[..., 1], cxw[..., 0] + 0.5 * cxw[..., 1]], axis=-1
    )
    sal = np.asarray(preds["saliency_scores"], dtype=np.float32)[:n]
    valid_len = np.asarray(batch["video_mask"])[:n].sum(1)
    for i in range(n):
        dur = meta["duration"][i]
        ranked = np.concatenate([spans[i] * dur, scores[i][:, None]], axis=1).tolist()
        if opt.sort_results:
            ranked = sorted(ranked, key=lambda r: r[2], reverse=True)
        ranked = [[float(f"{v:.4f}") for v in row] for row in ranked]
        mr_res.append(
            dict(
                qid=meta["qid"][i],
                query=meta["sentence"][i],
                vid=meta["video_id"][i],
                pred_relevant_windows=ranked,
                pred_saliency_scores=sal[i, : int(valid_len[i])].tolist(),
            )
        )


def _to_host(preds):
    return {k: v.float().cpu().numpy() for k, v in preds.items()}


def compute_mr_results(eval_step, loader, opt, device, loss_meters=None):
    """Run the eval step over a loader and decode the submission on the host.
    A step built with_loss returns (predictions, losses); each loss term then
    goes into loss_meters[term] (mesm_tpu/evaluate.py:212-235)."""
    mr_res = []
    cast = R.compute_dtype_from_opt(opt) == torch.bfloat16
    for jb, batch, meta in device_feed(loader, device, cast):
        preds = eval_step(jb)
        if isinstance(preds, tuple):
            preds, losses = preds
            if loss_meters is not None:
                for k, v in losses.items():
                    loss_meters[k].update(float(v))
        _decode_batch(_to_host(preds), batch, meta, opt, mr_res)
    post = SpanPostProcessor(
        clip_length=opt.clip_len,
        min_ts_val=0,
        max_ts_val=opt.max_ts_val,
        min_w_l=2,
        max_w_l=150,
        move_window_method="left",
        process_func_names=(
            ("clip_ts", "round_multiple") if opt.clip_len != -1 else ("clip_ts",)
        ),
    )
    return post(mr_res)


def eval_epoch(eval_step, loader, opt, save_submission_filename: str, gt_data, device,
               loss_meters=None):
    """Writes the submission and its metrics under opt.result_dir; returns
    (metrics_no_nms, metrics_nms). With a step built with_loss the loss
    terms are averaged into `loss_meters` (name -> AverageMeter)."""
    submission = compute_mr_results(eval_step, loader, opt, device, loss_meters)
    if not opt.sort_results:
        save_submission_filename = save_submission_filename.replace(".jsonl", "_unsorted.jsonl")
    submission_path = os.path.join(opt.result_dir, save_submission_filename)
    save_jsonl(submission, submission_path)
    metrics = eval_submission(submission, gt_data, dataset_name=opt.dataset_name)
    metrics_path = submission_path.replace(".jsonl", "_metrics.json")
    save_json(metrics, metrics_path, save_pretty=True)

    metrics_nms = None
    if opt.nms_thd != -1:
        logger.info(f"[MR] nms with thd {opt.nms_thd}")
        sub_nms = apply_nms(
            [dict(e) for e in submission], opt.nms_thd, opt.max_before_nms, opt.max_after_nms
        )
        nms_path = submission_path.replace(".jsonl", f"_nms_thd_{opt.nms_thd}.jsonl")
        save_jsonl(sub_nms, nms_path)
        metrics_nms = eval_submission(sub_nms, gt_data, dataset_name=opt.dataset_name)
        save_json(metrics_nms, nms_path.replace(".jsonl", "_metrics.json"), save_pretty=True)
    return metrics, metrics_nms


def inference(args=None):
    logger.info("Inference Mode")
    opt = TestOptions().parse(args)
    device = R.device_from_opt(opt)
    with kernels.pallas_scope(opt.pallas_attention):
        return _inference_body(opt, device)


def _inference_body(opt, device):
    compute_dtype = R.compute_dtype_from_opt(opt)
    vocab = R.get_vocab(opt)
    val_loaders, _ = R.build_loaders(opt, vocab)
    assert len(val_loaders) >= 1

    model = R.build_model(opt)
    logger.info(f"Load checkpoint from {opt.resume}")
    state, epoch = load_mesm_checkpoint(opt.resume, model.cfg)
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    logger.info(f"Loaded model saved at epoch {epoch}")

    encode_text = R.build_text_encoder(opt, vocab, device, compute_dtype)
    if getattr(opt, "cache_text", "on") == "on" and not (
        opt.tokenizer_type == "GloVeNLTK" and opt.load_vocab_pkl
    ):
        logger.info("Precomputing frozen-text encodings (one-time)...")
        for vl in val_loaders.values():
            R.cache_text_features(vl.dataset, encode_text, device)

    eval_step = make_eval_step(model, encode_text, compute_dtype)
    results = {}
    for split, loader in val_loaders.items():
        save_name = f"{opt.dataset_name}_{split}_test_submission.jsonl"
        t0 = time.time()
        metrics, metrics_nms = eval_epoch(
            eval_step, loader, opt, save_name, loader.dataset.data, device
        )
        logger.info(f"[{split}] eval wall time {time.time() - t0:.1f}s")
        logger.info(
            "[{}] metrics_no_nms {}".format(split, pprint.pformat(metrics["brief"], indent=4))
        )
        if metrics_nms is not None:
            logger.info(
                "[{}] metrics_nms {}".format(split, pprint.pformat(metrics_nms["brief"], indent=4))
            )
        results[split] = (metrics, metrics_nms)
    if len(results) == 1:
        return next(iter(results.values()))
    return results


if __name__ == "__main__":
    inference()
