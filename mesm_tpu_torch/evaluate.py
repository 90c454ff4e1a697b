"""Inference driver + per-epoch evaluation.

    python -m mesm_tpu_torch.evaluate --config_file <eval.json> \\
        [--resume <model.ckpt>] [--device cuda|cpu] [--compute_dtype bfloat16]

Parity targets: mesm_tpu/evaluate.py:36-464 and the reference eval.py
(eval_epoch :34, compute_mr_results :52, inference :488). With
--eval_coalesce 1 one staged batch per eval step and one device-to-host copy
of its predictions; with K > 1 (auto: 32 on CUDA, capped at the batches
per length bucket; 1 on the CPU) K same-shape batches per call of the
coalesced step (parallel/step.CoalescedEvalStep: one CUDA graph replay on
the card), staged by data/pipeline.stage_superbatch, and on the card one
graph captured ahead per planned length bucket (warm_eval_step). The
post-processing and metrics run on the host. `--resume` takes the upstream
torch layout or the JAX package's mesm_tpu.v1 pickle
(convert.load_mesm_checkpoint). Inference runs without the eval loss, as
the JAX package's does (mesm_tpu/evaluate.py:439); the trainer's eval
takes it (compute_mr_results' loss meters).
"""
from __future__ import annotations

import contextlib
import gc
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
from .data.pipeline import device_feed, stage_superbatch
from .metrics import eval_submission
from .parallel.step import make_eval_step
from .postprocess import SpanPostProcessor, apply_nms
from .utils import save_json, save_jsonl
from .utils.profiling import span

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


def _host_signature(batch) -> tuple:
    return tuple(sorted((k, np.asarray(v).shape) for k, v in batch.items()))


def _copy_out(trees, device):
    """Copies of a step's outputs (dicts of tensors) in host memory, made
    before the next call of the step can overwrite them (a CUDA graph's
    static outputs): on CUDA non-blocking copies into pinned buffers, and
    the event that ends them. Returns (the copies, the event or None)."""
    pin = torch.device(device).type == "cuda"
    out = []
    with span("eval.copy_out"):
        for tree in trees:
            out.append({})
            for k, v in tree.items():
                out[-1][k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                out[-1][k].copy_(v, non_blocking=pin)
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
    return out, event


def planned_bucket_batches(loader):
    """Each planned batch's padding bucket, without building the batch
    (mesm_tpu/evaluate.py:72-111): the collate pads to the smallest
    `spec.video_buckets` entry that fits the batch's longest feature length,
    min(stored rows, max_video_l), known from shape metadata alone
    (dataset.exact_length). Returns [(bucket_Lv, idx_batch), ...] sorted by
    bucket, the first planned index batch of each bucket, or None for a
    loader without a batcher, BatchSpec or exact_length (a list of batches
    in the tests). Iterating the batcher advances its epoch as the pass's
    own iteration would."""
    batcher = getattr(loader, "batcher", None)
    spec = getattr(getattr(loader, "collate", None), "spec", None)
    ds = getattr(loader, "dataset", None)
    if batcher is None or spec is None or not hasattr(ds, "exact_length"):
        return None
    lengths = {}  # entries repeat across buckets' batches

    def elen(i):
        if i not in lengths:
            lengths[i] = ds.exact_length(i)
        return lengths[i]

    first_by_bucket = {}
    for idx_batch in batcher:
        vmax = max(1, min(max(elen(i) for i in idx_batch), spec.max_video_l))
        if spec.video_buckets:
            bucket = next(b for b in spec.video_buckets if b >= vmax)
        else:
            bucket = spec.max_video_l
        if bucket not in first_by_bucket:
            first_by_bucket[bucket] = list(idx_batch)
    return sorted(first_by_bucket.items())


def warm_eval_step(eval_step, loader, opt, device) -> int:
    """Run the coalesced eval step once on every planned batch shape before
    the pass (mesm_tpu/evaluate.py:114-205): on the card that captures one
    CUDA graph per length bucket ahead, so the timed pass only replays.
    One batch is built per planned bucket (planned_bucket_batches), or, for
    a loader without a plan, the loader is walked; each distinct shape is
    staged as the pass stages it (K copies of the batch) and run, one after
    another (capture takes one stream, so the JAX package's compile threads
    have no counterpart here). The dataset's `_visit_counts` are restored, so
    this extra pass does not shift the items' random draws. The outputs are
    discarded. Returns the number of shapes run (0 for a per-batch step)."""
    K = getattr(eval_step, "coalesce", 1)
    if K <= 1:
        return 0
    cast = R.compute_dtype_from_opt(opt) == torch.bfloat16
    ds = getattr(loader, "dataset", None)
    visits_before = dict(getattr(ds, "_visit_counts", {}) or {})
    seen, shapes = set(), []

    def keep(batch):
        sig = _host_signature(batch)
        if sig not in seen:
            seen.add(sig)
            shapes.append(batch)

    planned = planned_bucket_batches(loader)
    if planned is not None:
        for bucket, idx_batch in planned:
            batch, _meta = loader._build(idx_batch)
            got = batch["video_mask"].shape[1]
            if got != bucket:  # prediction drift: warm what was built
                logger.warning(f"predicted bucket {bucket} but collate padded to {got}; "
                               "the pass may capture one graph more")
            keep(batch)
    else:
        for batch, _meta in loader:
            keep(batch)
    if hasattr(ds, "_visit_counts"):
        ds._visit_counts = visits_before
    t0 = time.perf_counter()
    for batch in shapes:
        eval_step(stage_superbatch([batch] * K, cast, device,
                                   into=getattr(eval_step, "static_inputs", None)))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    logger.info(f"Warmed the eval step on {len(shapes)} shapes (K = {K}) in "
                f"{time.perf_counter() - t0:.3f}s")
    return len(shapes)


def _coalesced_results(eval_step, loader, opt, device, record_losses, mr_res) -> None:
    """compute_mr_results' coalesced branches (mesm_tpu/evaluate.py:
    236-322): consecutive batches of one shape signature are grouped K at a
    time into one call; a change of signature flushes the group, a short
    group is padded by repeating its last batch (the padding's outputs are
    discarded). One-deep pipeline: group N's outputs are copied out to the
    host (_copy_out) right after its call, and decoded while group N+1 runs.
    The host batches of a group are staged by stage_superbatch (on the card
    into the graph's static inputs)."""
    K = eval_step.coalesce
    cast = R.compute_dtype_from_opt(opt) == torch.bfloat16
    pend, pend_sig, inflight = [], None, []  # pend: (batch, meta)

    def drain():
        if not inflight:
            return
        preds, losses, event, group = inflight.pop()
        if event is not None:
            with span("eval.wait"):
                event.synchronize()
        with span("eval.decode"):
            for j, (batch, meta) in enumerate(group):
                record_losses({k: v[j] for k, v in losses.items()})
                _decode_batch({k: v[j].float().numpy() for k, v in preds.items()}, batch, meta,
                              opt, mr_res)

    def flush():
        nonlocal pend, pend_sig
        if not pend:
            return
        with span("eval.call"):
            items = pend + [pend[-1]] * (K - len(pend))  # padding: outputs discarded
            out = eval_step(stage_superbatch([batch for batch, _ in items], cast, device,
                                             into=getattr(eval_step, "static_inputs", None)))
            (host_preds, host_losses), event = _copy_out(
                out if isinstance(out, tuple) else (out, {}), device)
            group, pend, pend_sig = pend, [], None
            drain()  # decode the previous group while this one runs
            inflight.append((host_preds, host_losses, event, group))

    for batch, meta in loader:
        sig = _host_signature(batch)
        if pend and sig != pend_sig:
            flush()
        pend.append((batch, meta))
        pend_sig = sig
        if len(pend) == K:
            flush()
    flush()
    drain()


# young-generation collections that compute_mr_results ran at the end of a
# pass since import (or since the caller last set it to 0)
pass_collections = 0


@contextlib.contextmanager
def _collections_at_pass_end():
    """Hold off the garbage collector's automatic runs for one pass, then run
    one collection of the youngest generation at its end (span
    `eval.collect`, counted by `pass_collections`).

    A pass builds tens of thousands of containers (each row's windows and
    saliency) that live until it ends. Left to its thresholds, the collector
    moves them into the oldest generation while they live, and so runs a
    full collection of the process's heap every other pass, in the middle of
    the decode, with the card idle. Held off, the pass's objects are freed
    young by their reference counts; the collection at the end traverses
    only what the pass allocated and still holds, and frees the pass's own
    reference cycles. The collector is switched back on at every exit, an
    exception's included; where it was off on entry it stays off and
    nothing is collected."""
    global pass_collections
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
        if was_on:
            with span("eval.collect"):
                gc.collect(0)
            pass_collections += 1
    finally:
        if was_on:
            gc.enable()


def compute_mr_results(eval_step, loader, opt, device, loss_meters=None):
    """Run the eval step over a loader and decode the submission on the host.
    A step built with_loss returns (predictions, losses); each loss term then
    goes into loss_meters[term] (mesm_tpu/evaluate.py:212-235). A coalesced
    step (`eval_step.coalesce` > 1) takes K batches a call
    (_coalesced_results). The pass is the span `eval.pass`; the collector's
    automatic runs wait for its end (_collections_at_pass_end)."""
    with span("eval.pass", unit=True), _collections_at_pass_end():
        mr_res = []

        def record_losses(losses):
            if loss_meters is not None:
                for k, v in losses.items():
                    loss_meters[k].update(float(v))

        if getattr(eval_step, "coalesce", 1) > 1:
            _coalesced_results(eval_step, loader, opt, device, record_losses, mr_res)
        else:
            cast = R.compute_dtype_from_opt(opt) == torch.bfloat16
            for jb, batch, meta in device_feed(loader, device, cast):
                preds = eval_step(jb)
                if isinstance(preds, tuple):
                    preds, losses = preds
                    record_losses(losses)
                with span("eval.wait"):
                    host = _to_host(preds)
                with span("eval.decode"):
                    _decode_batch(host, batch, meta, opt, mr_res)
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
        with span("eval.postprocess"):
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

    results = {}
    steps_by_k = {}  # one step per distinct K (mesm_tpu/evaluate.py:427-450)
    for split, loader in val_loaders.items():
        k = R.eval_coalesce_from_opt(opt, len(loader), device)
        if k not in steps_by_k:
            steps_by_k[k] = make_eval_step(model, encode_text, compute_dtype, coalesce=k)
        eval_step = steps_by_k[k]
        save_name = f"{opt.dataset_name}_{split}_test_submission.jsonl"
        t0 = time.perf_counter()
        if device.type == "cuda":  # the graphs are captured ahead, one per bucket
            warm_eval_step(eval_step, loader, opt, device)
        metrics, metrics_nms = eval_epoch(
            eval_step, loader, opt, save_name, loader.dataset.data, device
        )
        logger.info(f"[{split}] eval wall time {time.perf_counter() - t0:.3f}s (K = {k})")
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
