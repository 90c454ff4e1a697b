"""Training entry point and loop.

    python -m mesm_tpu_torch.train --config_file <train.json> [--device cuda|cpu] \\
        [--resume <model_latest.ckpt> --resume_all]

Parity target: mesm_tpu/train.py:54-427 without mesh or sharding (one
card), and the reference train.py (set_seed :32, train_epoch :42, train
:99): the epoch loop with the StepLR learning rate set per epoch, eval over
the val splits every `eval_epoch_interval` epochs through the port's
evaluate, the best checkpoint per split keyed on MR-full-{stop_score}, early
stop after `max_es_cnt` evaluations without a gain, the latest and periodic
(`save_interval`) checkpoints, --resume / --resume_all, and a SIGTERM that
finishes the step in flight, saves model_latest.ckpt with the last completed
epoch and returns. Checkpoints are in the upstream torch layout
(utils/checkpoint.py), so `python -m mesm_tpu_torch.evaluate` scores them.

Every config family trains: the single-target ones (charades, TACoS) and
QVHighlights, whose multi-clip batches carry each row's SS-MESM group video
(expanded by data/pipeline.stage_batch, as mesm_tpu/train.py:102-104 does)
and are matched by the batched Hungarian solver. Runs on CUDA unless
--device cpu; cuda without a GPU raises. Left for later slices:
grad_accum > 1, bf16 training, and the eval loss the JAX trainer logs
beside the metrics.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import pprint
import random
import signal
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from . import kernels
from . import runner as R
from .config import BaseOptions
from .convert import model_state_from_checkpoint
from .data.pipeline import stage_batch
from .evaluate import eval_epoch
from .parallel.step import current_learning_rate, make_eval_step, make_train_step, set_learning_rate
from .utils import AverageMeter, count_parameters, load_checkpoint, save_checkpoint

logger = logging.getLogger(__name__)
logging.basicConfig(
    format="%(asctime)s.%(msecs)03d:%(levelname)s:%(name)s - %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
    level=logging.INFO,
)

TRAIN_LOG_FMT = "{time_str} [Epoch] {epoch:03d} [Loss] {loss_str}\n"
EVAL_LOG_FMT = "{time_str} [Epoch] {epoch:03d} [Split] {split} [Metrics] {eval_metrics_str}\n"

# set by SIGTERM: the loop finishes the step in flight, checkpoints, returns
_PREEMPT = threading.Event()


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _install_preempt_handler():
    """Install the SIGTERM -> checkpoint handler; returns a restore()
    callable that puts the previous handler back (a leaked handler would
    leave the process deaf to SIGTERM after train() returns)."""

    def _handler(signum, frame):
        logger.warning(f"received signal {signum}: finishing the step in flight, then "
                       "checkpointing model_latest.ckpt and exiting")
        _PREEMPT.set()

    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread: preemption is the caller's concern
        logger.info("not in the main thread; SIGTERM checkpointing disabled")
        return lambda: None
    return lambda: signal.signal(signal.SIGTERM, prev)


def _weight_map(opt):
    w = {
        "loss_span": opt.loss_span_coef,
        "loss_giou": opt.loss_giou_coef,
        "loss_label": opt.loss_label_coef,
        "loss_saliency": opt.loss_saliency_coef,
        "loss_rec_fw": opt.loss_recfw_coef,
        "loss_rec_ss": opt.loss_recss_coef,
    }
    if opt.aux_loss:
        for i in range(opt.dec_layers - 1):
            for k in ("loss_span", "loss_giou", "loss_label"):
                w[f"{k}_{i}"] = w[k]
    return w


def train_epoch(train_step, loader, opt, epoch_i: int, step: int, device):
    """One pass over the train loader. Returns (steps taken so far, loss
    meters of the epoch, each weighted as the reference logs it)."""
    time_meters = defaultdict(AverageMeter)
    loss_meters = defaultdict(AverageMeter)
    weight_map = _weight_map(opt)
    timer = time.time()
    for batch, _ in loader:
        time_meters["dataloading_time"].update(time.time() - timer)
        t0 = time.time()
        jb = stage_batch(batch, False, device)
        time_meters["prepare_inputs_time"].update(time.time() - t0)
        t0 = time.time()
        metrics = train_step(jb, step)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        step += 1
        time_meters["train_step_time"].update(time.time() - t0)
        for k, v in metrics.items():
            loss_meters[k].update(v * weight_map.get(k, 1.0))
        timer = time.time()
        if _PREEMPT.is_set():
            break
    with open(opt.train_log_filepath, "a") as f:
        f.write(TRAIN_LOG_FMT.format(
            time_str=time.strftime("%Y_%m_%d_%H_%M_%S"), epoch=epoch_i + 1,
            loss_str=" ".join(f"{k} {v.avg:.4f}" for k, v in loss_meters.items()),
        ))
    logger.info("Epoch time stats:")
    for name, meter in time_meters.items():
        logger.info(f"{name} ==> " + str({k: f"{getattr(meter, k):.4f}" for k in ("max", "min", "avg")}))
    return step, loss_meters


def train(args=None):
    """The entry point of `python -m mesm_tpu_torch.train`. Returns a dict:
    model, optimizer, opt, the steps taken (`step`), the last epoch run
    (`epoch`) and the learning rate of that epoch (`lr`)."""
    opt = BaseOptions().parse(args)
    device = R.device_from_opt(opt)
    set_seed(opt.seed)
    _PREEMPT.clear()
    restore_sigterm = _install_preempt_handler()
    try:
        with kernels.pallas_scope(opt.pallas_attention):
            return _train_body(opt, device)
    finally:
        restore_sigterm()


def _checkpoint(opt, name: str, model, optimizer, epoch: int, step: int) -> None:
    save_checkpoint(
        opt.ckpt_filepath.replace(".ckpt", name), model, optimizer, epoch, dict(vars(opt)),
        step, current_learning_rate(optimizer), opt.lr_drop, opt.gamma,
    )


def _train_body(opt, device):
    if R.compute_dtype_from_opt(opt) != torch.float32:
        raise NotImplementedError("bf16 training is not ported yet; train with --compute_dtype float32")
    if getattr(opt, "grad_accum", 1) != 1:
        raise NotImplementedError("grad_accum > 1 is not ported yet")
    vocab = R.get_vocab(opt)
    train_loader, _ = R.build_train_loader(opt, vocab)
    val_loaders, _ = R.build_loaders(opt, vocab)
    model = R.build_model(opt).to(device)
    count_parameters(model)
    optimizer = R.build_optimizer(opt, model)
    encode_text = R.build_text_encoder(opt, vocab, device)
    if getattr(opt, "cache_text", "on") == "on" and not (
        opt.tokenizer_type == "GloVeNLTK" and opt.load_vocab_pkl
    ):
        logger.info("Precomputing frozen-text encodings (one-time)...")
        for ds in [train_loader.dataset] + [vl.dataset for vl in val_loaders.values()]:
            R.cache_text_features(ds, encode_text, device)

    start_epoch, step = 0, 0
    if opt.resume is not None:
        logger.info(f"Load checkpoint from {opt.resume}")
        payload = load_checkpoint(opt.resume)
        model.load_state_dict(model_state_from_checkpoint(payload["model"], model.cfg), strict=True)
        if opt.resume_all and payload.get("optimizer") is not None:
            optimizer.load_state_dict(payload["optimizer"])
            start_epoch = payload["epoch"] + 1
            step = int(payload.get("step", 0))
    if opt.start_epoch is not None:
        start_epoch = opt.start_epoch
    elif opt.eval_untrained:
        start_epoch = -1
    if start_epoch > 0:
        # a resumed run shuffles, and with thread workers augments, as the
        # epochs it continues would have
        train_loader.batcher._epoch = start_epoch
        train_loader.dataset._epoch_offset = start_epoch

    train_step = make_train_step(
        model, R.build_criterion_config(opt), encode_text, optimizer, opt.grad_clip, opt.seed
    )
    eval_step = make_eval_step(model, encode_text, torch.float32)
    prev_best = {k: 0.0 for k in val_loaders}
    es_cnt = 0
    epoch_i = start_epoch
    for epoch_i in range(start_epoch, opt.n_epoch):
        if epoch_i > -1:
            set_learning_rate(optimizer, R.step_lr(opt.lr, epoch_i, opt.lr_drop, opt.gamma))
            step, _ = train_epoch(train_step, train_loader, opt, epoch_i, step, device)

        if _PREEMPT.is_set():
            # epoch_i may be incomplete: record the last completed epoch so
            # --resume_all restarts at most one epoch back
            _checkpoint(opt, "_latest.ckpt", model, optimizer, epoch_i - 1, step)
            with open(opt.train_log_filepath, "a") as f:
                f.write(f"Preempted during epoch {epoch_i}; model_latest.ckpt saved "
                        "(resume with --resume_all)\n")
            logger.info(f">>>>> Preempted during epoch {epoch_i}; latest checkpoint saved")
            break

        stop = False
        if (epoch_i + 1) % opt.eval_epoch_interval == 0:
            for key, val_loader in val_loaders.items():
                logger.info(f"Evaluating {key} split")
                fname = f"{key}_latest_{opt.dataset_name}_val_preds.jsonl"
                metrics, _ = eval_epoch(eval_step, val_loader, opt, fname,
                                        val_loader.dataset.data, device)
                with open(opt.eval_log_filepath, "a") as f:
                    f.write(EVAL_LOG_FMT.format(
                        time_str=time.strftime("%Y_%m_%d_%H_%M_%S"), epoch=epoch_i, split=key,
                        eval_metrics_str=json.dumps(metrics),
                    ))
                logger.info("{} metrics_no_nms {}".format(key, pprint.pformat(metrics["brief"], indent=4)))
                stop_score = metrics["brief"].get(f"MR-full-{opt.stop_score}") or 0.0
                if stop_score > prev_best[key]:
                    es_cnt = 0
                    prev_best[key] = stop_score
                    _checkpoint(opt, f"_{key}_best.ckpt", model, optimizer, epoch_i, step)
                    for src in glob.glob(os.path.join(opt.result_dir, f"{key}_latest_*")):
                        src_dir, src_name = os.path.split(src)
                        os.replace(src, os.path.join(src_dir, src_name.replace("latest", "best", 1)))
                    logger.info("The checkpoint file has been updated.")
                else:
                    es_cnt += 1
                    if opt.max_es_cnt != -1 and es_cnt > opt.max_es_cnt:
                        with open(opt.train_log_filepath, "a") as f:
                            f.write(f"Early Stop at epoch {epoch_i}")
                        logger.info(f">>>>> Early stop at epoch {epoch_i} {prev_best[key]}")
                        stop = True
                        break
                _checkpoint(opt, "_latest.ckpt", model, optimizer, epoch_i, step)
        if stop:
            break
        if (epoch_i + 1) % opt.save_interval == 0 or (epoch_i + 1) % opt.lr_drop == 0:
            _checkpoint(opt, f"_e{epoch_i:04d}.ckpt", model, optimizer, epoch_i, step)
    return {"model": model, "optimizer": optimizer, "opt": opt, "step": step, "epoch": epoch_i,
            "lr": current_learning_rate(optimizer)}


if __name__ == "__main__":
    train()
