"""Training entry point and loop.

    python -m mesm_tpu_torch.train --config_file <train.json> [--device cuda|cpu] \\
        [--compute_dtype bfloat16] [--grad_accum K] [--resume <ckpt> --resume_all]

Parity target: mesm_tpu/train.py:54-427 without mesh or sharding (one
card), and the reference train.py (set_seed :32, train_epoch :42, train
:99): the epoch loop with the StepLR learning rate set per epoch, eval over
the val splits every `eval_epoch_interval` epochs through the port's
evaluate with the criterion's losses beside the metrics (the eval log's
[Loss] field), the best checkpoint per split keyed on MR-full-{stop_score},
early stop after `max_es_cnt` evaluations without a gain, the latest and
periodic (`save_interval`) checkpoints, --resume / --resume_all (from the
port's own checkpoints or the JAX package's mesm_tpu.v1 pickles, whose
optax state is mapped onto AdamW), the optional TensorBoard writer (skipped
with a warning when torch.utils.tensorboard does not import), and a SIGTERM
that finishes the step in flight, saves model_latest.ckpt with the last
completed epoch and returns. Checkpoints are in the upstream torch layout
(utils/checkpoint.py), so `python -m mesm_tpu_torch.evaluate` scores them.

Every config family trains: the single-target ones (charades, TACoS) and
QVHighlights, whose multi-clip batches carry each row's SS-MESM group video
(expanded by data/pipeline.stage_batch, as mesm_tpu/train.py:102-104 does)
and are matched by the batched Hungarian solver. Text comes from GloVe or
the CLIP tower (runner.build_text_encoder). The eval takes K batches a
call (--eval_coalesce, runner.eval_coalesce_from_opt): one coalesced step
per distinct K, whose CUDA graphs are captured again after each epoch's
updates (parallel/step.CoalescedEvalStep). `--compute_dtype bfloat16`
trains with float32 parameters and AdamW state and bf16 activations (the
eval runs in the same dtype); `--grad_accum K` takes one update per batch
from K microbatches (parallel/step.make_train_step). Runs on CUDA unless
--device cpu; cuda without a GPU raises.

On several cards, one process each:

    torchrun --nproc_per_node N -m mesm_tpu_torch.train --config_file <train.json>

trains data-parallel as mesm_tpu/train.py:202-204 does over N devices: the
processes join with NCCL (gloo only for --device cpu; parallel/multihost.py),
every process builds the same loaders and model from the seed, keeps its
rows of each batch (of each of the K microbatches with --grad_accum K) and
takes the step of parallel/step.make_train_step(data_parallel=True), whose
update is the single-process update on the whole batch. --n_devices
defaults to the world size (the row capacity is rounded to a multiple of
it). Rank 0 alone evaluates, logs and writes checkpoints; the others wait at
a barrier and follow its early-stop decision.
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
from .convert import adamw_state_from_optax, model_state_from_payload
from .data.pipeline import stage_batch
from .evaluate import eval_epoch
import torch.distributed as dist

from .parallel import multihost
from .parallel.step import current_learning_rate, make_eval_step, make_train_step, set_learning_rate
from .utils import AverageMeter, count_parameters, dict_to_markdown, load_checkpoint, save_checkpoint
from .utils.checkpoint import V1_FORMAT

logger = logging.getLogger(__name__)
logging.basicConfig(
    format="%(asctime)s.%(msecs)03d:%(levelname)s:%(name)s - %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
    level=logging.INFO,
)

TRAIN_LOG_FMT = "{time_str} [Epoch] {epoch:03d} [Loss] {loss_str}\n"
EVAL_LOG_FMT = (
    "{time_str} [Epoch] {epoch:03d} [Split] {split} [Loss] {loss_str} "
    "[Metrics] {eval_metrics_str}\n"
)

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


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _any_rank(flag: bool, device) -> bool:
    """Whether `flag` is set on any rank (the flag itself in one process)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def train_epoch(train_step, loader, opt, epoch_i: int, step: int, device):
    """One pass over the train loader. Returns (steps taken so far, loss
    meters of the epoch, each weighted as the reference logs it). Under
    torch.distributed each process takes its rows of every batch
    (multihost.local_view), and a SIGTERM on any rank stops every rank after
    the same step."""
    time_meters = defaultdict(AverageMeter)
    loss_meters = defaultdict(AverageMeter)
    weight_map = _weight_map(opt)
    timer = time.time()
    for batch, _ in loader:
        time_meters["dataloading_time"].update(time.time() - timer)
        t0 = time.time()
        if dist.is_initialized():
            batch = multihost.local_view(batch, micro=getattr(opt, "grad_accum", 1))
        jb = stage_batch(batch, False, device)
        time_meters["prepare_inputs_time"].update(time.time() - t0)
        t0 = time.time()
        metrics = train_step(jb, step)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        if step == 0 and _is_rank0():  # the run's first step, before AdamW has moved anything
            logger.info("Step 1 losses " + json.dumps(metrics))
        step += 1
        time_meters["train_step_time"].update(time.time() - t0)
        for k, v in metrics.items():
            loss_meters[k].update(v * weight_map.get(k, 1.0))
        timer = time.time()
        if _any_rank(_PREEMPT.is_set(), device):
            _PREEMPT.set()
            break
    if _is_rank0():
        with open(opt.train_log_filepath, "a") as f:
            f.write(TRAIN_LOG_FMT.format(
                time_str=time.strftime("%Y_%m_%d_%H_%M_%S"), epoch=epoch_i + 1,
                loss_str=" ".join(f"{k} {v.avg:.4f}" for k, v in loss_meters.items()),
            ))
        # the same means unrounded (the log keeps the reference's 4 digits)
        logger.info(f"Epoch {epoch_i + 1} losses "
                    + json.dumps({k: v.avg for k, v in loss_meters.items()}))
    logger.info("Epoch time stats:")
    for name, meter in time_meters.items():
        logger.info(f"{name} ==> " + str({k: f"{getattr(meter, k):.4f}" for k in ("max", "min", "avg")}))
    return step, loss_meters


def _requested_device(args) -> str:
    """--device as the command line and the config file give it, read without
    parse()'s side effects (the run directory), so that the process group
    can be joined before rank 0 parses."""
    options = BaseOptions()
    options.initialize()
    opt, _ = options.parser.parse_known_args(args)
    if opt.config_file:
        options.load_config(opt)
    return getattr(opt, "device", "cuda") or "cuda"


def _parse_distributed(args):
    """Rank 0 parses (and makes the run directory); every rank takes its
    options. --n_devices defaults to the world size and must equal it."""
    box = [BaseOptions().parse(args) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    opt = box[0]
    world = dist.get_world_size()
    if not opt.n_devices:
        opt.n_devices = world
    elif opt.n_devices != world:
        raise ValueError(f"--n_devices {opt.n_devices} under a world of {world} processes")
    return opt


def train(args=None):
    """The entry point of `python -m mesm_tpu_torch.train`. Returns a dict:
    model, optimizer, opt, the steps taken (`step`), the last epoch run
    (`epoch`) and the learning rate of that epoch (`lr`). Under torchrun
    (WORLD_SIZE in the environment) the processes train data-parallel."""
    joined = not dist.is_initialized() and multihost.init_distributed(_requested_device(args))
    try:
        opt = _parse_distributed(args) if dist.is_initialized() else BaseOptions().parse(args)
        device = R.device_from_opt(opt)
        set_seed(opt.seed)
        _PREEMPT.clear()
        restore_sigterm = _install_preempt_handler()
        try:
            with kernels.pallas_scope(opt.pallas_attention):
                return _train_body(opt, device)
        finally:
            restore_sigterm()
    finally:
        if joined:
            dist.destroy_process_group()


def load_optax_state(optimizer, model, opt_state) -> int:
    """A v1 checkpoint's optax state into the port's AdamW
    (convert.adamw_state_from_optax): each parameter's moments and step on
    its device, and the learning rate. Returns the steps taken (the Adam
    count), which seed the draws of the next step."""
    states, lr = adamw_state_from_optax(opt_state, model.cfg)
    for name, p in model.named_parameters():
        st = states[name]
        optimizer.state[p] = {"step": st["step"], "exp_avg": st["exp_avg"].to(p.device),
                              "exp_avg_sq": st["exp_avg_sq"].to(p.device)}
    if lr is not None:
        set_learning_rate(optimizer, lr)
    return int(next(iter(states.values()))["step"]) if states else 0


def _checkpoint(opt, name: str, model, optimizer, epoch: int, step: int) -> None:
    if not _is_rank0():
        return
    save_checkpoint(
        opt.ckpt_filepath.replace(".ckpt", name), model, optimizer, epoch, dict(vars(opt)),
        step, current_learning_rate(optimizer), opt.lr_drop, opt.gamma,
    )


def _tensorboard_writer(opt):
    """The optional SummaryWriter of mesm_tpu/train.py:281-288: None, with a
    warning, when torch.utils.tensorboard does not import (and on ranks
    other than 0)."""
    if not _is_rank0():
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:  # tensorboard is optional
        logger.warning(f"tensorboard unavailable: {e}")
        return None
    writer = SummaryWriter(opt.tensorboard_log_dir)
    writer.add_text("hyperparameters", dict_to_markdown(vars(opt), max_str_len=None))
    return writer


def _train_body(opt, device):
    compute_dtype = R.compute_dtype_from_opt(opt)
    vocab = R.get_vocab(opt)
    train_loader, _ = R.build_train_loader(opt, vocab)
    val_loaders = R.build_loaders(opt, vocab)[0] if _is_rank0() else {}
    model = R.build_model(opt).to(device)
    count_parameters(model)
    optimizer = R.build_optimizer(opt, model)
    encode_text = R.build_text_encoder(opt, vocab, device, compute_dtype)
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
        model.load_state_dict(model_state_from_payload(payload, model.cfg), strict=True)
        if opt.resume_all and payload.get("optimizer") is not None:
            if payload.get("format") == V1_FORMAT:
                step = load_optax_state(optimizer, model, payload["optimizer"])
            else:
                optimizer.load_state_dict(payload["optimizer"])
                step = int(payload.get("step", 0))
            start_epoch = payload["epoch"] + 1
    if opt.start_epoch is not None:
        start_epoch = opt.start_epoch
    elif opt.eval_untrained:
        start_epoch = -1
    if start_epoch > 0:
        # a resumed run shuffles, and with thread workers augments, as the
        # epochs it continues would have
        train_loader.batcher._epoch = start_epoch
        train_loader.dataset._epoch_offset = start_epoch

    if dist.is_initialized():  # every rank starts from rank 0's weights
        for t in model.state_dict().values():
            dist.broadcast(t, src=0)
    ccfg = R.build_criterion_config(opt)
    train_step = make_train_step(
        model, ccfg, encode_text, optimizer, opt.grad_clip, opt.seed, compute_dtype,
        grad_accum=getattr(opt, "grad_accum", 1), data_parallel=dist.is_initialized(),
    )
    # the eval during training reports the criterion's losses too
    # (mesm_tpu/train.py:265-288, reference train.py:156 -> eval.py:101-105);
    # one step per distinct K, K capped by each loader's batches per bucket
    steps_by_k = {}

    def eval_step_for(loader):
        k = R.eval_coalesce_from_opt(opt, len(loader), device)
        if k not in steps_by_k:
            steps_by_k[k] = make_eval_step(model, encode_text, compute_dtype, ccfg,
                                           with_loss=True, seed=opt.seed, coalesce=k)
        return steps_by_k[k]

    tb_writer = _tensorboard_writer(opt)
    try:
        return _train_loop(opt, device, model, optimizer, train_step, eval_step_for, train_loader,
                           val_loaders, start_epoch, step, tb_writer)
    finally:
        if tb_writer is not None:
            tb_writer.close()


def _train_loop(opt, device, model, optimizer, train_step, eval_step_for, train_loader, val_loaders,
                start_epoch, step, tb_writer):
    prev_best = {k: 0.0 for k in val_loaders}
    es_cnt = 0
    epoch_i = start_epoch
    for epoch_i in range(start_epoch, opt.n_epoch):
        if epoch_i > -1:
            set_learning_rate(optimizer, R.step_lr(opt.lr, epoch_i, opt.lr_drop, opt.gamma))
            step, loss_meters = train_epoch(train_step, train_loader, opt, epoch_i, step, device)
            if tb_writer is not None:
                tb_writer.add_scalar("Train/lr", current_learning_rate(optimizer), epoch_i + 1)
                for k, v in loss_meters.items():
                    tb_writer.add_scalar(f"Train/{k}", v.avg, epoch_i + 1)

        if _PREEMPT.is_set():
            # epoch_i may be incomplete: record the last completed epoch so
            # --resume_all restarts at most one epoch back
            _checkpoint(opt, "_latest.ckpt", model, optimizer, epoch_i - 1, step)
            if _is_rank0():
                with open(opt.train_log_filepath, "a") as f:
                    f.write(f"Preempted during epoch {epoch_i}; model_latest.ckpt saved "
                            "(resume with --resume_all)\n")
            logger.info(f">>>>> Preempted during epoch {epoch_i}; latest checkpoint saved")
            break

        stop = False
        if (epoch_i + 1) % opt.eval_epoch_interval == 0:
            # rank 0 evaluates (the others hold no val loaders) and decides
            for key, val_loader in val_loaders.items():
                logger.info(f"Evaluating {key} split")
                fname = f"{key}_latest_{opt.dataset_name}_val_preds.jsonl"
                eval_loss_meters = defaultdict(AverageMeter)
                metrics, _ = eval_epoch(eval_step_for(val_loader), val_loader, opt, fname,
                                        val_loader.dataset.data, device, eval_loss_meters)
                weight_map = _weight_map(opt)
                eval_losses = {k: v.avg * weight_map.get(k, 1.0) for k, v in eval_loss_meters.items()}
                with open(opt.eval_log_filepath, "a") as f:
                    f.write(EVAL_LOG_FMT.format(
                        time_str=time.strftime("%Y_%m_%d_%H_%M_%S"), epoch=epoch_i, split=key,
                        loss_str=" ".join(f"{k} {v:.4f}" for k, v in eval_losses.items()),
                        eval_metrics_str=json.dumps(metrics),
                    ))
                logger.info("{} metrics_no_nms {}".format(key, pprint.pformat(metrics["brief"], indent=4)))
                if tb_writer is not None:
                    for k, v in eval_losses.items():
                        tb_writer.add_scalar(f"Eval/{k}", v, epoch_i + 1)
                    for k, v in metrics["brief"].items():
                        if v is not None:
                            tb_writer.add_scalar(f"Eval/{key}-{k}", float(v), epoch_i + 1)
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
            if dist.is_initialized():
                box = [stop]
                dist.broadcast_object_list(box, src=0)
                stop = box[0]
        if stop:
            break
        if (epoch_i + 1) % opt.save_interval == 0 or (epoch_i + 1) % opt.lr_drop == 0:
            _checkpoint(opt, f"_e{epoch_i:04d}.ckpt", model, optimizer, epoch_i, step)
    return {"model": model, "optimizer": optimizer, "opt": opt, "step": step, "epoch": epoch_i,
            "lr": current_learning_rate(optimizer)}


if __name__ == "__main__":
    train()
