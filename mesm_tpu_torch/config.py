"""Config / flag system, reference-compatible.

Parity target: reference utils/config.py (BaseOptions :14-246, TestOptions
:249-259). The full flag surface and the layering are preserved:
argparse defaults -> JSON config file overwrite -> (eval only) the training
run's persisted opt.json overwrites everything except a whitelist. Side
effects match: result-dir creation, opt.json persistence, TEF dim bump
(v_feat_dim += 2 when use_tef).

Additions over the reference (all optional, defaulted to sane values):
  --row_capacity   static rows per batch (0 = auto from batch_size x mean
                   sentences-per-entry)
  --compute_dtype  float32 | bfloat16
  --n_devices      the device count the row capacity is rounded to (0 =
                   one: the port runs on one card); N scores as an N-device
                   JAX run does, since the row count enters the values
  --pallas_attention  on | off | auto: the hand-written kernel dispatch
                   (mesm_tpu_torch/kernels)
  --device         cuda | cpu: where the model runs. cuda is the default and
                   raises when no GPU is present; cpu is for tests.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

from .utils.io import dict_to_markdown, load_json, mkdirp, save_json


class BaseOptions:
    saved_option_filename = "opt.json"
    ckpt_filename = "model.ckpt"
    tensorboard_log_dir = "tensorboard_log"
    train_log_filename = "train.log.txt"
    eval_log_filename = "eval.log.txt"

    def __init__(self):
        self.parser: Optional[argparse.ArgumentParser] = None
        self.initialized = False
        self.opt = None

    def initialize(self):
        self.initialized = True
        p = argparse.ArgumentParser()
        p.add_argument("--config_file", type=str, default=None)

        # dataset
        p.add_argument("--dataset_name", type=str,
                       choices=["charades", "charades-cg", "charades-cd", "qvhighlights", "tacos"])
        p.add_argument("--ann_path", type=str)
        p.add_argument("--feat_files", type=str, nargs="+")
        p.add_argument("--use_tef", default=False, action="store_true")
        p.add_argument("--clip_len", type=float, default=1)
        p.add_argument("--max_words_l", type=int, default=32)
        p.add_argument("--max_video_l", type=int, default=75)
        p.add_argument("--tokenizer_type", type=str, default="CLIP",
                       choices=["CLIP", "GloVeSimple", "GloVeNLTK"])
        p.add_argument("--load_vocab_pkl", default=False, action="store_true")
        p.add_argument("--bpe_path", type=str, default="data/bpe_simple_vocab_16e6.txt.gz")
        p.add_argument("--normalize_video", action="store_true")
        p.add_argument("--normalize_txt", action="store_true")
        p.add_argument("--contra_samples", type=int, default=2)
        p.add_argument("--batch_size", type=int, default=12)
        p.add_argument("--eval_batch_size", type=int, default=-1)
        p.add_argument("--num_workers", type=int, default=8)
        p.add_argument("--pin_memory", action="store_true")
        p.add_argument("--vocab_size", type=int, default=1111)
        p.add_argument("--max_windows", type=int, default=5)
        p.add_argument("--max_gather_size", type=int, default=-1)

        # model
        p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
        p.add_argument("--text_model_path", type=str, default="data/clip_text_encoder.pth")
        p.add_argument("--share_MLP", default=False, action="store_true")
        p.add_argument("--hidden_dim", type=int, default=256)
        p.add_argument("--dropout", type=float, default=0.1)
        p.add_argument("--nheads", type=int, default=8)
        p.add_argument("--dim_feedforward", type=int, default=1024)
        p.add_argument("--num_recfw_layers", type=int, default=2)
        p.add_argument("--t2v_layers", type=int, default=2)
        p.add_argument("--enc_layers", type=int, default=2)
        p.add_argument("--dec_layers", type=int, default=2)
        p.add_argument("--pre_norm", action="store_true")
        p.add_argument("--position_embedding", default="sine", type=str, choices=("sine", "learned"))
        p.add_argument("--input_dropout", default=0.5, type=float)
        p.add_argument("--v_feat_dim", type=int)
        p.add_argument("--t_feat_dim", type=int)
        p.add_argument("--num_queries", default=10, type=int)
        p.add_argument("--use_txt_pos", action="store_true")
        p.add_argument("--n_input_proj", type=int, default=2)
        p.add_argument("--rec_fw", default=False, action="store_true")
        p.add_argument("--rec_ss", default=False, action="store_true")
        p.add_argument("--num_recss_layers", type=int, default=4)

        # matcher
        p.add_argument("--set_cost_span", default=10, type=float)
        p.add_argument("--set_cost_giou", default=1, type=float)
        p.add_argument("--set_cost_class", default=4, type=float)

        # criterion
        p.add_argument("--span_loss_type", type=str, default="l1", choices=["l1", "ce"])
        p.add_argument("--aux_loss", default=False, action="store_true")
        p.add_argument("--rank_coef", type=float, default=12.0)
        p.add_argument("--use_triplet", default=False, action="store_true")
        p.add_argument("--saliency_margin", type=float, default=0.2)
        p.add_argument("--loss_span_coef", default=10, type=float)
        p.add_argument("--loss_giou_coef", default=1, type=float)
        p.add_argument("--loss_label_coef", default=4, type=float)
        p.add_argument("--loss_saliency_coef", default=1, type=float)
        p.add_argument("--eos_coef", default=0.1, type=float)
        p.add_argument("--loss_recfw_coef", default=0, type=float)
        p.add_argument("--loss_recss_coef", default=0, type=float)
        p.add_argument("--iou_gamma", default=0.9, type=float)
        p.add_argument("--recss_tau", default=0.5, type=float)

        # train
        p.add_argument("--exp_id", type=str, default=None)
        p.add_argument("--seed", type=int, default=2019)
        p.add_argument("--lr", type=float, default=1e-4)
        p.add_argument("--lr_drop", type=int, default=400)
        p.add_argument("--gamma", type=float, default=0.1)
        p.add_argument("--weight_decay", type=float, default=1e-4)
        p.add_argument("--n_epoch", type=int, default=200)
        p.add_argument("--grad_clip", type=float, default=0.1)
        p.add_argument("--resume", type=str, default=None)
        p.add_argument("--resume_all", action="store_true")
        p.add_argument("--start_epoch", type=int, default=None)
        p.add_argument("--eval_untrained", action="store_true")
        p.add_argument("--max_es_cnt", type=int, default=200)
        p.add_argument("--save_interval", type=int, default=50)
        p.add_argument("--result_root", type=str, default="./results")
        p.add_argument("--ctx_mode", type=str, default=None)
        p.add_argument("--stop_score", type=str, default="mAP")

        # eval
        p.add_argument("--eval_epoch_interval", type=int, default=1)
        p.add_argument("--sort_results", action="store_true")
        p.add_argument("--nms_thd", type=float, default=-1)
        p.add_argument("--max_ts_val", type=float, default=150)
        p.add_argument("--max_before_nms", type=int, default=10)
        p.add_argument("--max_after_nms", type=int, default=10)

        # static-shape, dtype and dispatch knobs
        p.add_argument("--row_capacity", type=int, default=0,
                       help="static rows per batch; 0 = auto")
        p.add_argument("--compute_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"])
        p.add_argument("--grad_accum", type=int, default=1,
                       help="gradient accumulation: split each train batch "
                            "into k lax.scan'd microbatches, average the k "
                            "fp32 gradients, apply ONE optimizer update "
                            "(activation memory bounded by one microbatch); "
                            "batch rows must divide by k. 1 = off")
        p.add_argument("--n_devices", type=int, default=0,
                       help="round the row capacity up to a multiple of N "
                            "devices; 0 = one (the port's single card). Pass "
                            "the device count of a JAX run to score as it does "
                            "(its default rounds to every visible device)")
        p.add_argument("--pallas_attention", type=str, default="auto",
                       choices=["auto", "on", "off"])
        p.add_argument("--rng_impl", type=str, default="rbg",
                       choices=["rbg", "threefry"],
                       help="PRNG family of the training run that wrote "
                            "the checkpoint (kept so its opt.json parses)")
        p.add_argument("--group_capacity", type=int, default=0,
                       help="SS-MESM group gather capacity; 0 = auto")
        p.add_argument("--cache_text", type=str, default="on", choices=["on", "off"],
                       help="precompute frozen-text encodings once per run "
                            "(value-identical; removes the text tower from "
                            "every step)")
        p.add_argument("--eval_len_buckets", type=int, default=4,
                       help="number of video-length buckets at eval; each "
                            "batch pads to the smallest fitting bucket "
                            "(one jit specialization per bucket). 1 = off")
        p.add_argument("--loader_mode", type=str, default="thread",
                       choices=["thread", "process"],
                       help="loader workers: 'thread' (GIL-releasing HDF5/"
                            "numpy; default) or 'process' (fork pool, for "
                            "multi-core hosts where collate's Python work "
                            "bottlenecks — like the reference's DataLoader "
                            "workers)")
        p.add_argument("--eval_coalesce", type=int, default=-1,
                       help="eval batches per call: K same-shape batches "
                            "run through one coalesced step, on the card one "
                            "CUDA graph replay (value-identical; amortizes "
                            "the per-launch host cost). -1 = auto: 32 on "
                            "CUDA, 1 on the CPU, capped at the batches per "
                            "length bucket; 1 = one batch per call")
        p.add_argument("--scan_layers", type=str, default="off",
                       choices=["on", "off"],
                       help="fold homogeneous layer stacks into nn.scan "
                            "bodies (stacked params): smaller traced graph / "
                            "faster compiles, same math. Checkpoint layout "
                            "differs; must match between train and eval")
        p.add_argument("--dedup_video", type=str, default="on",
                       choices=["on", "off"],
                       help="at eval, project each unique video once and "
                            "gather rows after the input projection; in "
                            "training, stage each video of a batch once and "
                            "gather its rows on the device "
                            "(value-identical; auto-disabled when videos "
                            "average < 1.5 sentences)")
        self.parser = p

    def load_config(self, opt):
        known = set(vars(opt).keys())
        for key, value in load_json(opt.config_file).items():
            # tolerate reference-config stray keys (e.g. the span_los_type typo)
            setattr(opt, key, value)
        return known

    def display_save(self, opt):
        print(dict_to_markdown(vars(opt), max_str_len=120))
        save_json(vars(opt), os.path.join(opt.result_dir, self.saved_option_filename),
                  save_pretty=True)

    def parse(self, args=None):
        if not self.initialized:
            self.initialize()
        opt = self.parser.parse_args(args)
        if opt.config_file:
            self.load_config(opt)

        if isinstance(self, TestOptions):
            opt.is_inference = True
            saved = load_json(os.path.join(opt.trained_result_dir, self.saved_option_filename))
            keep = {"config_file", "num_workers", "nms_thd", "device", "resume_all",
                    "sort_results", "max_ts_val", "ann_path", "is_inference",
                    "feat_files", "bpe_path", "text_model_path",
                    "trained_result_dir", "inference_id", "inference_result_dir",
                    "n_devices", "compute_dtype", "pallas_attention", "cache_text",
                    "eval_len_buckets", "dedup_video", "row_capacity",
                    "eval_coalesce", "loader_mode"}
            for key, value in saved.items():
                if key not in keep:
                    setattr(opt, key, value)
            if opt.trained_result_dir is None:
                assert opt.resume is not None
                opt.trained_result_dir = os.path.dirname(opt.resume)
            else:
                split_name = "val" if opt.dataset_name == "qvhighlights" else "test"
                opt.resume = os.path.join(
                    opt.trained_result_dir, f"model_{split_name}_best.ckpt"
                )
            if opt.inference_result_dir is not None:
                opt.result_root = opt.inference_result_dir
            save_name = "-".join([opt.dataset_name, "eval", opt.inference_id,
                                  time.strftime("%Y_%m_%d_%H_%M_%S")])
            opt.result_dir = os.path.join(opt.result_root, save_name)
            mkdirp(opt.result_dir)
        else:
            opt.is_inference = False
            if opt.exp_id is None:
                raise ValueError("--exp_id is required for a training run")
            if opt.eval_batch_size == -1:
                opt.eval_batch_size = opt.batch_size
            ctx = opt.ctx_mode
            parts = [opt.dataset_name] + ([ctx] if ctx else []) + [opt.exp_id,
                     time.strftime("%Y_%m_%d_%H_%M_%S")]
            opt.result_dir = os.path.join(opt.result_root, "-".join(parts))
            mkdirp(opt.result_dir)
            # snapshot the model/criterion sources into the run dir, like the
            # reference (utils/config.py:221-223) — aids run forensics
            import shutil

            pkg = os.path.dirname(os.path.abspath(__file__))
            for rel in ("models/mesm.py", "models/detr.py", "losses/criterion.py"):
                src = os.path.join(pkg, rel)
                if os.path.exists(src):
                    shutil.copyfile(
                        src, os.path.join(opt.result_dir, os.path.basename(rel))
                    )

        self.display_save(opt)

        opt.ckpt_filepath = os.path.join(opt.result_dir, self.ckpt_filename)
        opt.train_log_filepath = os.path.join(opt.result_dir, self.train_log_filename)
        opt.eval_log_filepath = os.path.join(opt.result_dir, self.eval_log_filename)
        opt.tensorboard_log_dir = os.path.join(opt.result_dir, self.tensorboard_log_dir)

        if opt.use_tef:
            opt.v_feat_dim += 2

        self.opt = opt
        return opt


class TestOptions(BaseOptions):
    """Evaluation options: reloads the training run's opt.json
    (reference utils/config.py:249-259)."""

    __test__ = False  # not a pytest class

    def initialize(self):
        super().initialize()
        self.parser.add_argument("--inference_id", type=str, default="")
        self.parser.add_argument("--inference_result_dir", type=str, default=None)
        self.parser.add_argument("--trained_result_dir", type=str, default=None)
