"""The port's train entry point on the CPU: `mesm_tpu_torch.train.train`
(what `python -m mesm_tpu_torch.train` runs) on a synthetic charades root,
`--device cpu`. One epoch writes checkpoints in the upstream torch layout
that `mesm_tpu_torch.evaluate` scores; a --resume_all run after that epoch
continues the learning rate schedule and the step count."""
from __future__ import annotations

import json
import os

import pytest
import torch

from mesm_tpu_torch.convert import load_mesm_checkpoint
from mesm_tpu_torch.runner import step_lr
from mesm_tpu_torch.train import train

from synth_root import make_charades_root


def _config(root, name, **updates):
    path = os.path.join(root, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    # mIoU rather than mAP picks the best checkpoint: a random model's mAP
    # can be 0 on 8 videos, and a run that never improves writes no best
    cfg.update(stop_score="miou", exp_id=name, lr_drop=1, gamma=0.5, **updates)
    out = os.path.join(root, f"{name}.json")
    with open(out, "w") as f:
        json.dump(cfg, f)
    return out


@pytest.fixture(scope="module")
def first_epoch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_cli"))
    make_charades_root(root)
    return root, train(["--config_file", _config(root, "one", n_epoch=1), "--device", "cpu"])


def test_one_epoch_writes_checkpoints_that_evaluate_scores(first_epoch):
    root, res = first_epoch
    run_dir = res["opt"].result_dir
    for name in ("opt.json", "train.log.txt", "eval.log.txt", "model_latest.ckpt",
                 "model_test_best.ckpt"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert res["step"] > 0 and res["epoch"] == 0
    payload = torch.load(os.path.join(run_dir, "model_latest.ckpt"), weights_only=False)
    assert {"model", "optimizer", "lr_scheduler", "epoch", "opt"} <= set(payload)
    state, epoch = load_mesm_checkpoint(os.path.join(run_dir, "model_test_best.ckpt"),
                                        res["model"].cfg)
    assert epoch == 0
    for key, value in res["model"].state_dict().items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)

    from mesm_tpu_torch.evaluate import inference

    opt = res["opt"]
    eval_cfg = os.path.join(root, "eval.json")
    with open(eval_cfg, "w") as f:
        json.dump({"trained_result_dir": run_dir, "inference_id": "trained",
                   "inference_result_dir": os.path.join(root, "inference"),
                   "eval_len_buckets": 1, "ann_path": opt.ann_path, "feat_files": opt.feat_files,
                   "text_model_path": opt.text_model_path, "bpe_path": ""}, f)
    metrics, _ = inference(["--config_file", eval_cfg, "--device", "cpu"])
    assert metrics["brief"]["MR-full-miou"] is not None


def test_resume_all_continues_lr_and_step_count(first_epoch):
    root, res = first_epoch
    latest = os.path.join(res["opt"].result_dir, "model_latest.ckpt")
    resumed = train(["--config_file", _config(root, "resumed", n_epoch=2), "--device", "cpu",
                     "--resume", latest, "--resume_all"])
    assert resumed["epoch"] == 1
    # StepLR at epoch 1 with lr_drop 1 and gamma 0.5
    assert resumed["lr"] == pytest.approx(step_lr(res["opt"].lr, 1, 1, 0.5))
    assert resumed["step"] > res["step"]
    # AdamW's own count continued from the checkpoint's
    steps = {int(s["step"]) for s in resumed["optimizer"].state.values()}
    assert steps == {resumed["step"]}
    with open(resumed["opt"].train_log_filepath) as f:
        assert "[Epoch] 002" in f.read()


def test_sigterm_saves_latest_and_resumes(tmp_path):
    """SIGTERM during training finishes the step in flight, saves
    model_latest.ckpt with the last completed epoch, puts the previous
    handler back and returns; --resume_all from it trains on."""
    import glob
    import signal
    import threading
    import time

    root = str(tmp_path)
    make_charades_root(root)
    before = signal.getsignal(signal.SIGTERM)

    def watch():  # SIGTERM once the first epoch is logged, if train() holds the signal
        deadline = time.time() + 120
        while time.time() < deadline:
            for path in glob.glob(os.path.join(root, "**", "train.log.txt"), recursive=True):
                with open(path) as f:
                    if "[Epoch]" in f.read():
                        if signal.getsignal(signal.SIGTERM) is not before:
                            os.kill(os.getpid(), signal.SIGTERM)
                        return
            time.sleep(0.05)

    threading.Thread(target=watch, daemon=True).start()
    # n_epoch high enough that only the preemption ends the run
    res = train(["--config_file", _config(root, "preempt", n_epoch=50), "--device", "cpu"])
    assert signal.getsignal(signal.SIGTERM) is before
    with open(res["opt"].train_log_filepath) as f:
        assert "Preempted during epoch" in f.read()
    latest = res["opt"].ckpt_filepath.replace(".ckpt", "_latest.ckpt")
    payload = torch.load(latest, weights_only=False)
    assert -1 <= payload["epoch"] < res["epoch"] < 50
    resumed = train(["--config_file", _config(root, "after", n_epoch=payload["epoch"] + 2),
                     "--device", "cpu", "--resume", latest, "--resume_all"])
    assert resumed["epoch"] == payload["epoch"] + 1 and resumed["step"] > payload["step"]
