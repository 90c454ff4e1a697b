"""Rules the port keeps: it imports no JAX and nothing of the JAX package,
its entry point runs on CUDA unless the caller asks for the CPU, and a
kernel wrapper runs its plain version only for CPU tensors and refuses what
its kernel does not take."""
from __future__ import annotations

import ast
import json
import os
from pathlib import Path

import pytest
import torch

from mesm_tpu_torch.ops import attention_batched as ab
from mesm_tpu_torch.ops import attention_packed as ap
from mesm_tpu_torch.ops import ln_dense as ld

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mesm_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    return sorted((REPO / "mesm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = [
        m for m in _imported_modules(path)
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
    ]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_inference_without_device_cpu_raises(tmp_path):
    """With no GPU, the default --device cuda raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks a host without a GPU")
    from mesm_tpu_torch.config import BaseOptions
    from mesm_tpu_torch.evaluate import inference

    from synth_root import make_charades_root

    cfg_path = make_charades_root(str(tmp_path))
    opt = BaseOptions().parse(["--config_file", cfg_path])
    eval_cfg = tmp_path / "eval.json"
    eval_cfg.write_text(json.dumps({
        "trained_result_dir": opt.result_dir, "inference_id": "nogpu",
        "inference_result_dir": str(tmp_path / "inference"),
    }))
    with pytest.raises(RuntimeError, match="cuda"):
        inference(["--config_file", str(eval_cfg)])


def test_metric_suite_leaves_no_process_running():
    """The metric suite of an eval epoch starts no helper process that
    outlives it (a worker pool's forkserver and resource tracker would)."""
    import numpy as np

    from chip_smoke import live_descendants
    from mesm_tpu_torch.metrics import eval_submission

    rng = np.random.default_rng(0)
    n = 400  # more queries than a pooled AP would have split over workers
    starts = rng.uniform(0, 20, (n, 10))
    sub = [{"qid": i, "pred_relevant_windows": [[s, s + 5.0, float(rng.random())] for s in row]}
           for i, row in enumerate(starts.tolist())]
    gt = [{"qid": i, "relevant_windows": [[a, a + 6.0]], "duration": 30.0}
          for i, a in enumerate(rng.uniform(0, 20, n).tolist())]
    before = {pid for pid, _ in live_descendants()}
    metrics = eval_submission(sub, gt)
    assert metrics["brief"]["MR-full-mAP"] is not None
    assert [p for p in live_descendants() if p[0] not in before] == []


def _ln_args(dtype=torch.float32, device="cpu", D=70, F=48, N=5):
    g = torch.Generator().manual_seed(0)
    return (
        torch.randn(N, D, generator=g).to(device=device, dtype=dtype),
        torch.ones(D, device=device), torch.zeros(D, device=device),
        torch.randn(F, D, generator=g).to(device), torch.zeros(F, device=device),
    )


def _attn_args(dtype=torch.float32, device="cpu", B=2, L=9, E=64):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(B, L, E, generator=g).to(device=device, dtype=dtype) for _ in range(3)]


def test_wrappers_run_plain_version_on_cpu_without_counting():
    before = (ld.launches, ap.launches)
    x, gamma, beta, w, b = _ln_args()
    torch.testing.assert_close(
        ld.ln_dense(x, gamma, beta, w, b, True), ld.ln_dense_reference(x, gamma, beta, w, b, True),
        rtol=0, atol=0,
    )
    q, k, v = _attn_args()
    mask = torch.ones(2, 9, dtype=torch.bool)
    torch.testing.assert_close(
        ap.attention_packed(q, k, v, 2, mask), ap.attention_packed_reference(q, k, v, 2, mask),
        rtol=0, atol=0,
    )
    assert (ld.launches, ap.launches) == before


def test_train_without_device_cpu_raises(tmp_path):
    """The train entry point too: no GPU and no --device cpu raises."""
    if torch.cuda.is_available():
        pytest.skip("this checks a host without a GPU")
    from mesm_tpu_torch.train import train

    from synth_root import make_charades_root

    with pytest.raises(RuntimeError, match="cuda"):
        train(["--config_file", make_charades_root(str(tmp_path))])


def test_new_modules_are_covered():
    """The training slice's modules are among the sources checked above."""
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    for rel in ("ops/attention_batched.py", "ops/attention_trainable.py", "ops/matcher.py",
                "losses/criterion.py", "train.py", "utils/checkpoint.py", "utils/meters.py"):
        assert f"mesm_tpu_torch/{rel}" in names, rel


def test_batched_wrapper_runs_plain_version_on_cpu_and_refuses_the_rest():
    before = ab.launches
    q, k, v = _attn_args()
    mask = torch.ones(2, 9, dtype=torch.bool)
    torch.testing.assert_close(
        ab.attention_batched(q, k, v, 2, mask), ab.attention_batched_reference(q, k, v, 2, mask),
        rtol=0, atol=0,
    )
    with pytest.raises(TypeError):
        ab.attention_batched(*_attn_args(torch.bfloat16, "meta"), 2)  # the kernel is fp32
    with pytest.raises(ValueError, match="head_dim"):
        ab.attention_batched(*_attn_args(torch.float32, "meta"), 4)  # head_dim 16
    q, k, v = _attn_args(torch.float32, "meta")
    with pytest.raises(ValueError, match="shapes"):
        ab.attention_batched(q, k, v[..., :32].contiguous(), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ab.attention_batched(q, k, v, 2)
    assert ab.launches == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """Non-CPU tensors the kernels do not take raise before any launch (meta
    tensors stand in for device tensors: the checks read only dtype, shape
    and layout)."""
    before = (ld.launches, ap.launches)
    with pytest.raises(TypeError):
        ld.ln_dense(*_ln_args(torch.float16, "meta"), relu=True)
    with pytest.raises(ValueError, match="F <="):
        ld.ln_dense(*_ln_args(torch.bfloat16, "meta", F=40), relu=True)  # bf16 needs F % 16 == 0
    x, gamma, beta, w, b = _ln_args(torch.float32, "meta")
    with pytest.raises(ValueError, match="shapes"):
        ld.ln_dense(x, gamma, beta, w[:, :-1], b, relu=False)
    with pytest.raises(ValueError, match="contiguous"):
        ld.ln_dense(x.t().contiguous().t(), gamma, beta, w, b, relu=False)
    with pytest.raises(TypeError):
        ap.attention_packed(*_attn_args(torch.float32, "meta"), 2)
    with pytest.raises(ValueError, match="head_dim"):
        ap.attention_packed(*_attn_args(torch.bfloat16, "meta"), 4)  # head_dim 16
    q, k, v = _attn_args(torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="shapes"):
        ap.attention_packed(q, k, v[..., :32].contiguous(), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ap.attention_packed(q, k, v, 2)  # everything fits, but meta is not CUDA
    assert (ld.launches, ap.launches) == before
