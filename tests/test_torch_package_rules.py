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
from mesm_tpu_torch.ops import attention_shortkey as sk
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
                "losses/criterion.py", "train.py", "utils/checkpoint.py", "utils/meters.py",
                "ops/attention_shortkey.py", "ops/lsap.py", "models/attention.py",
                "kernels/__init__.py", "data/pipeline.py"):
        assert f"mesm_tpu_torch/{rel}" in names, rel
    sources = {p.name for p in _cuda_sources()}
    assert {"ln_dense.cu", "attention_packed.cu", "attention_batched.cu",
            "attention_shortkey.cu"} <= sources


# the headers a kernel source may include: the CUDA toolkit's and C's own
CUDA_HEADERS = {"cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h", "mma.h", "math.h", "stdint.h"}


def _cuda_sources():
    return sorted((REPO / "mesm_tpu_torch" / "kernels" / "csrc").glob("*.cu"))


@pytest.mark.parametrize("path", _cuda_sources(), ids=lambda p: p.name)
def test_cuda_sources_include_only_toolkit_headers(path):
    """A kernel source builds from the CUDA toolkit alone: it includes no
    header of the JAX package, of PyTorch or of a package of finished
    kernels, and names neither the JAX package nor JAX."""
    text = path.read_text()
    includes = [line.split("#include", 1)[1].strip().strip("<>\"")
                for line in text.splitlines() if line.strip().startswith("#include")]
    assert includes and set(includes) <= CUDA_HEADERS, includes
    assert "jax" not in text.replace("mesm_tpu/", "").lower(), "names jax outside a file:line"


def _kernel_wrapper_modules():
    """The ops modules that load a CUDA library (the ctypes kernel wrappers)."""
    return [p for p in sorted((REPO / "mesm_tpu_torch" / "ops").glob("*.py"))
            if "kernels.build import load" in p.read_text()]


@pytest.mark.parametrize("path", _kernel_wrapper_modules(), ids=lambda p: p.name)
def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors(path):
    """In a kernel wrapper module, no function catches an error (no fallback
    after a failed launch), and a wrapper calls a plain version
    (`*_reference`) only under a test on the CPU device: on CUDA tensors it
    launches its kernel or raises."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], "a try block"
    bad = []
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        if fn.name.endswith("_reference"):
            continue

        def visit(node, under_cpu: bool):
            if isinstance(node, ast.If) and "'cpu'" in ast.unparse(node.test):
                for child in node.body:
                    visit(child, True)
                for child in node.orelse:
                    visit(child, under_cpu)
                return
            if isinstance(node, ast.Call):
                name = ast.unparse(node.func)
                if name.endswith("_reference") and not under_cpu:
                    bad.append(f"{fn.name} calls {name}")
            for child in ast.iter_child_nodes(node):
                visit(child, under_cpu)

        for stmt in fn.body:
            visit(stmt, False)
    assert not bad, bad


def test_short_key_wrappers_run_plain_versions_on_cpu_without_counting():
    before = (sk.launches, sk.onematmul_launches, ap.pair_launches)
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 70, 64, generator=g)
    k, v = torch.randn(2, 2, 17, 64, generator=g)
    mask = torch.ones(2, 17, dtype=torch.bool)
    pair = (torch.rand(2, 2, 70, generator=g) < 0.5, torch.rand(2, 2, 17, generator=g) < 0.5)
    torch.testing.assert_close(sk.attention_shortkey(q, k, v, 2, mask, pair),
                               sk.attention_shortkey_reference(q, k, v, 2, mask, pair),
                               rtol=0, atol=0)
    torch.testing.assert_close(sk.attention_shortkey_onematmul(q, k, v, 2, mask, pair),
                               sk.attention_shortkey_onematmul_reference(q, k, v, 2, mask, pair),
                               rtol=0, atol=0)
    torch.testing.assert_close(ap.attention_packed_pair(q, q, q, 2, None, (pair[0], pair[0])),
                               ap.attention_packed_pair_reference(q, q, q, 2, None,
                                                                  (pair[0], pair[0])),
                               rtol=0, atol=0)
    assert (sk.launches, sk.onematmul_launches, ap.pair_launches) == before


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
