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
from mesm_tpu_torch.ops import ffn_int8 as fi
from mesm_tpu_torch.ops import anchor as an
from mesm_tpu_torch.ops import ln_dense as ld
from mesm_tpu_torch.ops import stream_layer as sl

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
    return sorted((REPO / "mesm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                              REPO / "compare_steps.py"]


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
                "kernels/__init__.py", "data/pipeline.py", "ops/attention_heads.py",
                "ops/ffn_int8.py", "models/layers.py", "ops/stream_layer.py", "ops/anchor.py",
                "scripts/bench_layer_kernel.py", "convert.py", "ops/attention_backward.py"):
        assert f"mesm_tpu_torch/{rel}" in names, rel
    sources = {p.name for p in _cuda_sources()}
    assert {"ln_dense.cu", "attention_packed.cu", "attention_batched.cu",
            "attention_shortkey.cu", "attention_heads.cu", "ffn_int8.cu", "stream_layer.cu",
            "anchor.cu", "attention_backward.cu", "attention_mma.cuh",
            "attention_regtile.cuh", "attention_grid.cuh", "attention_tf32.cuh",
            "attention_fp32.cuh"} <= sources
    wrappers = {p.name for p in _kernel_wrapper_modules()}
    assert {"attention_heads.py", "ffn_int8.py", "stream_layer.py", "anchor.py",
            "attention_backward.py"} <= wrappers
    from mesm_tpu_torch.kernels.build import KERNELS

    assert {p.stem for p in CSRC.glob("*.cu")} == set(KERNELS)  # build_all builds every source


# the headers a kernel source may include: the CUDA toolkit's and C's own
CUDA_HEADERS = {"cuda.h", "cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h", "mma.h", "math.h",
                "stdint.h", "cooperative_groups.h"}


CSRC = REPO / "mesm_tpu_torch" / "kernels" / "csrc"


def _cuda_sources():
    """The kernel sources and the shared device-code headers they include."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@pytest.mark.parametrize("path", _cuda_sources(), ids=lambda p: p.name)
def test_cuda_sources_include_only_toolkit_headers(path):
    """A kernel source or header builds from the CUDA toolkit alone: it
    includes the toolkit's headers and, by name, the port's own
    `csrc/*.cuh`, no header of the JAX package, of PyTorch or of a package
    of finished kernels, and names neither the JAX package nor JAX."""
    text = path.read_text()
    includes = [line.split("#include", 1)[1].strip().strip("<>\"")
                for line in text.splitlines() if line.strip().startswith("#include")]
    own = {p.name for p in CSRC.glob("*.cuh")} - {path.name}
    assert includes and set(includes) <= CUDA_HEADERS | own, includes
    assert "jax" not in text.replace("mesm_tpu/", "").lower(), "names jax outside a file:line"


# the shared header each source below includes: the mma tiles, and for the
# backward kernels the grid
SHARED_HEADER = {"attention_backward": "attention_grid.cuh"}


@pytest.mark.parametrize("name", ["attention_heads", "attention_batched", "attention_packed",
                                  "attention_backward"])
def test_library_path_follows_the_shared_headers(tmp_path, name):
    """An edited csrc/*.cuh gives every source a new library path, so a
    source that includes it is rebuilt rather than served stale; an
    unchanged tree keeps its path. Each of the sources on the shared mma
    tiles includes their header, the backward source the grid's."""
    import shutil

    from mesm_tpu_torch.kernels.build import library_path

    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    included = SHARED_HEADER.get(name, "attention_mma.cuh")
    assert f'#include "{included}"' in (csrc / f"{name}.cu").read_text()
    before = library_path(name, csrc)
    assert before == library_path(name)
    header = csrc / included
    header.write_text(header.read_text() + "\n// edited\n")
    assert library_path(name, csrc) != before
    assert library_path(name, csrc).name.startswith(f"lib{name}-")


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
        ab.attention_batched(*_attn_args(torch.float16, "meta"), 2)  # the kernel is fp32 or bf16
    with pytest.raises(ValueError, match="unsupported device"):
        ab.attention_batched(*_attn_args(torch.float32, "meta"), 4)  # head_dim 16: an instance
    with pytest.raises(ValueError, match="unsupported device"):  # head_dim 256: a wide head
        ab.attention_batched(*_attn_args(torch.float32, "meta", E=512), 2)
    q, k, v = _attn_args(torch.float32, "meta")
    with pytest.raises(ValueError, match="shapes"):
        ab.attention_batched(q, k, v[..., :32].contiguous(), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ab.attention_batched(q, k, v, 2)
    assert ab.launches == before


def test_ffn_int8_wrapper_runs_plain_version_on_cpu_and_refuses_the_rest():
    g = torch.Generator().manual_seed(3)
    args = [torch.randn(*shape, generator=g) for shape in ((5, 32), (64, 32), (64,), (1,), (32, 64), (32,))]
    before = fi.launches
    torch.testing.assert_close(fi.ffn_int8(*args), fi.ffn_int8_reference(*args), rtol=0, atol=0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(TypeError):
        fi.ffn_int8(meta[0].half(), *meta[1:])
    # widths that are no multiple of 32 reach the device check: the kernel
    # takes any K, N1, K2; a depth past its exact int32 sums does not
    with pytest.raises(ValueError, match="unsupported device"):
        fi.ffn_int8(meta[0][:, :16].contiguous(), meta[1][:, :16].contiguous(), *meta[2:4],
                    meta[4][:16].contiguous(), meta[5][:16].contiguous())
    deep = fi.MAX_DEPTH + 1
    with pytest.raises(ValueError, match="depth"):
        fi.ffn_int8(torch.empty(5, deep, device="meta"), torch.empty(64, deep, device="meta"),
                    *meta[2:])
    with pytest.raises(ValueError, match="shapes"):
        fi.ffn_int8(meta[0], meta[1][:, :31], *meta[2:])
    with pytest.raises(ValueError, match="unsupported device"):
        fi.ffn_int8(*meta)
    assert fi.launches == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """Non-CPU tensors the kernels do not take raise before any launch (meta
    tensors stand in for device tensors: the checks read only dtype, shape
    and layout)."""
    before = (ld.launches, ap.launches)
    with pytest.raises(TypeError):
        ld.ln_dense(*_ln_args(torch.float16, "meta"), relu=True)
    # any F (40: not a multiple of 16; 512: above one warpgroup's 256) and
    # any D reach the device check
    for F, D in ((40, 70), (512, 70), (48, 8192)):
        with pytest.raises(ValueError, match="unsupported device"):
            ld.ln_dense(*_ln_args(torch.bfloat16, "meta", D=D, F=F), relu=True)
    x, gamma, beta, w, b = _ln_args(torch.float32, "meta")
    with pytest.raises(ValueError, match="shapes"):
        ld.ln_dense(x, gamma, beta, w[:, :-1], b, relu=False)
    with pytest.raises(ValueError, match="contiguous"):
        ld.ln_dense(x.t().contiguous().t(), gamma, beta, w, b, relu=False)
    with pytest.raises(TypeError):
        ap.attention_packed(*_attn_args(torch.float16, "meta"), 2)  # the kernel is bf16 or fp32
    with pytest.raises(ValueError, match="unsupported device"):
        ap.attention_packed(*_attn_args(torch.bfloat16, "meta"), 4)  # head_dim 16: an instance
    with pytest.raises(ValueError, match="unsupported device"):  # head_dim 256: a wide head
        ap.attention_packed(*_attn_args(torch.bfloat16, "meta", E=512), 2)
    q, k, v = _attn_args(torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="shapes"):
        ap.attention_packed(q, k, v[..., :32].contiguous(), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ap.attention_packed(q, k, v, 2)  # everything fits, but meta is not CUDA
    assert (ld.launches, ap.launches) == before


def _layer_args(dtype=torch.float32, device="cpu", B=2, Lq=7, Lk=5, D=64, F=96, self_attn=False):
    """x, pos, k_in, v_in, mask, params of a small stream layer (4 heads)."""
    g = torch.Generator().manual_seed(4)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x, pos = rn(B, Lq, D).to(device=device, dtype=dtype), rn(B, Lq, D).to(device=device, dtype=dtype)
    k_in = v_in = None
    if not self_attn:
        k_in, v_in = (rn(B, Lk, D).to(device=device, dtype=dtype) for _ in range(2))
    shapes = {"w1": (F, D), "b1": (F,), "w2": (D, F), "alpha": (1,)}
    params = {n: rn(*shapes.get(n, (D, D) if n in ("wq", "wk", "wv", "wo") else (D,))).to(device)
              for n in sl.WEIGHT_NAMES}
    mask = torch.ones(B, Lq if self_attn else Lk, dtype=torch.bool, device=device)
    return x, pos, k_in, v_in, mask, params


def test_stream_layer_and_anchor_wrappers_run_plain_version_on_cpu_and_refuse_the_rest():
    """On the CPU the fused layer is its plain version and the anchor x
    itself, neither counted; inputs that need grad, dtypes, widths and
    devices the kernels do not take raise before any launch (meta tensors
    stand in for device tensors)."""
    before = (sl.launches, an.launches)
    for self_attn in (True, False):
        x, pos, k_in, v_in, mask, params = _layer_args(self_attn=self_attn)
        torch.testing.assert_close(
            sl.fused_stream_layer(x, pos, k_in, v_in, mask, None, params, 4, self_attn),
            sl.stream_layer_reference(x, pos, k_in, v_in, mask, None, params, 4, self_attn),
            rtol=0, atol=0,
        )
    assert an.layout_anchor(x) is x
    x, pos, k_in, v_in, mask, params = _layer_args()
    grad_params = dict(params, w1=params["w1"].clone().requires_grad_(True))
    # grad mode on here: another test module turns it off for its process
    with torch.enable_grad(), pytest.raises(RuntimeError, match="requires grad"):
        sl.fused_stream_layer(x, pos, k_in, v_in, mask, None, grad_params, 4, False)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="requires grad"):
        an.layout_anchor(torch.empty(2, 3, 4, device="meta", requires_grad=True))
    with pytest.raises(TypeError):
        sl.fused_stream_layer(*_layer_args(torch.float16, "meta")[:4], None, None,
                              _layer_args(torch.float16, "meta")[5], 4, False)
    # D 48 (head_dim 12) and F 80 reach the device check: the kernel pads
    # them; a head_dim above its largest instance (516 / 4 = 129) does not
    for D, F in ((48, 96), (64, 80)):
        with pytest.raises(ValueError, match="unsupported device"):
            x, pos, k_in, v_in, mask, params = _layer_args(torch.bfloat16, "meta", D=D, F=F)
            sl.fused_stream_layer(x, pos, k_in, v_in, mask, None, params, 4, False)
    with pytest.raises(ValueError, match="head_dim"):
        x, pos, k_in, v_in, mask, params = _layer_args(torch.bfloat16, "meta", D=516, F=96)
        sl.fused_stream_layer(x, pos, k_in, v_in, mask, None, params, 4, False)
    x, pos, k_in, v_in, mask, params = _layer_args(torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="shapes"):
        sl.fused_stream_layer(x, pos, k_in, v_in, mask, None, dict(params, w2=params["w1"]), 4,
                              False)
    with pytest.raises(ValueError, match="contiguous"):
        sl.fused_stream_layer(x, pos, k_in.transpose(0, 1).contiguous().transpose(0, 1), v_in,
                              mask, None, params, 4, False)
    with pytest.raises(ValueError, match="unsupported device"):
        sl.fused_stream_layer(x, pos, k_in, v_in, mask, None, params, 4, False)
    with pytest.raises(ValueError, match="unsupported device"):
        an.layout_anchor(torch.empty(2, 3, 4, device="meta"))
    assert (sl.launches, an.launches) == before


def test_pair_entry_point_runs_the_mma_body():
    """The bf16 pair entry point of attention_packed.cu launches the shared
    mma body with its own rounding chain (attention_mma.cuh, Chain::PAIR),
    which stages the key pair factors as a bit of the key flags."""
    source = (CSRC / "attention_packed.cu").read_text()
    assert '#include "attention_mma.cuh"' in source
    assert "if (is_bf16) return launch_pair_mma<HD>(" in source
    assert "mma_attn::block_attend<HD, RESIDENT, mma_attn::Chain::PAIR, KEYS>(" in source
    header = (CSRC / "attention_mma.cuh").read_text()
    assert "enum class Chain { BATCHED, PACKED, PAIR };" in header
    assert "KEY_PAIR" in header
