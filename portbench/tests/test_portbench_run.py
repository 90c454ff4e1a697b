"""The run's contract: the result line's keys, the exit without a card, the
look for JAX and the JAX package by whole top-level names, and a reference
that imports nothing of the measured program."""
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny

ROOT = harness.ROOT


def test_result_line_format(monkeypatch, capsys):
    result, checks = tiny.run("charades-eval")
    line = harness.compose(result, {"platform": "gpu", "kind": "card", "count": 1,
                                    "memory_peak_bytes": 123})
    harness.emit(line, checks)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert set(last["metrics"]) == {"eval_rows_per_s", "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in last["checks"].values())
    tail = err.strip().splitlines()[-len(checks):]
    assert all(line.startswith("check ") for line in tail)


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tacos-eval", "--seed",
                        "3000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_names_are_whole():
    assert harness.forbidden_modules(["mesm_tpu_torch", "mesm_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["mesm_tpu.models", "jaxlib.xla", "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "mesm_tpu"]


def test_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests import tiny\n"
            "from portbench import harness\n"
            "r, c = tiny.run('tacos-eval')\n"
            "print(harness.forbidden_modules(), r['correct'])\n") % ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.model, portbench.reference.train\n"
            "import portbench.reference.decode, portbench.counts.model\n"
            "import portbench.counts.kernels, portbench.weights, portbench.gen\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mesm_tpu_torch', 'mesm_tpu', 'jax', 'jaxlib', 'flax'}))\n") % ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
