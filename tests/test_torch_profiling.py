"""Profiling of the port (mesm_tpu_torch/utils/profiling.py,
utils/trace_report.py, scripts/profile_eval.py, scripts/profile_train.py),
the counterparts of mesm_tpu/utils/profiling.py and trace_report.py: a CPU
trace written under MESM_TPU_PROFILE_DIR, its per-op and per-module reports,
nothing written or installed with profiling off, and the reports' reading
of a card's trace (kernel events joined to their launches by correlation
id) on a trace written out by hand."""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from mesm_tpu_torch.models.mesm import MESM, MESMConfig
from mesm_tpu_torch.utils import profiling, trace_report
from mesm_tpu_torch.utils.profiling import MODULE_RANGE_PREFIX, maybe_trace

from test_torch_harness import SMALL, small_batch, torch_forward


def _model():
    torch.manual_seed(0)
    return MESM(MESMConfig(**SMALL)).eval()


def _hooks(model):
    return sum(len(m._forward_pre_hooks) + len(m._forward_hooks) for m in model.modules())


def test_trace_under_env_dir_reports_ops_and_modules(tmp_path, monkeypatch):
    monkeypatch.setenv("MESM_TPU_PROFILE_DIR", str(tmp_path))
    model, batch = _model(), small_batch(0)
    with maybe_trace(model=model):
        assert _hooks(model) > 0
        torch_forward(model, batch)
    assert _hooks(model) == 0
    assert glob.glob(str(tmp_path / "*.pt.trace.json"))
    totals, counts, total_ms, what = trace_report.device_op_totals(str(tmp_path))
    assert what.startswith("CPU") and total_ms > 0 and counts["aten::linear"] > 0
    assert "aten::linear" in trace_report.report(str(tmp_path))
    mods, mod_total = trace_report.module_totals(str(tmp_path), depth=2)
    assert abs(mod_total - total_ms) < 1e-6
    assert mods.get("MESM/transformer", 0) > 0 and mods.get("MESM/t2v_encoder", 0) > 0
    assert "MESM/transformer" in trace_report.module_report(str(tmp_path), depth=2)


def test_off_writes_nothing_and_installs_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("MESM_TPU_PROFILE_DIR", raising=False)
    model = _model()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with maybe_trace(model=model):
            assert _hooks(model) == 0
            torch_forward(model, small_batch(0))
    finally:
        os.chdir(cwd)
    assert not list(tmp_path.rglob("*"))


def _x(cat, name, ts, dur, tid=1, pid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


def test_card_trace_attributes_kernels_through_their_launches(tmp_path):
    """A card's trace: two kernels launched inside MESM/transformer/encoder's
    range (one by a ctypes call outside any op), one by the autograd engine,
    one launch outside every range, a copy left out by default, and a kernel
    whose launch the tracer did not see, joined by its external id."""
    mod = MODULE_RANGE_PREFIX
    events = [
        _x("user_annotation", mod + "MESM", 0, 100),
        _x("user_annotation", mod + "MESM/transformer", 10, 50),
        _x("user_annotation", mod + "MESM/transformer/encoder/layers/0", 20, 20,
           **{"External id": 11}),
        _x("cpu_op", "aten::mm", 21, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 200, 10, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 201, 1, tid=2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 300, 1, correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 301, 1, correlation=5),
        _x("kernel", "gemm", 40, 2000, tid=9, correlation=1),
        _x("kernel", "attention_packed_mma_kernel", 2100, 3000, tid=9, correlation=2),
        _x("kernel", "gemm", 5200, 1000, tid=9, correlation=3),
        _x("kernel", "fill", 6300, 500, tid=9, correlation=4),
        _x("gpu_memcpy", "Memcpy HtoD", 6900, 4000, tid=9, correlation=5),
        _x("kernel", "ctypes_kernel", 11000, 1000, tid=9, correlation=6, **{"External id": 11}),
    ]
    (tmp_path / "host_1.1.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    totals, counts, total, what = trace_report.device_op_totals(str(tmp_path))
    assert what.startswith("GPU kernels")
    assert counts == {"gemm": 2, "attention_packed_mma_kernel": 1, "fill": 1, "ctypes_kernel": 1}
    np.testing.assert_allclose(total, 7.5)
    assert trace_report.device_op_totals(str(tmp_path), memory=True)[2] == 11.5
    mods, _ = trace_report.module_totals(str(tmp_path), depth=3)
    np.testing.assert_allclose(mods["MESM/transformer/encoder"], 6.0)
    np.testing.assert_allclose(mods["<backward>"], 1.0)
    np.testing.assert_allclose(mods["<unattributed>"], 0.5)
    assert "attention_packed_mma_kernel" in trace_report.report(str(tmp_path))
    assert trace_report.kernel_modules(str(tmp_path)) == {
        "gemm": {"MESM/transformer/encoder": 1, "<backward>": 1},
        "attention_packed_mma_kernel": {"MESM/transformer/encoder": 1},
        "fill": {"<unattributed>": 1}, "ctypes_kernel": {"MESM/transformer/encoder": 1}}


def test_dropped_launches_and_the_settle_kernel_left_out(tmp_path):
    """A card's trace whose second and third launches have no kernel record
    (the tracer dropped them): two dropped; a copy, a graph launch and a
    launch with its record are not counted. The settle range's launch
    (profiling.settle_device_trace), dropped or recorded, its kernel and
    its range are in no count and no table."""
    settle = [
        _x("user_annotation", profiling.SETTLE_RANGE, 0, 10),
        _x("cpu_op", "aten::zeros", 1, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=9),
        _x("cuda_runtime", "cudaDeviceSynchronize", 4, 5, correlation=10),
        _x("gpu_user_annotation", profiling.SETTLE_RANGE, 3, 2, pid=0, tid=9),
    ]
    events = settle + [
        _x("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
        _x("cuda_driver", "cuLaunchKernelEx", 12, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 14, 1, correlation=4),
        _x("cuda_runtime", "cudaGraphLaunch", 15, 1, correlation=5),
        _x("kernel", "gemm", 20, 2, tid=9, correlation=3),
    ]
    trace = tmp_path / "host_1.1.pt.trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    assert trace_report.dropped_launches(str(tmp_path)) == 2
    assert trace_report.device_op_totals(str(tmp_path))[1] == {"gemm": 1}
    events += [_x("kernel", "fill", 22, 2, tid=9, correlation=1),
               _x("kernel", "ln_stats_kernel", 24, 2, tid=9, correlation=2),
               _x("kernel", "fill", 3, 1, tid=9, correlation=9)]
    trace.write_text(json.dumps({"traceEvents": events}))
    assert trace_report.dropped_launches(str(tmp_path)) == 0
    assert trace_report.device_op_totals(str(tmp_path))[1] == {
        "gemm": 1, "fill": 1, "ln_stats_kernel": 1}
    assert trace_report.kernel_modules(str(tmp_path))["fill"] == {"<unattributed>": 1}


def test_trace_settles_the_card_before_the_block(tmp_path, monkeypatch):
    """maybe_trace runs settle_device_trace inside the trace, before the
    block; on a card that launches one kernel inside SETTLE_RANGE, drains
    the card and waits DEVICE_CLOCK_GUARD_S; without CUDA it does nothing."""
    calls = []
    monkeypatch.setattr(profiling, "settle_device_trace", lambda: calls.append("settle"))
    with maybe_trace(str(tmp_path)):
        calls.append("block")
    assert calls == ["settle", "block"]
    monkeypatch.undo()

    calls.clear()
    monkeypatch.setattr(profiling, "record_function", lambda name: (
        calls.append(("range", name)) or __import__("contextlib").nullcontext()))
    monkeypatch.setattr(profiling.torch, "zeros", lambda *a, **k: calls.append(("kernel", k)))
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda: calls.append("sync"))
    monkeypatch.setattr(profiling.time, "sleep", lambda s: calls.append(("sleep", s)))
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: False)
    profiling.settle_device_trace()
    assert calls == []
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    profiling.settle_device_trace()
    assert calls == [("range", profiling.SETTLE_RANGE), ("kernel", {"device": "cuda"}), "sync",
                     ("sleep", profiling.DEVICE_CLOCK_GUARD_S)]


def test_profile_eval_driver_on_cpu(tmp_path, capsys):
    from mesm_tpu_torch.scripts import profile_eval

    out = profile_eval.main(["--device", "cpu", "--B", "8", "--iters", "1",
                             "--trace-dir", str(tmp_path)])
    assert "aten::linear" in out["report"]
    assert "MESM/transformer/encoder" in out["module_report"]
    assert "MESM/transformer/encoder" in capsys.readouterr().out


def test_profile_train_driver_on_cpu(tmp_path):
    from mesm_tpu_torch.scripts import profile_train

    out = profile_train.main(["--device", "cpu", "--B", "4", "--iters", "1",
                              "--trace-dir", str(tmp_path)])
    assert np.isfinite(out["loss"])
    assert "<backward>" in out["module_report"]
