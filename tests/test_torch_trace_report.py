"""The PyTorch port's trace reports (adaptive_tpu_torch/utils/trace_report.py)
and profiling harness (utils/profiling.py) on a small synthetic Chrome trace
and on the CPU."""

import gzip
import json
import os

import pytest
import torch

from adaptive_tpu_torch.utils import trace_report as tr
from adaptive_tpu_torch.utils.profiling import Timer, profile_trace
from tests.torch_port_util import port_threads  # noqa: F401

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::cell_gates_kernel<64, 32>"
     "(float const*)", "ts": 100, "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::cell_gates_kernel<64, 32>"
     "(float const*)", "ts": 200, "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::head_argmax_mma_kernel(int)",
     "ts": 130, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::head_argmax_reduce(int)",
     "ts": 135, "dur": 10},  # overlaps the one before: busy counts 130..145 once
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16bf16_cudnn",
     "ts": 300, "dur": 40},
    {"ph": "X", "cat": "kernel", "name": "nvjet_tst_256x48_64x5_2x1_v_bz_TNT_gemm", "ts": 350,
     "dur": 8},
    {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>",
     "ts": 360, "dur": 4},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 370,
     "dur": 2},
    {"ph": "X", "cat": "kernel", "name": "fusion.12", "ts": 380, "dur": 6},
    {"ph": "X", "cat": "kernel", "name": "fusion.13", "ts": 390, "dur": 4},
    # host events: never device time, but they bound the window
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "python_function", "name": "decode", "ts": 50, "dur": 500},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "ts": 100, "dur": 400},
    {"ph": "M", "name": "thread_name"},
]


def _write(tmp_path, events, name="host_1.2.pt.trace.json.gz"):
    d = tmp_path / "trace"
    os.makedirs(d, exist_ok=True)
    with gzip.open(d / name, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_summary_and_filtering(tmp_path):
    events = tr.load_trace_events(_write(tmp_path, EVENTS))
    summary = tr.device_op_summary(events, iters=2)
    cats = {c: (ms, n) for c, ms, n in summary}
    gates = "void (anonymous namespace)::cell_gates_kernel<64, 32>(float const*)"
    assert cats[gates] == (0.02, 2)  # (20 + 20) us / 2 iterations
    assert cats["fusion"] == (0.005, 2)  # instance suffixes stripped
    assert not any(k in cats for k in ("aten::mm", "decode", "Optimizer.step"))
    assert [ms for _, ms, _ in summary] == sorted((ms for _, ms, _ in summary), reverse=True)
    report = tr.format_report(summary)
    assert "cell_gates_kernel" in report and "ms/iter" in report


def test_stage_split_classification(tmp_path):
    split = tr.stage_split(tr.load_trace_events(_write(tmp_path, EVENTS)))
    assert split["kernel 1/3 cell"] == pytest.approx(0.04)
    assert split["kernel 2 head argmax"] == pytest.approx(0.02)
    assert split["conv (cuDNN)"] == pytest.approx(0.04)
    assert split["gemm (cuBLAS/CUTLASS)"] == pytest.approx(0.008)
    assert split["elementwise/reduce"] == pytest.approx(0.004)
    assert split["memcpy/memset"] == pytest.approx(0.002)
    assert split["other"] == pytest.approx(0.01)  # the fusions
    # busy: 100..120, 130..145, 200..220, 300..340, 350..358, 360..364,
    # 370..372, 380..386, 390..394 = 119 us of a 1,000 us window
    assert split["busy_ms"] == pytest.approx(0.119)
    assert split["window_ms"] == pytest.approx(1.0)
    assert split["busy_share"] == pytest.approx(0.119)


def test_newest_trace_wins_and_plain_json(tmp_path):
    root = _write(tmp_path, EVENTS, "old.pt.trace.json.gz")
    newer = tmp_path / "trace" / "new.pt.trace.json"
    newer.write_text(json.dumps({"traceEvents": EVENTS[:1]}))
    os.utime(newer, (os.path.getmtime(newer) + 10,) * 2)
    assert len(tr.load_trace_events(root)) == 1
    with pytest.raises(FileNotFoundError):
        tr.load_trace_events(str(tmp_path / "empty"))


def test_profile_trace_writes_a_trace_main_reads(tmp_path, capsys):
    """profile_trace on the CPU writes a gzipped Chrome trace; main reads
    it (no device events there: 0 ms of device time)."""
    with profile_trace(str(tmp_path)):
        a = torch.randn(32, 32)
        (a @ a).sum()
    events = tr.load_trace_events(str(tmp_path))
    assert any(e.get("cat") == "cpu_op" for e in events)
    tr.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "device time: 0.000 ms/iter" in out and "busy_share 0.0000" in out
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")


def test_timer():
    t = Timer()
    for _ in range(3):
        with t.measure() as out:
            out.append(torch.ones(2))
    assert len(t.samples) == 3 and t.best() <= t.p50() and t.best() <= t.mean()
    assert Timer().p50() != Timer().p50()  # nan with no samples
