"""The span readers (lib/span_split.py, metrics/*_span_ms.*, *_host_ms.train,
input_idle_ms.train) on a synthetic trace and spans: device time goes to
the innermost span its runtime call started in, whatever thread made it;
idle gaps split by the main thread's innermost span, the runtime calls and
the rest; values are per iteration of the slice; no spans, no value."""

from __future__ import annotations

import json
import threading
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import load_reader
from benchmark.lib import span_split
from benchmark.lib.span_split import RUNTIME, UNTRACED, idle_split, launched, spans_us

MAIN = threading.main_thread().native_id
OTHER = MAIN + 1


def runtime(corr, ts, dur=1.0, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# (start, end, name, thread) in us on the trace's clock: a step with a
# forward and a backward, a loader wait and a prefetch before it
SPANS = sorted([(0.0, 100.0, "train.step", MAIN), (10.0, 40.0, "train.forward", MAIN),
                (40.0, 80.0, "train.backward", MAIN), (-30.0, -10.0, "loader.wait", MAIN),
                (-10.0, -2.0, "prefetch.put", MAIN)])
EVENTS = [
    runtime(1, 20.0), kernel(1, 25.0, 30.0),  # forward, launched inside train.forward
    runtime(2, 50.0, tid=OTHER), kernel(2, 60.0, 40.0),  # the autograd thread's backward
    runtime(3, 90.0), kernel(3, 100.0, 5.0),  # in train.step alone
    runtime(4, 110.0), kernel(4, 140.0, 10.0),  # after every span
    kernel(5, 150.0, 2.0),  # no runtime call of its correlation
    runtime(6, -5.0), {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                       "ts": 0.0, "dur": 4.0, "args": {"correlation": 6}},
]


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    got = launched(EVENTS, SPANS)
    assert got == pytest.approx({"train.forward": 30e-6, "train.backward": 40e-6,
                                 "train.step": 5e-6, "prefetch.put": 4e-6, None: 12e-6})


def test_idle_gaps_split_by_the_main_threads_innermost_span():
    """Busy [0, 4], [25, 55], [60, 100], [100, 105], [140, 152]: the gaps
    4-25 (train.step, then train.forward from 10), 55-60 (train.backward)
    and 105-140 (a runtime call 110-111, the rest untraced)."""
    got = idle_split(EVENTS, SPANS, MAIN)
    assert got == pytest.approx({"train.step": 6e-6, "train.forward": 15e-6,
                                 "train.backward": 5e-6, RUNTIME: 1e-6, UNTRACED: 34e-6})
    # the same gaps split by another thread's spans: none of them
    assert sum(idle_split(EVENTS, SPANS, OTHER).values()) == pytest.approx(61e-6)


def test_an_idle_gap_split_between_a_loader_wait_and_no_span():
    events = [kernel(1, 0.0, 10.0), kernel(2, 40.0, 5.0), runtime(3, 32.0, 2.0)]
    spans = [(12.0, 30.0, "loader.wait", MAIN), (15.0, 38.0, "decode.loop", OTHER)]
    assert idle_split(events, spans, MAIN) == pytest.approx(
        {"loader.wait": 18e-6, RUNTIME: 2e-6, UNTRACED: 10e-6})


def ctx_of(spans, events, iters):
    return SimpleNamespace(memo={"spans": spans}, events=events, slice={"iters": iters})


@pytest.mark.parametrize("name, per_slice_us", [
    ("forward_span_ms.train", 30.0), ("backward_span_ms.train", 40.0),
    ("optimizer_span_ms.train", 0.0), ("step_host_ms.train", 100.0),
    ("input_host_ms.train", 28.0), ("input_idle_ms.train", 0.0),
])
def test_readers_divide_by_the_slices_iterations(name, per_slice_us):
    ctx = ctx_of(SPANS, EVENTS, 4)
    assert load_reader(name).read(ctx) == pytest.approx(per_slice_us / 1e3 / 4)


def test_decode_readers():
    spans = [(0.0, 10.0, "decode.preprocess", MAIN), (10.0, 50.0, "decode.encode", MAIN),
             (50.0, 90.0, "decode.loop", MAIN)]
    events = [runtime(1, 2.0), kernel(1, 5.0, 8.0), runtime(2, 20.0), kernel(2, 21.0, 100.0),
              runtime(3, 60.0), kernel(3, 130.0, 6.0)]
    ctx = ctx_of(spans, events, 2)
    assert load_reader("encoder_span_ms.decode").read(ctx) == pytest.approx(108e-3 / 2)
    assert load_reader("loop_span_ms.decode").read(ctx) == pytest.approx(6e-3 / 2)


@pytest.mark.parametrize("name", ["encoder_span_ms.decode", "loop_span_ms.decode",
                                  "forward_span_ms.train", "backward_span_ms.train",
                                  "optimizer_span_ms.train", "step_host_ms.train",
                                  "input_host_ms.train", "input_idle_ms.train"])
def test_no_spans_no_value(name):
    assert load_reader(name).read(ctx_of(None, EVENTS, 4)) is None
    # nothing recorded in the program: the readers take nothing and read nothing
    empty = SimpleNamespace(memo={}, events=EVENTS, slice={"iters": 4})
    assert load_reader(name).read(empty) is None and empty.memo["spans"] is None


def test_device_readers_need_device_events():
    ctx = ctx_of(SPANS, [e for e in EVENTS if e["cat"] == "cuda_runtime"], 4)
    assert load_reader("forward_span_ms.train").read(ctx) is None
    assert load_reader("step_host_ms.train").read(ctx) == pytest.approx(100e-3 / 4)


def test_spans_meet_the_trace_on_its_clock(tmp_path):
    """A span taken from the program, on the clock trace_base_ns gives,
    lies on its record_function event of another trace of the process."""
    from adaptive_tpu_torch.utils.profiling import span, take_spans

    take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step"):
            sum(range(10_000))
    (s,) = spans_us(take_spans(), span_split.trace_base_ns())
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    (e,) = [e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
            if e.get("name") == "train.step"]
    assert s[2:] == ("train.step", MAIN)
    assert abs(s[0] - e["ts"]) < 1e3 and abs(s[1] - (e["ts"] + e["dur"])) < 1e3
