"""The port's spans (utils/profiling.py::span, take_spans) on the CPU at
tiny widths: nothing is recorded with no profiler running; under a profiler
one train step (two microbatches), one greedy decode and one loader pass
record exactly their spans, with their parents, on the clock of the
profiler's trace; a decoder exported under a running profiler holds no
profiler operator."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from adaptive_tpu_torch.config import Config
from adaptive_tpu_torch.data.loader import TrainBatches, device_prefetch
from adaptive_tpu_torch.decoding import make_greedy_decoder
from adaptive_tpu_torch.models.factory import build_model
from adaptive_tpu_torch.training.optim import make_dual_optimizer
from adaptive_tpu_torch.training.step import make_train_step
from adaptive_tpu_torch.utils.profiling import span, take_spans

B, S, T = 2, 72, 6
CLOCK_NS = 100_000  # a span against its record_function event: 0.1 ms


class Pool:
    """Four images with one caption each, as TrainBatches reads a dataset."""

    def __init__(self):
        rng = np.random.default_rng(3)
        self.images = rng.integers(0, 255, (4, S, S, 3), dtype=np.uint8)
        self.ids = [0, 1, 2, 3]
        caps = {i: [1] + rng.integers(4, 32, 3).tolist() + [2] for i in self.ids}
        self.coco = type("Anns", (), {"anns": {i: {"caption": c} for i, c in caps.items()}})
        self.vocab = type("Tokens", (), {"encode_caption": staticmethod(list)})

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.images[i], self.coco.anns[i]["caption"], i


@pytest.fixture(scope="module")
def port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny widths: one thread, and none idle-spinning
    try:
        yield build_port()
    finally:
        torch.set_num_threads(threads)


def build_port():
    cf = Config(encoder_backbone="resnet18", train_crop_size=64, resized_image_size=S,
                vocab_length=32, adaptive_word_embed_size=8, adaptive_lstm_hidden_size=16,
                train_batch_size=B, eval_batch_size=B, decode_max_len=5,
                train_grad_accum_steps=2, dataloader_num_workers=1)
    model = build_model(cf, device="cpu")
    net = model.init(0)
    step = make_train_step(model, make_dual_optimizer(net, cf), cf)
    decode = make_greedy_decoder(model, cf)
    rng = np.random.default_rng(5)
    caps = rng.integers(4, 32, (B, T)).astype(np.int32)
    caps[:, 0], caps[:, -1] = 1, 2
    batch = {"images": rng.integers(0, 255, (B, S, S, 3), dtype=np.uint8), "captions": caps,
             "lengths": np.full((B,), T, np.int32)}
    calls = {
        "train": lambda: step(net, batch, torch.Generator().manual_seed(0), True),
        "decode": lambda: decode(net, batch["images"]),
        "loader": lambda: list(device_prefetch(iter(TrainBatches(Pool(), B, buckets=(8,),
                                                                 num_workers=1)), "cpu")),
    }
    for call in calls.values():  # warm: no first-call work in the recorded ones
        call()
    take_spans()
    return {"cf": cf, "model": model, "net": net, "calls": calls}


def recorded(call, tmp_path):
    """(spans, the Chrome trace) of call run under a CPU profiler, after a
    first range of the session (which sets up the profiler's state of the
    thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("session"):
            pass
        take_spans()
        call()
    spans = take_spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return spans, json.loads(path.read_text())


def test_no_profiler_records_nothing(port):
    assert span("train.step") is span("decode.loop")  # one shared no-op
    for call in port["calls"].values():
        call()
    assert take_spans() == []


EXPECTED = {
    "train": [("train.step", None), ("train.forward", 0), ("train.backward", 0),
              ("train.forward", 0), ("train.backward", 0), ("train.optimizer", 0)],
    "decode": [("decode.preprocess", None), ("decode.encode", None), ("decode.loop", None)],
    "loader": [("loader.wait", None), ("prefetch.put", None)] * 2,
}


def clock_gaps(spans, trace):
    """The largest distance (ns) between a span's start or end and its
    record_function event's, on the trace's clock (ts + baseTimeNanoseconds)."""
    base = trace["baseTimeNanoseconds"]
    names = {s.name for s in spans}
    ranges = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"] in names]
    assert [e["name"] for e in ranges] == [s.name for s in spans]
    gaps = []
    for s, e in zip(spans, ranges):
        start = round(e["ts"] * 1e3) + base
        gaps += [abs(s.start_ns - start), abs(s.end_ns - (start + round(e["dur"] * 1e3)))]
    return max(gaps)


@pytest.mark.parametrize("call", sorted(EXPECTED))
def test_spans_under_a_profiler(port, call, tmp_path):
    """Exactly the call's spans with their parents, each on the trace's
    clock within CLOCK_NS of its record_function event on one of three
    recordings (the OS may preempt the thread between the two)."""
    gaps = []
    for _ in range(3):
        spans, trace = recorded(port["calls"][call], tmp_path)
        assert [(s.name, s.parent) for s in spans] == EXPECTED[call]
        assert {s.thread for s in spans} == {threading.get_native_id()}
        for s in spans:
            assert s.start_ns < s.end_ns
            if s.parent is not None:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        gaps.append(clock_gaps(spans, trace))
        if gaps[-1] < CLOCK_NS:
            break
    assert min(gaps) < CLOCK_NS, gaps


def test_spans_of_another_thread_are_its_own(port):
    """A thread with no profiler of its own records nothing; the spans it
    would open do not become the children of the main thread's."""
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("train.step"):
            t = threading.Thread(target=lambda: seen.append(span("loader.wait")))
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [span("x")]  # the no-op
    assert [(s.name, s.parent) for s in take_spans()] == [("train.step", None)]


def test_export_under_a_profiler_holds_no_profiler_op(port, tmp_path):
    from adaptive_tpu_torch.export import export_decoder

    take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        path = export_decoder(port["model"], port["cf"], port["net"], str(tmp_path / "d.pt2"),
                              batch_size=B)
    graph = torch.export.load(path).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert [s.name for s in take_spans()] == []


def test_spans_past_the_cap_are_counted_not_kept(monkeypatch):
    from adaptive_tpu_torch.utils import profiling

    take_spans()
    monkeypatch.setattr(profiling._RECORDER, "cap", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("train.step"):
            for name in ("train.forward", "train.backward"):
                with span(name):
                    pass
    with pytest.warns(UserWarning, match="1 spans past the cap of 2"):
        kept = take_spans()
    assert [(s.name, s.parent) for s in kept] == [("train.step", None), ("train.forward", 0)]
    assert take_spans() == []
