"""The yardstick's arithmetic: model FLOPs against hand counts and against
torch.utils.flop_counter.FlopCounterMode, the kernels' roofline bounds,
the frozen stage split on a small recorded trace, and the open-loop
generator on a fake service."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import HERE, load_json
from benchmark.kinds.serve_open_loop import OpenLoop, arrivals, fill_share, p95_ms
from benchmark.lib import flops
from benchmark.lib.images import seeded_images
from benchmark.lib.program import reference_config
from benchmark.lib.stage_split import idle_gaps, stage_split
from benchmark.reference.model import Reference, make_weights
from benchmark.reference.train import _forward_loss

FULL = {name: reference_config(load_json(HERE / "configs" / f"{name}.json"))
        for name in ("adaptive_attention", "baseline_attention")}


def test_resnet152_matches_its_published_count():
    # torchvision's ResNet-152: 11.51 GMAC an image at 224 (its FC's 2 M included)
    assert flops.trunk_flops(FULL["adaptive_attention"]) == pytest.approx(2 * 11.51e9, rel=0.01)


def test_decoder_step_by_hand():
    E, H, K, V = 256, 512, 49, 10123
    lstm = 2 * 2 * E * 4 * H + 2 * H * 4 * H
    attend = 2 * H * K + 2 * K * K + 2 * K * H
    sentinel = 2 * 2 * E * H + 2 * H * H + 2 * H * K + 2 * K
    head = 2 * H * V
    assert flops.decoder_step_flops(FULL["adaptive_attention"]) == lstm + attend + sentinel + head
    assert flops.decoder_step_flops(FULL["baseline_attention"]) == lstm + attend + head


def test_kernel_bounds_by_hand():
    cfg = FULL["adaptive_attention"]
    b, f = flops.cell_w1(cfg, 1024)
    # inputs: gx fp32; h, c, h_prev, x; pv, V; seven weights (bf16); outputs
    want = (1024 * 2048 * 4 + 1024 * (3 * 512 + 512) * 2 + 1024 * 49 * (49 + 512) * 2
            + (512 * 2048 + 2048 + 512 * 512 + 512 * 512 + 2 * 512 * 49 + 49) * 2
            + 1024 * 3 * 512 * 2 + 1024 * 50 * 4)
    assert b == want
    assert flops.bound_s(b, f) == pytest.approx(b / 3.35e12)  # bound by bytes
    b, f = flops.head_argmax(cfg, 1024)
    assert f == 2 * 1024 * 512 * 10123
    assert flops.bound_s(b, f) == pytest.approx(f / 989e12)  # bound by operations


def test_train_step_counts_the_trained_parts():
    cfg = FULL["adaptive_attention"]
    fwd = flops.train_forward_flops(cfg, 16)
    frozen = flops.train_step_flops(cfg, 1, 16, False)
    tuned = flops.train_step_flops(cfg, 1, 16, True)
    assert fwd < frozen < 1.1 * fwd  # the decoder's backward is small
    assert 2.5 * fwd < tuned < 3 * fwd  # layers 2-4 are most of the trunk


def _weights(cfg):
    w = make_weights(cfg, 5, "cpu")
    for n, t in w.items():  # eval BN on calibrated-like statistics
        if n.endswith("running_var"):
            t.fill_(4.0)
    return w


@pytest.mark.parametrize("variant", ["adaptive_attention", "baseline_attention"])
def test_decode_flops_match_flop_counter(variant):
    """A batch-2 greedy decode's FLOPs from shapes equal FlopCounterMode's
    count of the reference's forward at the published widths."""
    cfg = FULL[variant]
    ref = Reference(_weights(cfg), cfg)
    images = seeded_images(2, 7, 256, "cpu")
    served = torch.randint(4, 100, (2, cfg["decode_max_len"]))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.served_logits(images, served, 1)
    assert fc.get_total_flops() == pytest.approx(flops.decode_flops(cfg, 2), rel=1e-9)


def test_train_forward_flops_match_flop_counter():
    cfg = FULL["adaptive_attention"]
    ref = Reference(_weights(cfg), cfg)
    T = 16
    batch = {"images": seeded_images(2, 8, 256, "cpu"),
             "captions": torch.randint(4, 100, (2, T)), "lengths": torch.tensor([16, 9]),
             "tops": [0, 32], "lefts": [5, 0], "flips": [True, False]}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        _forward_loss(ref, cfg, batch, 8, [])
    assert fc.get_total_flops() == pytest.approx(2 * flops.train_forward_flops(cfg, T), rel=1e-9)


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_stage_split_on_a_recorded_trace():
    """A trace of one decode step as the profiler records it: host ops and
    device kernels, two overlapping, one memcpy, gaps the host explains."""
    events = [
        _ev("aten::cat", 0, 40, "cpu_op"),
        _ev("cudaLaunchKernel", 10, 5, "cuda_runtime"),
        _ev("void at::native::vectorized_elementwise_kernel<4>", 20, 30),
        _ev("cell_gates_kernel", 60, 50),
        _ev("cell_attend_kernel", 110, 20),
        _ev("aten::item", 130, 70, "cpu_op"),
        _ev("head_argmax_mma_kernel", 180, 10),
        _ev("sm90_xmma_fprop_implicit_gemm_bf16", 185, 15),
        _ev("Memcpy DtoH (Device -> Pinned)", 210, 10, "gpu_memcpy"),
        _ev("ProfilerStep", 0, 230, "user_annotation"),
    ]
    sp = stage_split(events)
    assert sp["kernel 1/3 cell"] == pytest.approx(70e-6)
    assert sp["kernel 2 head argmax"] == pytest.approx(10e-6)
    assert sp["conv (cuDNN)"] == pytest.approx(15e-6)
    assert sp["elementwise/reduce"] == pytest.approx(30e-6)
    assert sp["memcpy/memset"] == pytest.approx(10e-6)
    # busy: [20, 50] + [60, 130] + [180, 200] + [210, 220] = 130 us of a 230 us window
    assert sp["busy_s"] == pytest.approx(130e-6)
    assert sp["window_s"] == pytest.approx(230e-6)
    gaps = dict(idle_gaps(events))
    # [50, 60] and [200, 210] under the step's annotation alone, [130, 180] under item
    assert gaps == pytest.approx({"ProfilerStep": 20e-6, "aten::item": 50e-6})


def test_window_idle_share_scales_the_slice_by_flops():
    """The slice's busy seconds a FLOP, times the window's FLOPs, over the
    window's seconds: a slice busy 0.3 s for 3 TFLOP, a window of 30 TFLOP
    in 4 s, is busy 3 of its 4 s."""
    from types import SimpleNamespace

    from benchmark.lib.readings import window_idle_share

    ctx = SimpleNamespace(events=[{}], slice={"flops": 3e12}, work={"flops": 30e12, "s": 4.0},
                          split=lambda: {"busy_s": 0.3})
    assert window_idle_share(ctx) == pytest.approx(25.0)
    ctx.slice = {}
    assert window_idle_share(ctx) is None


def test_arrivals_offer_the_same_gaps_on_every_seed():
    a, b = arrivals(400.0, 20.0, 1), arrivals(400.0, 20.0, 2 ** 31 + 5)
    assert len(a) == len(b) == 8000
    assert sorted(np.diff(a, prepend=0)) == pytest.approx(sorted(np.diff(b, prepend=0)))
    assert a[-1] == pytest.approx(20.0, rel=0.01)


def test_open_loop_times_from_due_and_counts_failures():
    """One client against a service that stalls 0.2 s on request 0: the
    requests due meanwhile are sent late, and their latency counts the
    wait; a shed request counts at the timeout."""
    calls = []
    lock = threading.Lock()

    def caption(image, timeout):
        with lock:
            calls.append(int(image))
        if int(image) == 0:
            time.sleep(0.2)
        if int(image) == 3:
            return {"error": "overloaded"}
        return {"caption": f"w{int(image)}"}

    due = np.array([0.0, 0.05, 0.1, 0.15, 0.3])
    t0 = time.perf_counter()
    load = OpenLoop(caption, list(range(5)), due, 1, 9.0, t0)
    load.join()
    assert calls == [0, 1, 2, 3, 4]
    assert [a and a["caption"] for a in load.answers] == ["w0", "w1", "w2", None, "w4"]
    assert load.late[1] >= 0.14 and load.late[2] >= 0.09  # sent after request 0 returned
    assert load.latency[1] >= load.late[1] and load.latency[1] >= 0.14
    assert load.latency[3] == 9.0
    assert load.late[4] < 0.05
    assert p95_ms(load.latency) == 9000.0


def test_fill_share_counts_the_window_only():
    before = {"batch_fill_hist": {"32": 2}, "batches": 2}
    after = {"batch_fill_hist": {"32": 3, "16": 2}, "batches": 5}
    assert fill_share(before, after, 32) == pytest.approx((32 + 2 * 16) / (3 * 32))
