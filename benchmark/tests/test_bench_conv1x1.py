"""conv1x1_fprop_roofline's yardstick: kernel 9's launches and bytes in a
ResNet-152 encode at batch 1,024 by hand, and the reader on a recorded
slice (whole encodes, a slice without the kernel)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness import HERE, load_json, load_reader
from benchmark.lib import conv1x1, flops

CONFIG = load_json(HERE / "configs" / "adaptive_attention.json")


def test_an_encode_at_batch_1024_by_hand():
    shapes = conv1x1.launches("resnet152", 224, 1024)
    assert len(shapes) == 100 and sum(r for *_, r in shapes) == 50
    # elements an image: conv1 in 13.25 M, out 3.81 M; conv3 in 3.29 M, residual and out 13.15 M
    per_image = {"x": 0, "y": 0, "r": 0}
    for m, k, n, r in shapes:
        per_image["x"] += m * k / 1024
        per_image["y"] += m * n / 1024
        per_image["r"] += m * n / 1024 * r
    assert per_image["x"] == pytest.approx(13.25e6 + 3.29e6, rel=2e-3)
    assert per_image["y"] == pytest.approx(3.81e6 + 13.15e6, rel=2e-3)
    assert per_image["r"] == pytest.approx(13.15e6, rel=2e-3)
    moved = sum(conv1x1.work(*s)[0] for s in shapes)
    assert moved == pytest.approx(95.5e9, rel=1e-3)
    assert sum(conv1x1.work(*s)[1] for s in shapes) == pytest.approx(10.76e12, rel=1e-3)
    bound, n = conv1x1.encode_bound_s(CONFIG, 1024)
    assert n == 100 and bound == pytest.approx(28.6e-3, rel=1e-3)
    assert bound > moved / flops.HBM_BYTES_PER_S  # layer 4's launches are bound by their products


def _kernel(name, dur_us):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": 0, "dur": dur_us}


def test_the_reader_counts_whole_encodes():
    read = load_reader("conv1x1_fprop_roofline").read
    bound, _ = conv1x1.encode_bound_s(CONFIG, 1024)
    name = "void (anonymous namespace)::conv1x1_fprop_epilogue_kernel<256, 1>(CUtensorMap)"
    # two encodes' launches taking 1.25 times the bound in all, beside other kernels
    each = 2 * bound * 1.25 / 200 * 1e6
    events = [_kernel(name, each) for _ in range(200)] + [_kernel("sm90_xmma_fprop", 1e3)]
    ctx = SimpleNamespace(events=events, config=CONFIG, traffic={"batch": 1024})
    assert read(ctx) == pytest.approx(80.0)
    # the parent's program: no kernel 9 in the slice, so no metric
    assert read(SimpleNamespace(events=events[200:], config=CONFIG, traffic={"batch": 1024})) \
        is None
    assert read(SimpleNamespace(events=None, config=CONFIG, traffic={"batch": 1024})) is None
