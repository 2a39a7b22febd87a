"""What the per-layer readers share: stage times from the traced slice,
the device's idle share, the share of the bf16 peak, and the CUDA-event
times of a decode and of its encoder alone."""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.lib import flops

REPEATS = 5


def stage_ms(ctx, *stages: str) -> Optional[float]:
    """Device ms an iteration of the traced slice in the named stages."""
    if not ctx.events or not ctx.slice.get("iters") or not ctx.split()["busy_s"]:
        return None
    sp = ctx.split()
    return 1e3 * sum(sp[s] for s in stages) / ctx.slice["iters"]


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the card."""
    if not ctx.events or not ctx.split()["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx.split()["busy_share"])


def window_idle_share(ctx) -> Optional[float]:
    """Percent of the window's seconds in which the card was idle, its busy
    seconds taken from the traced slice: the slice's device-busy seconds a
    model FLOP times the window's FLOPs. The slice runs under the profiler,
    whose cost on the host lengthens its own wall seconds; the window's
    seconds carry none of it."""
    if not ctx.events or not ctx.slice.get("flops") or not ctx.work.get("s"):
        return None
    busy = ctx.split()["busy_s"] * ctx.work["flops"] / ctx.slice["flops"]
    return 100.0 * (1.0 - busy / ctx.work["s"])


def peak_share(ctx) -> Optional[float]:
    """Percent of the bf16 peak: the window's model FLOPs over its seconds."""
    if not ctx.work.get("flops") or not ctx.work.get("s"):
        return None
    return 100.0 * ctx.work["flops"] / ctx.work["s"] / flops.PEAK_BF16


def roofline(ctx, names, work) -> Optional[float]:
    """Percent of a hand kernel's roofline: its bound over its device
    seconds a launch in the traced slice; work: (bytes, FLOPs) a launch."""
    from benchmark.lib.trace import kernel_stats

    if not ctx.events:
        return None
    total, launches = kernel_stats(ctx.events, names)
    if not launches:
        return None
    return 100.0 * flops.bound_s(*work) / (total / launches)


def decode_times(ctx) -> Optional[Dict[str, float]]:
    """{"batch_ms", "encoder_ms"}: CUDA events around REPEATS decodes of one
    batch already on the card, and around REPEATS of its encoder alone:
    encode_inference(prepare(net), eval_preprocess(images))."""
    import torch

    h = ctx.handles
    if "decode" not in h or ctx.device == "cpu":
        return None
    if "decode_times" in ctx.memo:
        return ctx.memo["decode_times"]
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    model, net, decode, cf, images = h["model"], h["net"], h["decode"], h["cf"], h["images"]

    def timed(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPEATS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPEATS

    with torch.no_grad():
        batch = timed(lambda: decode(net, images))
        enc = timed(lambda: model.encode_inference(decode.prepare(net), eval_preprocess(
            images, cf.train_crop_size, model.compute_dtype)))
    ctx.memo["decode_times"] = {"batch_ms": batch, "encoder_ms": enc}
    return ctx.memo["decode_times"]
