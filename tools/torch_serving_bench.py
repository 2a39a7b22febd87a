#!/usr/bin/env python3
"""Serving benchmark of the PyTorch port on one NVIDIA card: CaptionService
p50/p90/p99 latency against offered load (twin of tools/serving_bench.py).

Drives adaptive_tpu_torch.serving.CaptionService with Poisson open-loop
client traffic at a sweep of offered rates and reports per level the
latency percentiles, shed and other errors, goodput, and at the end the
batch-fill and latency histograms. The model is configs' flagship at full
width (ResNet-152 at 224, embed 256, hidden 512, 30 steps, bf16) with a
vocabulary of 10,123 filler words padded to 10,240, random weights drawn
from the config's seed. ``device_decode_ms`` is one batch's decode on
images already on the card, timed with utils/profiling.py::Timer (mean of
5 after a warm-up): the card's ceiling is batch / device_decode_ms.

    python3 tools/torch_serving_bench.py [--batch 32] [--qps 8,16,32,64]
        [--duration 20] [--quant int8] [--beam 1]

Needs a CUDA card and nvcc; imports no JAX. The last line is one JSON
object (metric "serving_sweep"), as the JAX tool prints.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def percentile(xs, p):
    """None (JSON null) when the level completed no request."""
    if not xs:
        return None
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return round(xs[k], 1)


def build_service(args):
    """(service, cf, warm-up s, device_decode_ms) at the flagship widths.
    device_decode_ms is timed with a decoder of the caller's thread, on the
    service's model and weights: the service's own decoder belongs to its
    worker."""
    import torch

    from adaptive_tpu_torch.config import load_config
    from adaptive_tpu_torch.data.vocab import Vocabulary
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.serving import CaptionService
    from adaptive_tpu_torch.utils.profiling import Timer

    words = ["<pad>", "<start>", "<end>", "<unk>"] + [f"w{i}" for i in range(10119)]
    vocab = Vocabulary(words)
    cf = load_config(
        None, atten_model_name="adaptive_attention", encoder_backbone=args.backbone,
        vocab_length=len(vocab), compute_dtype="bfloat16", eval_batch_size=args.batch,
        beam_size=args.beam, encoder_quant=args.quant)
    rng = np.random.default_rng(0)
    S = cf.resized_image_size
    calib = rng.integers(0, 255, (32, S, S, 3), np.uint8) if args.quant == "int8" else None
    svc = CaptionService(cf, vocab, batch_size=args.batch, max_wait_ms=args.max_wait_ms,
                         calibration_images=calib, early_exit=args.early_exit == "on",
                         scan_prefix=args.scan_prefix)
    t0 = time.monotonic()
    svc.warmup()
    warm_s = time.monotonic() - t0
    decode = (make_beam_decoder(svc.model, svc.cf) if args.beam > 1
              else make_greedy_decoder(svc.model, svc.cf))
    img = torch.as_tensor(rng.integers(0, 255, (args.batch, S, S, 3), np.uint8), device="cuda")
    decode(svc.net, img)  # prepares the weights, warms this shape
    timer = Timer()
    for _ in range(5):
        with timer.measure():
            decode(svc.net, img)
    return svc, cf, warm_s, timer.mean() * 1e3


def run_level(svc, size, qps, duration_s, seed=0):
    """Open-loop Poisson arrivals at qps for duration_s; returns stats."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (size, size, 3), np.uint8)
    lat_ms, outcomes = [], []
    lock = threading.Lock()
    threads = []

    def one_request():
        t0 = time.monotonic()
        r = svc.caption(img, timeout=30.0)
        dt = (time.monotonic() - t0) * 1e3
        with lock:
            outcomes.append(r.get("error", "ok"))
            if "error" not in r:
                lat_ms.append(dt)

    t_end = time.monotonic() + duration_s
    next_t = time.monotonic()
    n_sent = 0
    while time.monotonic() < t_end:
        next_t += rng.exponential(1.0 / qps)
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=one_request, daemon=True)
        t.start()
        threads.append(t)
        n_sent += 1
    for t in threads:
        t.join(timeout=45.0)
    ok = sum(1 for o in outcomes if o == "ok")
    shed = sum(1 for o in outcomes if o == "overloaded")
    return {
        "offered_qps": qps,
        "sent": n_sent,
        "completed": ok,
        "shed": shed,
        "other_errors": len(outcomes) - ok - shed,
        "goodput_qps": round(ok / duration_s, 2),
        "p50_ms": percentile(lat_ms, 50),
        "p90_ms": percentile(lat_ms, 90),
        "p99_ms": percentile(lat_ms, 99),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--backbone", default="resnet152")
    p.add_argument("--quant", default="int8", choices=["none", "int8"])
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--max-wait-ms", type=float, default=20.0)
    p.add_argument("--early-exit", default="off", choices=["on", "off"],
                   help="decode_early_exit: stop once every row has emitted <end>")
    p.add_argument("--scan-prefix", type=int, default=0,
                   help="decode_scan_prefix: accepted, changes nothing in the port")
    p.add_argument("--qps", default="8,16,32,64")
    p.add_argument("--duration", type=float, default=20.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_bench.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    svc, cf, warm_s, device_ms = build_service(args)
    print(f"warmup (kernel build, weight prep, first decode): {warm_s:.1f}s; device-only decode "
          f"{device_ms:.1f} ms/batch-{args.batch} "
          f"({args.batch / device_ms * 1e3:.0f} captions/s device ceiling)", flush=True)
    levels = []
    try:
        for qps in [float(q) for q in args.qps.split(",")]:
            lv = run_level(svc, cf.resized_image_size, qps, args.duration)
            print(json.dumps(lv), flush=True)
            levels.append(lv)
        stats = svc.stats()
    finally:
        svc.close()
    print(json.dumps({
        "metric": "serving_sweep",
        "batch": args.batch,
        "quant": args.quant,
        "beam": args.beam,
        "max_wait_ms": args.max_wait_ms,
        "device_decode_ms": round(device_ms, 1),
        "levels": levels,
        "batch_fill_hist": stats["batch_fill_hist"],
        "latency_ms_hist": stats["latency_ms_hist"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
