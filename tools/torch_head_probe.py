#!/usr/bin/env python3
"""Time the PyTorch port's two vocab-head kernels alone on one NVIDIA card.

    python3 tools/torch_head_probe.py [--beam 3]

chip_smoke.py times the heads through their wrappers at the main path's
shapes. This probe calls the library's C entry points directly on
preallocated scratch, bf16, H 512, vocab 10,123 (padded 10,240), at 1,024
and 3,072 rows, so that a kernel's device time can be split into a cost a
ring step (one 128 x 64 weight tile through both warpgroups) and a fixed
cost (launch, z prologue, ring fill, second pass), and set beside the
wrapper's host time a call. Prints one line a row count and the split.
Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

H, VOCAB, VP = 512, 10123, 10240


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--beam", type=int, default=3, help="W of the top-W head")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_head_probe.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from adaptive_tpu_torch.ops import fused_step as fs
    from adaptive_tpu_torch.ops.cuda import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib = build.load()
    W = args.beam
    ptr = fs._ptr
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def device_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(3 * iters):  # the host queues every launch meanwhile
            flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_us(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for _ in range(200):  # load clocks before the first timing
        a @ a
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    w = (torch.randn(H, VP, generator=g, device="cuda") * (2.0 / H) ** 0.5).to(dt)
    bias = torch.randn(VP, generator=g, device="cuda") * 0.1
    bias[VOCAB:] = fs.NEG
    bias = bias.to(dt)
    tiles = fs.head_kernel_tiles(w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for rows in (1024, 3072):
        chat, h = (torch.randn(rows, H, generator=g, device="cuda").to(dt) for _ in range(2))
        p2, p4 = fs.head_plan("mma", rows, VP, sms=sms), fs.head_plan("mma", rows, VP, W, sms=sms)
        f32, i32 = dict(dtype=torch.float32, device="cuda"), dict(dtype=torch.int32, device="cuda")
        s2 = (torch.empty(rows, p2.nsplit, **f32), torch.empty(rows, p2.nsplit, **i32),
              torch.empty(rows, **i32))
        s4 = (torch.empty(rows, p4.nsplit, W, **f32), torch.empty(rows, p4.nsplit, W, **i32),
              torch.empty(rows, p4.nsplit, 2, **f32), torch.empty(rows, W, **f32),
              torch.empty(rows, W, **i32), torch.empty(rows, 1, **f32))

        def raw2():
            return lib.head_argmax_launch(1, *map(ptr, (chat, h, w, tiles, bias, *s2)), rows, H,
                                          VP, VOCAB, p2.nsplit, p2.tiles_per_split, stream)

        def raw4():
            return lib.head_topk_launch(1, *map(ptr, (chat, h, w, tiles, bias, *s4)), rows, H, VP,
                                        VOCAB, W, p4.nsplit, p4.tiles_per_split, p4.band_rows,
                                        stream)

        assert raw2() == 0 and raw4() == 0
        steps = p2.tiles_per_split * (H // fs.HEAD_TILE_K)
        res[rows] = (steps, device_ms(raw2), device_ms(raw4))
        print(f"rows {rows}: {p2}, {steps} ring steps a block | argmax kernel {res[rows][1]:.4f} ms, "
              f"wrapper host {host_us(lambda: fs.greedy_head_argmax(w, bias, chat, h, VOCAB, tiles)):.1f}"
              f" us | top-{W} kernel {res[rows][2]:.4f} ms, wrapper host "
              f"{host_us(lambda: fs.beam_head_topk(w, bias, chat, h, VOCAB, W, tiles)):.1f} us")
    (s_a, a2, a4), (s_b, b2, b4) = res[1024], res[3072]
    for name, lo, hi in (("argmax", a2, b2), (f"top-{W}", a4, b4)):
        slope = (hi - lo) / (s_b - s_a)
        print(f"{name}: {slope * 1e3:.3f} us a ring step, fixed {(lo - s_a * slope) * 1e3:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
