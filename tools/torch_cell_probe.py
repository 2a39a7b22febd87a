#!/usr/bin/env python3
"""Time the PyTorch port's bf16 decode cell (kernels 1 and 3) alone on one
NVIDIA card, stage by stage.

    python3 tools/torch_cell_probe.py [--sweep] [--ptxas] [--clocks] [--iters 50]

chip_smoke.py times the cell through its wrapper at the main path's shapes.
This probe calls ``ops/fused_step.py::decode_cell_run`` on preallocated
outputs, bf16, H 512, 2E 512, K = D = 49, at the greedy shape (1,024 rows,
W 1) and the beam-3 shape (3,072 rows, 1,024 images), and prints for each:
the plan (``cell_plan``: images a stage-2 block), the ms of stage 1 alone
(the tensor-core gates), stage 2 alone (the attention) and the whole cell
(CUDA events over back-to-back launches, the L2 flushed before the run),
the SIMT instance's ms at the same shape (the library's entry point
without the tiles), the bound, how many elements of the outputs lie past
chip_smoke.py's bound against the plain twin (0 expected), and the host
time of a call of the wrapper ``decode_cell`` (queued behind a sleep
kernel, so that the host never waits on the card). --sweep times every
plan, each count of images a stage-2 block, and checks each against the
twin. --ptxas first compiles fused_step.cu alone with ``-Xptxas -v`` and
prints what ptxas reports for the cell's kernels (registers, spills,
shared memory); --clocks builds it once more with ``-DCELL_CLOCKS`` and
splits a launch of each shape's plan into the SM cycles a block spends in
stage 1's ring and epilogue and in stage 2's four phases (h'.Wg and s.Ws,
the logits, the softmaxes, alpha.V). Needs a CUDA card and nvcc; imports
no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

H, E2, K, D, IMAGES = 512, 512, 49, 49, 1024
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
# chip_smoke.py's bound, kernel vs twin: bf16 outputs (h, c, c_hat) one
# rounding step, alpha and beta (fp32) at the fp32 bound
TOL_BF16, TOL_F32 = (1e-5, 2.0 ** -7), (1e-5, 1e-5)


def ptxas_report() -> str:
    """ptxas -v for fused_step.cu compiled alone: the cell kernels' lines."""
    from adaptive_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = build.BUILD_DIR / f"probe.{os.getpid()}.o"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                           str(obj), str(build.CSRC / "fused_step.cu")],
                          capture_output=True, text=True)
    obj.unlink(missing_ok=True)
    lines, keep = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            keep = "cell" in line
        if keep or proc.returncode:
            lines.append(line)
    return f"[ptxas fused_step.cu] rc {proc.returncode}\n" + "\n".join(lines)


def clocks_library():
    """fused_step.cu alone, built with -DCELL_CLOCKS: the cell's kernels also
    sum each block's SM cycles a stage and phase into seven counters that
    cell_clocks_read reads and zeroes."""
    from adaptive_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / f"probe_cell_clocks.{os.getpid()}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DCELL_CLOCKS", "-shared",
                           "-o", str(so), str(build.CSRC / "fused_step.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc -DCELL_CLOCKS fused_step.cu failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    so.unlink()
    lib.adaptive_cell_launch.argtypes = build.SIGNATURES["adaptive_cell_launch"]
    lib.cell_clocks_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time every plan")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas -v for the cell kernels")
    ap.add_argument("--clocks", action="store_true", help="SM cycles a block a stage and phase")
    ap.add_argument("--iters", type=int, default=50, help="timed launches a measurement")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cell_probe.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from adaptive_tpu_torch.ops import fused_step as fs
    from adaptive_tpu_torch.ops.cuda import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if args.ptxas:
        print(ptxas_report())
    lib = build.load()
    clib = clocks_library() if args.clocks else None
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def device_ms(fn, iters=args.iters):
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

    def host_us(fn, calls=100):
        """Host time of a call, the calls queued behind a sleep kernel that
        outlasts them (~0.05 s): none waits on the card or on a full queue."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for _ in range(200):  # load clocks before the first timing
        a @ a
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def past_bound(got, ref) -> int:
        n = 0
        for a_, b_ in zip(got, ref):
            atol, rtol = TOL_F32 if a_.dtype == torch.float32 else TOL_BF16
            ga, rb = a_.float(), b_.float()
            n += int(((ga - rb).abs() > atol + rtol * rb.abs()).sum()) + int((~ga.isfinite()).sum())
        return n

    for W in (1, 3):
        R = IMAGES * W
        cell = [r(R, 4 * H)] + [t.to(dt).contiguous() for t in (
            r(R, H, scale=0.5), r(R, H), r(R, E2, scale=0.5), r(R, H, scale=0.5),
            r(IMAGES, K, D), r(IMAGES, K, H).abs(), r(H, 4 * H, scale=H ** -0.5),
            r(4 * H, scale=0.1), r(E2, H, scale=E2 ** -0.5), r(H, H, scale=H ** -0.5),
            r(H, D, scale=H ** -0.5), r(H, D, scale=H ** -0.5), r(D, scale=D ** -0.5))]
        tiles = fs.cell_kernel_tiles(*(cell[i] for i in (7, 9, 10, 11, 12)))
        ref = fs.decode_cell_plain(*cell, beam_w=W)
        outs = sum(t.numel() * t.element_size() for t in ref)
        ins = sum(t.numel() * t.element_size() for t in cell)
        flops = 2.0 * R * (H * 4 * H + E2 * H + H * H + 2 * H * D + K * D + K * H)
        bound = max((ins + outs) / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        default = fs.cell_plan("mma", R, W, sms=sms)
        out = fs.decode_cell_run(*cell, beam_w=W, cell_t=tiles, plan=default)

        def run(plan, stages, o=out):
            return lambda: fs.decode_cell_run(*cell, beam_w=W, cell_t=tiles, plan=plan,
                                              stages=stages, out=o)

        simt_out = [torch.empty_like(t) for t in ref]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = list(map(fs._ptr, (*cell, *simt_out, None, None, None, None, None)))

        def simt():  # the entry point without the tiles: the SIMT kernel at this shape
            assert lib.adaptive_cell_launch(1, *ptrs, R, W, H, E2, K, D, 0, 3, stream) == 0

        simt()
        torch.cuda.synchronize()
        plans = [default]
        if args.sweep:
            plans += [fs.CellPlan(n) for n in (1, 2, 3, 4, 6, 8)
                      if n * W <= fs.CELL_BLOCK_ROWS and fs.CellPlan(n) != default]
        tptr = list(map(fs._ptr, (*cell, *out[:5], *tiles, *out[5:])))
        if clib is not None:
            cyc = (ctypes.c_ulonglong * 7)()
            clib.cell_clocks_read(cyc)
            err = clib.adaptive_cell_launch(1, *tptr, R, W, H, E2, K, D, default.images, 3,
                                            stream)
            torch.cuda.synchronize()
            if err or clib.cell_clocks_read(cyc) or past_bound(out[:5], ref):
                raise RuntimeError(f"W={W}: the clocks build failed or differs from the twin")
            n1 = -(-R // fs.CELL_BAND_ROWS) * (H // fs.CELL_UNITS)
            n2 = -(-IMAGES // default.images)
            print(f"[cell clocks W={W} rows {R}] {default.images} images a stage-2 block, SM cycles a block: stage 1 "
                  f"ring {cyc[0] / n1:.0f}, epilogue {cyc[1] / n1:.0f} ({n1} blocks) | stage 2 "
                  f"pv {cyc[2] / n2:.0f}, h'Wg,sWs {cyc[3] / n2:.0f}, logits {cyc[4] / n2:.0f}, "
                  f"softmax {cyc[5] / n2:.0f}, alpha V {cyc[6] / n2:.0f} ({n2} blocks)")
        simt_ms = device_ms(simt)
        print(f"[cell W={W} rows {R}] simt kernel {simt_ms:.4f} ms ({past_bound(simt_out, ref)} "
              f"elements past the bound) | bound {bound:.4f} ms | the wrapper decode_cell "
              f"{host_us(lambda: fs.decode_cell(*cell, beam_w=W, cell_t=tiles)):.1f} us of host "
              "time a call")
        for plan in plans:
            o = fs.decode_cell_run(*cell, beam_w=W, cell_t=tiles, plan=plan)
            torch.cuda.synchronize()
            bad = past_bound(o[:5], ref)
            s1, s2, both = (device_ms(run(plan, st, o)) for st in (1, 2, 3))
            tag = " (cell_plan)" if plan == default else ""
            print(f"[cell W={W} rows {R}] {plan.images} images a stage-2 block{tag}: stage 1 "
                  f"{s1:.4f} ms, stage 2 {s2:.4f} ms, cell {both:.4f} ms, {bad} elements past "
                  "the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
