#!/usr/bin/env python3
"""Time the PyTorch port's fused int8 kernels (kernel 5, the bottleneck
block; kernel 6, the tail + next conv1) alone on one NVIDIA card.

    python3 tools/torch_int8_probe.py [--kernels 56] [--layers 1234] [--sweep] [--ptxas]
                                      [--clocks] [--wrapper]

chip_smoke.py times both kernels through their wrappers beside the twins and
the unfused carry. This probe calls the library's C entry points
``bottleneck_block_launch`` and ``tail_conv1_launch`` directly on
preallocated tensors at ResNet-152's shapes at batch 1,024 (kernel 5 at the
four identity-block shapes; kernel 6 at the seven boundary shapes a decode
launches, M2 = M within a layer and M2 = 2M into the next layer's block 0),
so that host time is left out. For each shape it checks the output against
the plain twin (torch.equal), and prints ms a launch (CUDA events over
back-to-back launches), the bound, the launch plan
(``ops/fused_block.py::block_plan``, ``ops/fused_tail.py::tail_plan``) and
the weight bytes that the plan draws from L2 (computed from the plan, not
measured), with the L2 rate that those bytes would take at the measured
time. --sweep also times other plans (kernel 5: rows or images a block;
kernel 6: rows a block; both with every column and K chunk); --ptxas first
compiles fused_block.cu and fused_tail.cu alone with ``-Xptxas -v`` and
prints what ptxas reports (registers, spills, shared memory); --clocks
builds each once more with ``-DFUSED_BLOCK_CLOCKS`` and splits one launch
into the SM cycles a block spends in each stage and in the epilogues.
--wrapper times kernel 6 through ``tail_conv1_int8`` instead, with no plan:
that call is the same in earlier trees, so the probe can time an earlier
kernel 6 at the same shapes. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

B = 1024
# (H = W, C, M, launches a decode): ResNet-152's identity blocks by layer
LAYERS = ((56, 256, 64, 2), (28, 512, 128, 7), (14, 1024, 256, 35), (7, 2048, 512, 1))
# kernel 6's boundaries (H = W, C, M, M2, launches a decode): within a layer
# and, from its last identity block, into the next layer's block 0 (M2 = 2M)
TAILS = ((56, 256, 64, 64, 1), (56, 256, 64, 128, 1), (28, 512, 128, 128, 6),
         (28, 512, 128, 256, 1), (14, 1024, 256, 256, 34), (14, 1024, 256, 512, 1),
         (7, 2048, 512, 512, 1))
SCALES = (0.034, 0.057, 0.021, 0.026)  # s2, s3, s_in, s_out
TAIL_SCALES = (0.024, 0.027, 0.042)  # s_in, s_out, s_next
HBM_RATE, INT8_RATE = 3.35e12, 1.979e15  # an H100 SXM's bytes/s and int8 operations/s


def bound_ms(H, C, M) -> float:
    """The least time of a kernel-5 launch on an H100 SXM: the carry's bytes
    (x read, out written) or the int8 operations, whichever is longer."""
    N = B * H * H
    return 1e3 * max(2 * N * C / HBM_RATE, 2.0 * N * (2 * C * M + 9 * M * M) / INT8_RATE)


def tail_bound_ms(H, C, M, M2) -> float:
    """The same for kernel 6: x and z2 read, out and z1 written, or its
    2 N C (M + M2) operations."""
    N = B * H * H
    return 1e3 * max(N * (2 * C + M + M2) / HBM_RATE, 2.0 * N * C * (M + M2) / INT8_RATE)


def weight_bytes(fb, plan, H, C, M) -> int:
    """Weight bytes a kernel-5 launch draws from L2 under plan: each block
    copies w1 once a pass of its stage-1 rows, w2 and w3 once a pass of its
    output rows (a bound: a short last band or group may take fewer passes)."""
    p1, p2 = fb._plan_rows(H, H, plan.rows, plan.images)
    npass = lambda p: -(-p // fb.RING_PASS[plan.nt])  # noqa: E731
    return plan.blocks * (M * C * npass(p1) + (9 * M * M + C * M) * npass(p2))


def tail_weight_bytes(fb, plan, C, M, M2) -> int:
    """The same for kernel 6: w3 and w1 once a pass of a block's rows."""
    return plan.blocks * C * (M + M2) * -(-plan.rows // fb.RING_PASS[plan.nt])


def ptxas_report() -> str:
    """ptxas -v for fused_block.cu and fused_tail.cu, each compiled alone."""
    from adaptive_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = []
    for name in ("fused_block.cu", "fused_tail.cu"):
        obj = build.BUILD_DIR / f"probe.{os.getpid()}.o"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               str(obj), str(build.CSRC / name)], capture_output=True, text=True)
        obj.unlink(missing_ok=True)
        out.append(f"[ptxas {name}] rc {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return "".join(out)


def clocks_library(source: str, launch: str, clocks: str):
    """source alone, built with -DFUSED_BLOCK_CLOCKS: the kernel also sums
    each block's SM cycles a stage (and in its epilogues) into four counters
    that the clocks function reads and zeroes."""
    from adaptive_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / f"probe_clocks.{os.getpid()}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DFUSED_BLOCK_CLOCKS", "-shared",
                           "-o", str(so), str(build.CSRC / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc -DFUSED_BLOCK_CLOCKS {source} failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    so.unlink()
    getattr(lib, launch).argtypes = build.SIGNATURES[launch]
    getattr(lib, clocks).argtypes = [ctypes.c_void_p]
    return lib


def sweep_plans(fb, H, C, M):
    """block_plan's plan, then the cuts around it (three cuts of fewer and
    more rows or images a block) and the largest cut that fits one block an
    SM, each with every column chunk and K chunk whose shared bytes fit."""
    base = fb.block_plan(B, H, H, C, M)
    cuts = list(fb._candidates(B, H))[: 4 * H + 8]
    i = cuts.index((base.rows, base.images))
    pick = cuts[max(0, i - 3): i + 4]
    one = [c for c in cuts if fb.block_smem(H, H, M, *c, 64, 64) <= fb.MAX_SMEM]
    if one and one[-1] not in pick:
        pick.append(one[-1])
    out = [base]
    for R, G in pick:
        for nt in (64, 128):
            for kt in (128, 64):
                p = fb.make_plan(B, H, H, C, M, R, G, nt, kt)
                if kt + 16 >= nt and p.smem <= fb.MAX_SMEM and p not in out:
                    out.append(p)
    return out


def tail_sweep(fb, ft, N, C, M, M2):
    """tail_plan's plan, then rows a block from 16 to the most that fit
    (every 16 up to 128, every 32 above), each with every column chunk and K
    chunk whose shared bytes fit."""
    out = [ft.tail_plan(N, C, M, M2)]
    rows = 16
    while ft.tail_smem(C, M, rows, 64, 64) <= fb.MAX_SMEM:
        for nt in (64, 128):
            for kt in (128, 64):
                p = ft.make_tail_plan(N, C, M, M2, rows, nt, kt)
                if kt + 16 >= nt and p.smem <= fb.MAX_SMEM and p not in out:
                    out.append(p)
        rows += 16 if rows < 128 else 32
    return out


def brief(p) -> str:
    cut = f"rows {p.rows} images {p.images}" if hasattr(p, "images") else f"rows {p.rows}"
    return (f"{cut} nt {p.nt} kt {p.kt} smem {p.smem} ({p.sms} blocks an SM) blocks "
            f"{p.blocks}")


def device_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe_block(args, lib, stream, s8, rows):
    """Kernel 5 at the layers asked for; returns {layer: (launches, ms, bound)}."""
    import torch

    from adaptive_tpu_torch.ops import fused_block as fb

    clib = (clocks_library("fused_block.cu", "bottleneck_block_launch", "fused_block_clocks")
            if args.clocks else None)
    total = {}
    for li, (H, C, M, n) in enumerate(LAYERS, 1):
        if str(li) not in args.layers:
            continue
        N = B * H * H
        x, w1, w2, w3 = s8(N, C), s8(M, C), s8(M, 9 * M), s8(C, M)
        r = (*rows(M, C), *rows(M, 9 * M), *rows(C, M))
        out = torch.empty_like(x)
        want = fb.bottleneck_identity_int8_plain(x, H, H, w1, w2, w3, *r, *SCALES)
        bound = bound_ms(H, C, M)
        plans = sweep_plans(fb, H, C, M) if args.sweep else [fb.block_plan(B, H, H, C, M)]
        for k, p in enumerate(plans):
            def raw(lib=lib, p=p):
                return lib.bottleneck_block_launch(
                    *map(fb._ptr, (x, w1, w2, w3, *r, out)), *map(ctypes.c_float, SCALES),
                    B, H, H, C, M, p.rows, p.images, p.nt, p.kt, p.smem, p.vec, stream)

            out.zero_()
            err = raw()
            torch.cuda.synchronize()
            differ = int((out != want).sum()) if err == 0 else -1
            ms = device_ms(raw, args.iters) if err == 0 and differ == 0 else float("nan")
            l2 = weight_bytes(fb, p, H, C, M)
            if k == 0:
                total[li] = (n, ms, bound)
                print(f"[int8 probe layer{li}] H=W {H} C {C} M {M}: {brief(p)} | err {err}, "
                      f"{differ} of {out.numel()} elements differ from the twin | kernel {ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({ms / bound:.1f}x) | weights from L2 {l2 / 1e9:.3f} GB "
                      f"(planned), {l2 / (ms * 1e-3) / 1e12:.2f} TB/s at this time; {n} launches "
                      f"a decode", flush=True)
            else:
                print(f"[int8 probe layer{li} alt] {brief(p)}: err {err} differ {differ} | "
                      f"{ms:.4f} ms ({ms / bound:.1f}x) | L2 {l2 / 1e9:.3f} GB | model "
                      f"{fb.plan_cost(p, H, H, C, M) / 1e9:.1f}", flush=True)
        if clib is not None:
            p = plans[0]
            cyc = (ctypes.c_ulonglong * 4)()
            clib.fused_block_clocks(cyc)
            err = raw(clib, p)
            torch.cuda.synchronize()
            if err or clib.fused_block_clocks(cyc) or not torch.equal(out, want):
                raise RuntimeError(f"layer{li}: the clocks build failed or differs from the twin")
            per = [c / p.blocks for c in cyc]
            print(f"[int8 probe clocks layer{li}] SM cycles a block: stage 1 {per[0]:.0f}, stage 2 "
                  f"{per[1]:.0f}, stage 3 {per[2]:.0f} (epilogues {per[3]:.0f}); "
                  f"{p.blocks} blocks", flush=True)
        del x, w1, w2, w3, r, out, want
        torch.cuda.empty_cache()
    return total


def probe_tail(args, lib, stream, s8, rows):
    """Kernel 6 at the boundaries of the layers asked for; returns
    {(layer, M2): (launches, ms, bound)}."""
    import torch

    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_tail as ft

    clib = (clocks_library("fused_tail.cu", "tail_conv1_launch", "fused_tail_clocks")
            if args.clocks else None)
    total = {}
    for H, C, M, M2, n in TAILS:
        li = [l[0] for l in LAYERS].index(H) + 1
        if str(li) not in args.layers:
            continue
        N = B * H * H
        x, z2, w3, w1 = s8(N, C), s8(N, M), s8(C, M), s8(M2, C)
        r3, r1 = rows(C, M), rows(M2, C)
        a6 = (x, z2, w3, *r3, w1, *r1, *TAIL_SCALES)
        out, z1 = torch.empty_like(x), torch.empty((N, M2), dtype=torch.int8, device="cuda")
        want, want_z1 = ft.tail_conv1_int8_plain(*a6)
        bound = tail_bound_ms(H, C, M, M2)
        where = f"layer{li} M2 {M2}"
        if args.wrapper:
            got, got_z1 = ft.tail_conv1_int8(*a6)
            torch.cuda.synchronize()
            differ = int((got != want).sum() + (got_z1 != want_z1).sum())
            ms = device_ms(lambda: ft.tail_conv1_int8(*a6), args.iters) if differ == 0 else float("nan")
            total[(li, M2)] = (n, ms, bound)
            print(f"[int8 probe tail {where}] wrapper: {differ} elements differ from the twin | "
                  f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({ms / bound:.1f}x); {n} launches "
                  f"a decode", flush=True)
            del x, z2, w3, w1, a6, out, z1, want, want_z1, got, got_z1
            torch.cuda.empty_cache()
            continue
        plans = tail_sweep(fb, ft, N, C, M, M2) if args.sweep else [ft.tail_plan(N, C, M, M2)]
        for k, p in enumerate(plans):
            def raw(lib=lib, p=p):
                return lib.tail_conv1_launch(
                    *map(ft._ptr, (x, z2, w3, *r3, w1, *r1, out, z1)),
                    *map(ctypes.c_float, TAIL_SCALES), N, C, M, M2, p.rows, p.nt, p.kt, p.smem,
                    p.vec, stream)

            out.zero_()
            z1.zero_()
            err = raw()
            torch.cuda.synchronize()
            differ = int((out != want).sum() + (z1 != want_z1).sum()) if err == 0 else -1
            ms = device_ms(raw, args.iters) if err == 0 and differ == 0 else float("nan")
            l2 = tail_weight_bytes(fb, p, C, M, M2)
            if k == 0:
                total[(li, M2)] = (n, ms, bound)
                print(f"[int8 probe tail {where}] N {N} C {C} M {M}: {brief(p)} | err {err}, "
                      f"{differ} of {out.numel() + z1.numel()} elements differ from the twin | "
                      f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({ms / bound:.1f}x) | weights "
                      f"from L2 {l2 / 1e9:.3f} GB (planned), {l2 / (ms * 1e-3) / 1e12:.2f} TB/s "
                      f"at this time; {n} launches a decode", flush=True)
            else:
                print(f"[int8 probe tail {where} alt] {brief(p)}: err {err} differ {differ} | "
                      f"{ms:.4f} ms ({ms / bound:.1f}x) | L2 {l2 / 1e9:.3f} GB | model "
                      f"{ft.tail_cost(p, C, M, M2) / 1e9:.1f}", flush=True)
        if clib is not None:
            p = plans[0]
            cyc = (ctypes.c_ulonglong * 4)()
            clib.fused_tail_clocks(cyc)
            err = raw(clib, p)
            torch.cuda.synchronize()
            if (err or clib.fused_tail_clocks(cyc) or not torch.equal(out, want)
                    or not torch.equal(z1, want_z1)):
                raise RuntimeError(f"{where}: the clocks build failed or differs from the twin")
            per = [c / p.blocks for c in cyc]
            print(f"[int8 probe tail clocks {where}] SM cycles a block: stage 1 {per[0]:.0f}, "
                  f"stage 2 {per[1]:.0f} (epilogues {per[3]:.0f}); {p.blocks} blocks", flush=True)
        del x, z2, w3, w1, a6, out, z1, want, want_z1
        torch.cuda.empty_cache()
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="56", help="which of kernels 5 and 6 to run")
    ap.add_argument("--layers", default="1234", help="which of layers 1-4 to run")
    ap.add_argument("--sweep", action="store_true", help="also time other plans")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas -v for fused_block.cu and fused_tail.cu")
    ap.add_argument("--clocks", action="store_true",
                    help="also split the plan's launch into SM cycles a stage (a second build)")
    ap.add_argument("--wrapper", action="store_true",
                    help="time kernel 6 through tail_conv1_int8, with no plan (any tree)")
    ap.add_argument("--iters", type=int, default=20, help="timed launches a plan")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_probe.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from adaptive_tpu_torch.ops.cuda import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.ptxas:
        print(ptxas_report(), flush=True)
    lib = build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda").manual_seed(0)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    def rows(n, k):  # acc * sc + b at O(1), as chip_smoke.py's
        sc = (torch.rand(n, generator=g, device="cuda") + 0.5) * (3.0 / (127 ** 2 * k ** 0.5))
        return sc, torch.randn(n, generator=g, device="cuda") * 0.3

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for _ in range(200):  # load clocks before the first timing
        a @ a
    del a
    for kernel, probe, want in (("5", probe_block, len(LAYERS)), ("6", probe_tail, len(TAILS))):
        if kernel not in args.kernels:
            continue
        total = probe(args, lib, stream, s8, rows)
        if len(total) == want:
            ms = sum(n * t for n, t, _ in total.values())
            bd = sum(n * b for n, _, b in total.values())
            print(f"[int8 probe decode] kernel {kernel} launch-weighted: {ms:.3f} ms a decode, "
                  f"bound {bd:.3f} ms ({ms / bd:.1f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
