#!/usr/bin/env python3
"""Drive the PyTorch port (adaptive_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Builds the port's CUDA kernels from adaptive_tpu_torch/ops/cuda/csrc, then:

1. prints the card (nvidia-smi name and power limit), torch/CUDA versions
   and the kernel build time;
2. holds the greedy kernels (the cell, the argmax head) against their plain
   PyTorch twins at the greedy path's shapes (batch 1024, H 512, 2E 512,
   K = D = 49, vocab 10123 padded to 10240), in fp32 and bf16, and times
   kernel, twin and library call; the cell names its instance and plan
   (ops/fused_step.py::cell_instance, cell_plan) and, for the bf16
   tensor-core instance, times each of its two stages alone; the head and
   its library call twice:
   launches back to back (the 10.5 MB weight warm in the 50 MB L2) and
   each launch after a 256 MB write (L2 cold, as after the cell kernel);
2b. does the same for the beam kernels (the beam-major cell, the top-W
   head) at the beam path's shapes: 1024 images x beam 3 = 3072 rows, V/pv
   one copy per image; plus a correctness-only pass at beam 5;
2c. holds the int8 encoder's kernels (the fused identity bottleneck block,
   the fused tail + next conv1) against their twins and against the int8
   carry's own unfused code at batch 1024 (seeded s8 inputs): kernel 5 at
   ResNet-152's four bottleneck layer shapes, kernel 6 at the seven shapes
   a decode launches it at (within a layer, and into the next layer's
   block 0 with twice the width); times kernel, twin and unfused segment
   beside the bound, with each kernel's launch plan (rows or images a
   block, chunks, shared bytes, blocks an SM); plus a correctness-only pass
   of each at 3 images of 13 x 13;
3. runs the greedy path end to end in bf16 at full width: build_model ->
   make_greedy_decoder -> greedy captions for 1024 seeded uint8 256x256
   images with a seeded random ResNet-152 / H 512 model; checks that each
   kernel launched exactly once per decode step and that the outputs are
   well formed, and times the decode and the encoder alone (mean of
   E2E_REPEATS runs); --profile adds a torch.profiler kernel table;
3b. runs beam search (beam 3) end to end on the same model and images:
   make_beam_decoder; checks that the beam kernels launched once per step
   and the greedy ones not at all, that ids, scores, attention and beta are
   well formed, and times it as phase 3 does (--profile: a second table);
5. runs the int8 encoder end to end in bf16 on the same model and images:
   build_model(encoder_quant="int8") -> calibrate_model (32 images) ->
   make_greedy_decoder, in mode (a) per-channel scales, s2d stem, no fused
   kernels (the bench's default); (b) per-tensor scales with every
   layer's identity blocks through the fused block kernel (45 launches a
   decode); (c) per-tensor scales with every layer's tails through the
   fused tail kernel (45 launches); and (t) per-tensor scales without
   kernels, the control against which (b)'s and (c)'s features are held;
   each timed as phase 3 (--profile: a table for mode (a));
4. decodes 8 images greedily in fp32 (TF32 off) on the card and on the CPU
   (plain twins) and requires equal ids, except where the first differing
   step's fp32 top-2 logit gap is below 1e-3, and attention and beta within
   PARITY_ATOL up to that step;
4b. beam-decodes the same 8 images (beam 3) on both and requires equal
   beams, except for an image whose CPU decode had two adjacent flat
   candidates (of the top W+1) within PARITY_GAP_EPS at some step; scores
   within 1e-3 and attention and beta within PARITY_ATOL where equal;
6. runs the int8 encoder in fp32 on 8 seeded images at the crop size on
   the card and on the CPU, in modes (a) and (c) with the card's scales
   handed to both: trunk features within phase 5's bound (0 elements should
   differ), greedy ids under phase 4's rule.

7. runs the eval driver (evalcap/coco_eval.py::coco_eval) in bf16 on phase
   3's model over a 5,000-image synthetic split (5 reference captions an
   image; the images seeded_images at 256 px, served from memory through
   coco_eval's dataset=) at eval batch 400: greedy, beam 3 and int8 (a)
   calibrated inside the driver. Checks the launches (13 batches x 30
   steps of kernels 1 and 2, or 3 and 4) and the results (one an image),
   and prints images/s with the wall time split into decode, results JSON,
   annotation loads and each scorer;
7b. runs coco_eval in fp32 (TF32 off) on a 16-image split at batch 12 on
   the card and on the CPU (phase 4's models), greedy and beam 3: equal
   results, CIDEr and per-image scores, a differing caption only under the
   gap rules of phases 4 and 4b; then valid mode on the card from a
   model.npz of the same weights ("auto"), equal to the in-memory run.

8. trains (training/): 8a make_train_step at full width in bf16, batch
   256, captions in bucket 24, with the encoder off and on (fine-tuning
   layers 2-4): images/s (mean of 10 steps after 2), forward, backward and
   optimizer ms of an instrumented step (CUDA events), peak allocated
   memory, the step's convolution and matmul TFLOP (FlopCounterMode) and
   their share of the bf16 peak, finite losses (--profile: a table each);
   8b main_train end to end in bf16 on a 1,024-image split in memory, 2
   epochs (encoder on in the second), a step checkpoint every 2 steps, the
   per-epoch eval on 400-image train_eval and val splits in memory:
   launches of kernels 1 and 2 (2 epochs x 2 evals x 30 steps), the epoch
   checkpoints (the step ones pruned), valid mode "auto" restoring the best
   one and writing its epoch's captions; 8c one fp32 step (TF32 off), encoder
   off and on, card vs CPU from phase 4's weights at batch 4: loss, LSTM
   grad norm, BN statistics and weights within their bounds.

Phases run in the order 1, 2, 2b, 3, 3b, 2c, 5, 4, 4b, 6, 7, 7b, 8a, 8b, 8c.

Prints one JSON line of per-kernel numbers, one of the eval driver's
numbers ({"eval_driver": ...}), one of training's ({"train": ...}), then as
its last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Exits 2 without a result where
there is no CUDA card or the package is not beside this script.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path shapes: adaptive_attention, ResNet-152 at 224 px, embed 256,
# hidden 512, vocab 10123 (head padded to 10240), 30 steps, batch 1024
B, H, E2, K, D, VOCAB, VP, STEPS = 1024, 512, 512, 49, 49, 10123, 10240, 30
BEAM = 3  # beam path: B images x BEAM rows (bench.py --beam 3)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# Tolerances, kernel vs plain twin on the same inputs. fp32: sums in another
# order, |err| <= 1e-5 + 1e-5 |ref|. bf16 outputs (h, c, c_hat): one bf16
# rounding step, |err| <= 1e-5 + 2^-7 |ref|. alpha/beta are fp32 in both.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# head ids may differ only where the row's fp32 top-2 logit gap is below this
HEAD_GAP_EPS = 1e-3
PARITY_GAP_EPS = 1e-3  # phases 4 and 4b: CPU vs card ids
BEAM_SCORE_ATOL = 1e-3  # phase 4b: summed fp32 log-probs over 30 steps
LSE_RTOL = 1e-5  # top-W head's logsumexp, kernel vs twin
# phase 4: attention and beta, card vs CPU in fp32 (the repo's bound for the
# greedy path against the JAX package: sums in another order through the
# 152-layer encoder and 30 steps)
PARITY_ATOL = 2e-4
E2E_REPEATS = 3  # phase 3: timed end-to-end runs after the warm-up
# int8 encoder (phases 2c, 5, 6): ResNet-152's bottleneck layers as (H = W,
# C, M, identity blocks that are not the last block = launches of kernel 5,
# and of kernel 6, in one decode: 2 + 7 + 35 + 1 = 45)
INT8_LAYERS = ((56, 256, 64, 2), (28, 512, 128, 7), (14, 1024, 256, 35), (7, 2048, 512, 1))
# kernel 6's launches by shape (H = W, C, M, M2, launches a decode): within a
# layer (M2 = M) and, from a layer's last identity block, into the next
# layer's block 0 (M2 = 2M; models/infer.py): 1 + 1, 6 + 1, 34 + 1, 1
INT8_TAILS = ((56, 256, 64, 64, 1), (56, 256, 64, 128, 1), (28, 512, 128, 128, 6),
              (28, 512, 128, 256, 1), (14, 1024, 256, 256, 34), (14, 1024, 256, 512, 1),
              (7, 2048, 512, 512, 1))
INT8_FUSED = ("layer1", "layer2", "layer3", "layer4")
INT8_LAUNCHES = sum(n for *_, n in INT8_LAYERS)
INT8_ITERS = 5  # timed launches of each int8 kernel and its twin (ms each)
INT8_CALIB = 32  # images that calibrate_model sees
# kernels 5 and 6 against their twins: +/-1 quantum on under 0.2% of
# elements, the JAX package's bound for its Pallas kernels against XLA
# (tests/test_pallas.py); the port's epilogues are uncontracted, so 0 is
# expected
QUANTUM_SHARE = 2e-3
# phase 7: the eval driver over a split of the Karpathy val/test size, with
# COCO's 5 reference captions an image, at the reference's eval batch
# (cfg_wzn.py:84); phase 7b: a small fp32 split whose last batch is short
EVAL_IMAGES, EVAL_REFS, EVAL_BATCH, EVAL_CHUNK = 5000, 5, 400, 500
EVAL_PARITY_IMAGES, EVAL_PARITY_BATCH = 16, 12
# phase 8: training at the flagship config's batch (configs/coco_adaptive.py:33)
# with captions in bucket 24; main_train on 1,024 images (4 steps an epoch)
# with the eval on 400-image splits (one eval batch each)
TRAIN_B, TRAIN_T, TRAIN_WARMUP, TRAIN_STEPS = 256, 24, 2, 10
TRAIN_IMAGES, TRAIN_EVAL_IMAGES, TRAIN_EPOCHS, TRAIN_PARITY_B = 1024, 400, 2, 4
# phase 8c, card vs CPU in fp32 after one step: loss and LSTM grad norm
# (relative); BN running statistics (relative to max(1, |value|): calibrated
# running variances reach the hundreds); gradients (atol + rtol, the bound
# of tests/test_torch_train_step.py); weights (absolute), except that Adam's
# first update lr * g / (|g| + eps) takes the sign of a gradient that is 0
# within the gradient bound: there up to 2 lr. The gradient bound scales
# with the tensor's largest gradient: a weight gradient sums B*T or B*H*W
# products, so its rounding follows the tensor's scale, not each element's.
# Weights: two fp32 ulps of a value below 8 (the N(0, 1) embedding's reach)
TRAIN_RTOL, TRAIN_BN_TOL, TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL, TRAIN_PARAM_ATOL = (
    1e-4, 1e-5, 1e-5, 1e-4, 2e-6)
# the encoder group's gradients with the encoder on, relative to their norm:
# ten times the CPU's own spread between thread counts (1.03% measured at
# these weights on the build host; train_parity prints the card machine's)
TRAIN_ENC_GRAD_REL = 0.1


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


FLUSH_BYTES = 256 << 20  # five times the 50 MB L2
_flush = []


def flush_l2():
    """Write FLUSH_BYTES on the card: evicts the L2, and keeps the card busy
    for about 0.1 ms while the host queues what follows."""
    import torch

    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    _flush[0].zero_()


def warm_card(seconds=0.5):
    """Keep the card under load for a while, so that the first kernels are
    timed at its load clocks and not while they ramp up from idle."""
    import torch

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches back to back, by CUDA
    events. About 0.3 ms of writes a launch go first, so that the host has
    queued every launch before the card reaches the first: a wrapper's host
    time (up to 0.1 ms on a busy host) would else be measured where its
    kernel is shorter."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3 * iters):
        flush_l2()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_cold_ms(fn, iters=10):
    """Mean device time of one fn() that finds the L2 cold: each launch
    follows a 256 MB write and has its own pair of events."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        for _ in range(3):  # one evicts; three keep the card busy while the host queues fn
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of the inputs' type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = err > atol + rtol * r.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past atol={atol} rtol={rtol}, "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def cell_stages(cell_args, W: int, cell_t):
    """The cell's instance and plan at these operands and, for the mma
    instance, each stage's ms alone (stage 1 the tensor-core gates, stage 2
    the attention), launched through decode_cell_run on the buffers of one
    run; None for the SIMT instance's one kernel."""
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    R, Hh = cell_args[1].shape
    inst = fs.cell_instance(cell_args[1].dtype, Hh, cell_args[3].shape[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fs.cell_plan(inst, R, W, sms=sms)
    if inst != "mma":
        return inst, plan, None
    out = fs.decode_cell_run(*cell_args, beam_w=W, cell_t=cell_t)
    return inst, plan, [cuda_ms(lambda st=st: fs.decode_cell_run(
        *cell_args, beam_w=W, cell_t=cell_t, stages=st, out=out)) for st in (1, 2)]


def stages_text(inst, plan, stage_ms) -> str:
    from adaptive_tpu_torch.ops import fused_step as fs

    if inst != "mma":
        return f"{inst}, {fs.CELL_SIMT_ROWS} rows a block"
    text = (f"{inst}, stage 1 {fs.CELL_BAND_ROWS} rows x {fs.CELL_UNITS} units a block, "
            f"stage 2 {plan.images} images a block")
    if stage_ms:
        text += f", stage 1 {stage_ms[0]:.4f} ms, stage 2 {stage_ms[1]:.4f} ms alone"
    return text


# ----------------------------------------------------------------- phase 2
def kernel_checks(dtype_name: str):
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # cell operands at the decode step's scales: LSTM state ~N(0,1), V >= 0
    gx = r(B, 4 * H)
    cell_args = [gx] + [t.to(dt).contiguous() for t in (
        r(B, H, scale=0.5), r(B, H), r(B, E2, scale=0.5), torch.zeros(B, H, device="cuda"),
        r(B, K, D), r(B, K, H).abs(), r(H, 4 * H, scale=H ** -0.5), r(4 * H, scale=0.1),
        r(E2, H, scale=E2 ** -0.5), r(H, H, scale=H ** -0.5), r(H, D, scale=H ** -0.5),
        r(H, D, scale=H ** -0.5), r(D, scale=D ** -0.5))]
    # the reordered weights that prepare_inference hands the mma instance
    ct = (fs.cell_kernel_tiles(*(cell_args[i] for i in (7, 9, 10, 11, 12)))
          if fs.cell_instance(dt, H, E2) == "mma" else None)
    got = fs.decode_cell(*cell_args, cell_t=ct)
    torch.cuda.synchronize()
    ref = fs.decode_cell_plain(*cell_args)
    atol, rtol = TOL[dtype_name]
    cell_err = 0.0
    for name, a, b in zip(("h", "c", "c_hat", "alpha", "beta"), got, ref):
        tol = TOL["float32"] if a.dtype == torch.float32 else (atol, rtol)
        cell_err = max(cell_err, check_close(f"cell {dtype_name} {name}", a, b, *tol))
    cell_ms = cuda_ms(lambda: fs.decode_cell(*cell_args, cell_t=ct))
    cell_plain_ms = cuda_ms(lambda: fs.decode_cell_plain(*cell_args))
    stages = cell_stages(cell_args, 1, ct)
    outs = nbytes(*got)
    cell_flops = 2.0 * B * (H * 4 * H + E2 * H + H * H + 2 * H * D + K * D + K * H)
    cell_bound = bound(nbytes(*cell_args) + outs, cell_flops, dtype_name)

    # head operands: c_hat, h ~N(0,1); W at the kaiming scale; padded bias -1e30
    W = r(H, VP, scale=(2.0 / H) ** 0.5).to(dt)
    bias = r(VP, scale=0.1)
    bias[VOCAB:] = fs.NEG
    bias = bias.to(dt)
    chat, h = r(B, H).to(dt), r(B, H).to(dt)
    # the tiled weight that prepare_greedy_head hands the bf16 instance
    Wt = fs.head_kernel_tiles(W) if fs.head_instance(dt, H) == "mma" else None

    def head():
        return fs.greedy_head_argmax(W, bias, chat, h, VOCAB, head_kernel_t=Wt)

    ids = head()
    torch.cuda.synchronize()
    ref_ids = fs.greedy_head_argmax_plain(W, bias, chat, h, VOCAB)
    logits = (chat + h).to(dt).float() @ W.float() + bias.float()
    logits[:, VOCAB:] = fs.NEG
    top2 = logits.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    diff = ids != ref_ids
    # the twin's logit shortfall of the kernel's pick: 0 where the ids agree
    head_err = float((logits.gather(1, ref_ids[:, None].long())
                      - logits.gather(1, ids[:, None].long())).abs().max())
    if (diff & (gap >= HEAD_GAP_EPS)).any():
        raise AssertionError(
            f"head {dtype_name}: {int(diff.sum())} ids differ, some at top-2 gap >= {HEAD_GAP_EPS}")
    head_ms, head_cold_ms = cuda_ms(head), cuda_cold_ms(head)
    head_plain_ms = cuda_ms(lambda: fs.greedy_head_argmax_plain(W, bias, chat, h, VOCAB))
    z = (chat + h).to(dt)

    def library():
        return torch.addmm(bias, z, W).argmax(dim=1)

    head_lib_ms, head_lib_cold_ms = cuda_ms(library), cuda_cold_ms(library)
    head_bound = bound(nbytes(W, bias, chat, h) + B * 4, 2.0 * B * H * VP, dtype_name)
    log(f"[kernels {dtype_name}] cell ({stages_text(*stages)}): max_abs_err {cell_err:.3e} "
        f"kernel {cell_ms:.4f} ms plain {cell_plain_ms:.4f} ms bound {cell_bound[0]:.4f} ms "
        f"({cell_bound[1]}) | "
        f"head ({fs.head_instance(dt, H)}): {int(diff.sum())}/{B} ids differ (all at top-2 gap "
        f"< {HEAD_GAP_EPS}), kernel {head_ms:.4f} ms (L2 cold {head_cold_ms:.4f}) plain "
        f"{head_plain_ms:.4f} ms addmm+argmax {head_lib_ms:.4f} ms (L2 cold "
        f"{head_lib_cold_ms:.4f}) bound {head_bound[0]:.4f} ms ({head_bound[1]})")
    return {
        "adaptive_decode_cell_fused": {
            "max_abs_err": cell_err, "ms": cell_ms, "plain_ms": cell_plain_ms,
            "bound_ms": cell_bound[0], "bound_by": cell_bound[1], "library_ms": None,
            "instance": stages[0], "plan": stages[1]._asdict(), "stage_ms": stages[2]},
        "greedy_head_argmax": {
            "max_abs_err": head_err,
            "ids_differ": int(diff.sum()), "ms": head_ms, "cold_ms": head_cold_ms,
            "plain_ms": head_plain_ms, "bound_ms": head_bound[0], "bound_by": head_bound[1],
            "library_ms": head_lib_ms, "library_cold_ms": head_lib_cold_ms},
    }


# ---------------------------------------------------------------- phase 2b
def topk_checks(name, got, ref, logits, W):
    """Top-W head, kernel against twin: ids may differ only where two
    adjacent fp32 logits of the twin's sorted row (top W+1) lie within
    HEAD_GAP_EPS; values on agreeing rows within the fp32 TOL, lse within
    LSE_RTOL. Returns (max abs err of values and lse, rows that differ)."""
    import torch

    tv, ti, lse = got
    rv, ri, rlse = ref
    top = logits.sort(dim=1, descending=True).values[:, :W + 1]
    gaps = top[:, :-1] - top[:, 1:]
    near = gaps < HEAD_GAP_EPS
    near[:, 1:] |= gaps[:, :-1] < HEAD_GAP_EPS
    diff = ti != ri
    if (diff & ~near).any():
        raise AssertionError(f"{name}: top-W ids differ at adjacent logit gaps >= {HEAD_GAP_EPS}")
    same = ~diff.any(1)
    err = check_close(f"{name} topv", tv[same], rv[same], *TOL["float32"])
    return max(err, check_close(f"{name} lse", lse, rlse, 0.0, LSE_RTOL)), int((~same).sum())


def beam_kernel_checks(dtype_name: str, W: int, timed: bool = True):
    """Kernels 3 and 4 against their twins at the beam path's shapes: B
    images x W beam rows, V/pv one copy per image."""
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    g = torch.Generator(device="cuda").manual_seed(SEED + W)
    R = B * W

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    cell_args = [r(R, 4 * H)] + [t.to(dt).contiguous() for t in (
        r(R, H, scale=0.5), r(R, H), r(R, E2, scale=0.5), torch.zeros(R, H, device="cuda"),
        r(B, K, D), r(B, K, H).abs(), r(H, 4 * H, scale=H ** -0.5), r(4 * H, scale=0.1),
        r(E2, H, scale=E2 ** -0.5), r(H, H, scale=H ** -0.5), r(H, D, scale=H ** -0.5),
        r(H, D, scale=H ** -0.5), r(D, scale=D ** -0.5))]
    ct = (fs.cell_kernel_tiles(*(cell_args[i] for i in (7, 9, 10, 11, 12)))
          if fs.cell_instance(dt, H, E2) == "mma" else None)
    got = fs.decode_cell(*cell_args, beam_w=W, cell_t=ct)
    torch.cuda.synchronize()
    ref = fs.decode_cell_plain(*cell_args, beam_w=W)
    cell_err = 0.0
    for name, a, b in zip(("h", "c", "c_hat", "alpha", "beta"), got, ref):
        tol = TOL["float32"] if a.dtype == torch.float32 else TOL[dtype_name]
        cell_err = max(cell_err, check_close(f"beam cell W={W} {dtype_name} {name}", a, b, *tol))

    Wt = r(H, VP, scale=(2.0 / H) ** 0.5).to(dt)
    bias = r(VP, scale=0.1)
    bias[VOCAB:] = fs.NEG
    bias = bias.to(dt)
    chat, h = r(R, H).to(dt), r(R, H).to(dt)
    Wtt = fs.head_kernel_tiles(Wt) if fs.head_instance(dt, H) == "mma" else None

    def head():
        return fs.beam_head_topk(Wt, bias, chat, h, VOCAB, W, head_kernel_t=Wtt)

    top = head()
    torch.cuda.synchronize()
    ref_top = fs.beam_head_topk_plain(Wt, bias, chat, h, VOCAB, W)
    logits = (chat + h).to(dt).float() @ Wt.float() + bias.float()
    logits[:, VOCAB:] = fs.NEG
    head_err, rows_differ = topk_checks(f"topk head W={W} {dtype_name}", top, ref_top, logits, W)
    inst = fs.cell_instance(dt, H, E2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fs.cell_plan(inst, R, W, sms=sms)
    log(f"[beam kernels {dtype_name} W={W}] cell ({stages_text(inst, plan, None)}): "
        f"max_abs_err {cell_err:.3e} | top-W head: "
        f"max_abs_err {head_err:.3e}, {rows_differ}/{R} rows' ids differ (all at adjacent "
        f"gaps < {HEAD_GAP_EPS})")
    if not timed:
        return None

    cell_ms = cuda_ms(lambda: fs.decode_cell(*cell_args, beam_w=W, cell_t=ct))
    cell_plain_ms = cuda_ms(lambda: fs.decode_cell_plain(*cell_args, beam_w=W))
    stages = cell_stages(cell_args, W, ct)
    # the tiled layout on the same inputs: kernel 1 over V/pv repeated per
    # beam row does the same arithmetic and reads the slots W times
    tiled_args = list(cell_args)
    tiled_args[5] = cell_args[5].repeat_interleave(W, 0)
    tiled_args[6] = cell_args[6].repeat_interleave(W, 0)
    tiled_err = 0.0
    for name, a, b in zip(("h", "c", "c_hat", "alpha", "beta"),
                          fs.decode_cell(*tiled_args, cell_t=ct), got):
        tol = TOL["float32"] if a.dtype == torch.float32 else TOL[dtype_name]
        tiled_err = max(tiled_err, check_close(f"tiled vs beam-major W={W} {dtype_name} {name}",
                                               a, b, *tol))
    tiled_ms = cuda_ms(lambda: fs.decode_cell(*tiled_args, cell_t=ct))
    cell_flops = 2.0 * R * (H * 4 * H + E2 * H + H * H + 2 * H * D + K * D + K * H)
    cell_bound = bound(nbytes(*cell_args) + nbytes(*got), cell_flops, dtype_name)
    head_ms, head_cold_ms = cuda_ms(head), cuda_cold_ms(head)
    head_plain_ms = cuda_ms(lambda: fs.beam_head_topk_plain(Wt, bias, chat, h, VOCAB, W))
    z = (chat + h).to(dt)

    def library():
        lg = torch.addmm(bias, z, Wt)
        return lg.topk(W, dim=1), torch.logsumexp(lg, dim=1)

    head_lib_ms, head_lib_cold_ms = cuda_ms(library), cuda_cold_ms(library)
    head_bound = bound(nbytes(Wt, bias, chat, h, *top), 2.0 * R * H * VP, dtype_name)
    log(f"[beam kernels {dtype_name} W={W}] cell ({stages_text(*stages)}): kernel {cell_ms:.4f} "
        f"ms plain {cell_plain_ms:.4f} ms bound {cell_bound[0]:.4f} ms ({cell_bound[1]}), tiled "
        f"layout (kernel 1, V/pv repeated; max abs diff {tiled_err:.3e}) {tiled_ms:.4f} ms | "
        f"top-W head ({fs.head_instance(dt, H)}): kernel {head_ms:.4f} ms (L2 cold "
        f"{head_cold_ms:.4f}) plain {head_plain_ms:.4f} ms addmm+topk+logsumexp "
        f"{head_lib_ms:.4f} ms (L2 cold {head_lib_cold_ms:.4f}) bound {head_bound[0]:.4f} ms "
        f"({head_bound[1]})")
    return {
        "adaptive_decode_cell_fused_beam": {
            "max_abs_err": cell_err, "ms": cell_ms, "plain_ms": cell_plain_ms,
            "bound_ms": cell_bound[0], "bound_by": cell_bound[1], "library_ms": None,
            "tiled_ms": tiled_ms, "instance": stages[0], "plan": stages[1]._asdict(),
            "stage_ms": stages[2]},
        "beam_head_topk": {
            "max_abs_err": head_err, "rows_differ": rows_differ, "ms": head_ms,
            "cold_ms": head_cold_ms, "plain_ms": head_plain_ms, "bound_ms": head_bound[0],
            "bound_by": head_bound[1], "library_ms": head_lib_ms,
            "library_cold_ms": head_lib_cold_ms},
    }


# ---------------------------------------------------------------- phase 2c
def quanta(name, got, want):
    """Elements of two s8 outputs that differ: at most 1 quantum, on under
    QUANTUM_SHARE of them. Returns (count, max |d|)."""
    d = (got.int() - want.int()).abs()
    n, worst = int((d > 0).sum()), int(d.max())
    if worst > 1 or n >= QUANTUM_SHARE * d.numel():
        raise AssertionError(f"{name}: {n}/{d.numel()} elements differ, max |d| {worst}")
    return n, worst


def int8_kernel_checks():
    """Kernels 5 and 6 against their twins and against the carry's own
    unfused code (_acc_i8 + epilogue, the path that runs with the kernel
    off) at batch B with seeded s8 activations and weights and epilogue rows
    that keep the outputs inside the s8 range: kernel 5 at the four
    bottleneck layers' shapes, kernel 6 at the seven shapes a decode
    launches it at (INT8_TAILS). Times kernel, twin and unfused segment
    beside the bound, with each kernel's launch plan; then one
    correctness-only pass of each at an odd shape (3 images of 13 x 13, M2
    = 2M)."""
    import torch

    from adaptive_tpu_torch.models import infer as I
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_tail as ft

    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    relu = torch.relu

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    def rows(n, k):  # acc * sc + b at O(1): an int8 product of depth k spreads ~127^2 sqrt(k) / 3
        sc = (torch.rand(n, generator=g, device="cuda") + 0.5) * (3.0 / (127 ** 2 * k ** 0.5))
        return sc, torch.randn(n, generator=g, device="cuda") * 0.3

    def conv(w, kh, sc, b):  # a prepared conv dict of the carry, w [O, kh*kh*I] (ky, kx, i)
        O = w.shape[0]
        return {"wq": w.reshape(O, kh, kh, -1).permute(0, 3, 1, 2), "scale": sc, "bias": b}

    def carry_block(x4, c1, c2, c3, s2, s3, s_in, s_out):  # _resnet_int8_carry's ops
        acc, sc = I._acc_i8(x4, c1, None)
        z = I._requant(relu(acc.float() * sc + c1["bias"]), s2)
        acc, sc = I._acc_i8(z, c2, None)
        z = I._requant(relu(acc.float() * sc + c2["bias"]), s3)
        acc, sc = I._acc_i8(z, c3, None)
        tail = acc.float() * sc + c3["bias"]
        return I._requant(relu(tail + x4.float() * I.f32(s_in, tail)), s_out)

    def carry_tail(x4, z2, c3, c1, s_in, s_out, s_next):
        acc, sc = I._acc_i8(z2, c3, None)
        out = I._requant(relu(acc.float() * sc + c3["bias"] + x4.float() * I.f32(s_in, acc)), s_out)
        acc, sc = I._acc_i8(out, c1, None)
        return out, I._requant(relu(acc.float() * sc + c1["bias"]), s_next)

    def layer_of(H):
        return f"layer{[l[0] for l in INT8_LAYERS].index(H) + 1}"

    S5, S6 = (0.034, 0.057, 0.021, 0.026), (0.024, 0.027, 0.042)
    res = {"bottleneck_identity_int8": [], "tail_conv1_int8": []}

    def record(name, where, nb, H, C, M, n, nd, dmax, ms, pl, un, bd, **extra):
        res[name].append({"layer": where, "B": nb, "H": H, "C": C, "M": M, **extra,
                          "launches": n, "elements_differ": nd, "max_abs_err": dmax, "ms": ms,
                          "plain_ms": pl, "unfused_ms": un, "bound_ms": bd[0],
                          "bound_by": bd[1]})

    # kernel 5
    for nb, H, C, M, n in [(B, H, C, M, n) for H, C, M, n in INT8_LAYERS] + [(3, 13, 256, 64, 0)]:
        N = nb * H * H
        where = layer_of(H) if n else "odd"
        x = s8(N, C)
        w1, w2, w3 = s8(M, C), s8(M, 9 * M), s8(C, M)
        r1, r2, r3 = rows(M, C), rows(M, 9 * M), rows(C, M)
        a5 = (x, H, H, w1, w2, w3, *r1, *r2, *r3, *S5)
        got = fb.bottleneck_identity_int8(*a5)
        torch.cuda.synchronize()
        n5, d5 = quanta(f"block {where}", got, fb.bottleneck_identity_int8_plain(*a5))
        x4 = x.reshape(nb, H, H, C)
        c5 = (conv(w1, 1, *r1), conv(w2, 3, *r2), conv(w3, 1, *r3))
        u5 = quanta(f"block {where} vs the carry", got.reshape(nb, H, H, C),
                    carry_block(x4, *c5, *S5))[0]
        line = (f"[int8 kernels {where}] block B {nb} H=W {H} C {C} M {M}: {n5}/{got.numel()} "
                f"elements differ from the twin (max |d| {d5}), {u5} from the carry")
        if n:
            k5 = cuda_ms(lambda: fb.bottleneck_identity_int8(*a5), INT8_ITERS, 1)
            p5 = cuda_ms(lambda: fb.bottleneck_identity_int8_plain(*a5), INT8_ITERS, 1)
            f5 = cuda_ms(lambda: carry_block(x4, *c5, *S5), INT8_ITERS, 1)
            b5 = bound(2 * nbytes(x) + nbytes(w1, w2, w3, *r1, *r2, *r3),
                       2.0 * N * (C * M + 9 * M * M + M * C), "int8")
            plan = fb.block_plan(nb, H, H, C, M)
            line += (f" | kernel {k5:.4f} ms plain {p5:.4f} ms unfused {f5:.4f} ms bound "
                     f"{b5[0]:.4f} ms ({b5[1]}); plan {plan.rows} rows x {plan.images} images a "
                     f"block, nt {plan.nt} kt {plan.kt}, {plan.smem} shared bytes, {plan.sms} "
                     f"blocks an SM; launches a decode {n}")
            record("bottleneck_identity_int8", where, nb, H, C, M, n, n5, d5, k5, p5, f5, b5,
                   plan={"rows_a_block": plan.rows, "images_a_block": plan.images,
                         "smem_bytes": plan.smem, "blocks_an_sm": plan.sms, "nt": plan.nt,
                         "kt": plan.kt})
        log(line)
        del a5, x, x4, c5, got
        torch.cuda.empty_cache()

    # kernel 6
    for nb, H, C, M, M2, n in ([(B, *t) for t in INT8_TAILS] + [(3, 13, 256, 64, 128, 0)]):
        N = nb * H * H
        where = layer_of(H) if n else "odd"
        x, z2 = s8(N, C), s8(N, M)
        w3, w1n = s8(C, M), s8(M2, C)
        r3, r1n = rows(C, M), rows(M2, C)
        a6 = (x, z2, w3, *r3, w1n, *r1n, *S6)
        out, z1 = ft.tail_conv1_int8(*a6)
        torch.cuda.synchronize()
        p_out, p_z1 = ft.tail_conv1_int8_plain(*a6)
        n6, d6 = quanta(f"tail {where} M2 {M2} carry", out, p_out)
        n6b, d6b = quanta(f"tail {where} M2 {M2} conv1", z1, p_z1)
        c6 = (conv(w3, 1, *r3), conv(w1n, 1, *r1n))
        x4, z24 = x.reshape(nb, H, H, C), z2.reshape(nb, H, H, M)
        u_out, u_z1 = carry_tail(x4, z24, *c6, *S6)
        u6 = (quanta(f"tail {where} M2 {M2} carry vs the carry", out.reshape(nb, H, H, C), u_out)[0]
              + quanta(f"tail {where} M2 {M2} conv1 vs the carry", z1.reshape(nb, H, H, M2),
                       u_z1)[0])
        line = (f"[int8 kernels {where}] tail B {nb} H=W {H} C {C} M {M} M2 {M2}: "
                f"{n6 + n6b}/{out.numel() + z1.numel()} elements differ from the twin (max |d| "
                f"{max(d6, d6b)}), {u6} from the carry")
        if n:
            k6 = cuda_ms(lambda: ft.tail_conv1_int8(*a6), INT8_ITERS, 1)
            p6 = cuda_ms(lambda: ft.tail_conv1_int8_plain(*a6), INT8_ITERS, 1)
            f6 = cuda_ms(lambda: carry_tail(x4, z24, *c6, *S6), INT8_ITERS, 1)
            b6 = bound(nbytes(x, z2, out, z1, w3, w1n, *r3, *r1n), 2.0 * N * (M * C + C * M2),
                       "int8")
            plan = ft.tail_plan(N, C, M, M2)
            line += (f" | kernel {k6:.4f} ms plain {p6:.4f} ms unfused {f6:.4f} ms bound "
                     f"{b6[0]:.4f} ms ({b6[1]}); plan {plan.rows} rows a block, nt {plan.nt} kt "
                     f"{plan.kt}, {plan.smem} shared bytes, {plan.sms} blocks an SM; launches a "
                     f"decode {n}")
            record("tail_conv1_int8", where, nb, H, C, M, n, n6 + n6b, max(d6, d6b), k6, p6, f6,
                   b6, M2=M2, plan={"rows_a_block": plan.rows, "smem_bytes": plan.smem,
                                    "blocks_an_sm": plan.sms, "nt": plan.nt, "kt": plan.kt})
        log(line)
        del a6, x, z2, x4, z24, c6, out, z1, p_out, p_z1, u_out, u_z1
        torch.cuda.empty_cache()
    return res


def int8_summary(per_layer):
    """One decode's launch-weighted sums over the layers of a kernel's rows."""
    tot = {k: sum(r["launches"] * r[k] for r in per_layer)
           for k in ("ms", "plain_ms", "unfused_ms", "bound_ms")}
    by = {}
    for r in per_layer:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["launches"] * r["bound_ms"]
    return {**tot, "bound_by": max(by, key=by.get),
            "max_abs_err": max(r["max_abs_err"] for r in per_layer)}


# ----------------------------------------------------------------- phase 3
def seeded_images(n, seed, size=256, cells=4):
    """n uint8 NHWC images from a numpy seed: a random cells x cells grid of
    colours, blown up to size, plus pixel noise of +-24. Images of i.i.d.
    noise all look alike to a network; coarse structure sets them apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (n, cells, cells, 3), dtype=np.int16)
    up = grid.repeat(size // cells, axis=1).repeat(size // cells, axis=2)
    up += rng.integers(-24, 25, up.shape, dtype=np.int16)
    return np.clip(up, 0, 255).astype(np.uint8)


def random_model(cf, device, calib_images):
    """Seeded random weights; BN statistics calibrated on a batch so the
    random ResNet-152's activations keep a trained network's scale, with
    residual branches scaled down so that it is not chaotic
    (resnet.calibrate_bn_)."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    model = build_model(cf, device=device)
    net = model.init(SEED)
    x = eval_preprocess(torch.as_tensor(calib_images, device=model.device), cf.train_crop_size)
    calibrate_bn_(net.encoder.resnet_conv, x)
    return model, net


def launch_counts():
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_step as fs
    from adaptive_tpu_torch.ops import fused_tail as ft

    return {"adaptive_decode_cell_fused": fs.decode_cell.launches,
            "greedy_head_argmax": fs.greedy_head_argmax.launches,
            "adaptive_decode_cell_fused_beam": fs.decode_cell.launches_beam,
            "beam_head_topk": fs.beam_head_topk.launches,
            "bottleneck_identity_int8": fb.bottleneck_identity_int8.launches,
            "tail_conv1_int8": ft.tail_conv1_int8.launches}


def reset_launch_counts():
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_step as fs
    from adaptive_tpu_torch.ops import fused_tail as ft

    fs.reset_launch_counts()
    fb.bottleneck_identity_int8.launches = ft.tail_conv1_int8.launches = 0


def timed_decodes(decode, net, model, cf, images, expect):
    """Warm-up at the full batch (cuDNN plans, allocator), then E2E_REPEATS
    timed decodes, the first with every launch count set to 0 just before
    and read just after; expect: {kernel: launches}. Then E2E_REPEATS timed
    encoder runs. Returns (first output, launches, total ms, encoder ms)."""
    import torch

    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    prepared = decode.prepare(net)
    decode(net, images)
    torch.cuda.synchronize()

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    out, first_ms = timed(lambda: decode(net, images))
    launches = launch_counts()
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times in the decode, "
                                 f"expected {n}")
    total_ms = [first_ms] + [timed(lambda: decode(net, images))[1] for _ in range(E2E_REPEATS - 1)]
    with torch.no_grad():
        enc_ms = [timed(lambda: model.encode_inference(prepared, eval_preprocess(
            images, cf.train_crop_size, model.compute_dtype)))[1] for _ in range(E2E_REPEATS)]
    return out, {k: launches[k] for k in expect if expect[k]}, total_ms, enc_ms


def check_maps(out, lead):
    """Attention maps [*lead, STEPS, K] finite and summing to 1, beta in [0, 1]."""
    import torch

    att = out.attention.float()
    if tuple(att.shape) != (*lead, STEPS, K) or not torch.isfinite(att).all():
        raise AssertionError("attention maps malformed")
    if not torch.allclose(att.sum(-1), torch.ones(*lead, STEPS, device=att.device), atol=1e-3):
        raise AssertionError("attention maps do not sum to 1")
    if not ((out.beta >= 0) & (out.beta <= 1)).all():
        raise AssertionError("beta outside [0, 1]")


def end_to_end(model, net, cf, images_u8, smi, profile_dir=None):
    import torch

    from adaptive_tpu_torch.decoding import make_greedy_decoder

    decode = make_greedy_decoder(model, cf)
    images = torch.as_tensor(images_u8, device="cuda")
    expect = {"adaptive_decode_cell_fused": STEPS, "greedy_head_argmax": STEPS,
              "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0,
              "bottleneck_identity_int8": 0, "tail_conv1_int8": 0}
    out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)

    ids = out.ids.cpu().numpy()
    if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
        raise AssertionError(f"ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
    check_maps(out, (B,))

    distinct = len({tuple(r) for r in ids.tolist()})
    total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
    log(f"[end-to-end bf16] {smi}: batch {B}, {STEPS} steps, mean of {E2E_REPEATS} runs: "
        f"total {total:.3f} ms {total_ms}, encoder (preprocess + ResNet-152 + heads) "
        f"{enc:.3f} ms {enc_ms}, decode loop {total - enc:.3f} ms, {B / total * 1e3:.1f} "
        f"captions/s; launches {launches}; {distinct} distinct captions, first: "
        f"{ids[0, :12].tolist()}")
    if profile_dir:
        profile_decode(lambda: decode(net, images), profile_dir, smi, "greedy")
    return launches, {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3}


# ---------------------------------------------------------------- phase 3b
def beam_end_to_end(model, net, cf, images_u8, smi, profile_dir=None):
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder

    decode = make_beam_decoder(model, cf, beam_size=BEAM)
    images = torch.as_tensor(images_u8, device="cuda")
    expect = {"adaptive_decode_cell_fused": 0, "greedy_head_argmax": 0,
              "adaptive_decode_cell_fused_beam": STEPS, "beam_head_topk": STEPS,
              "bottleneck_identity_int8": 0, "tail_conv1_int8": 0}
    out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)

    all_ids = out.all_ids.cpu().numpy()
    ids = out.ids.cpu().numpy()
    if all_ids.shape != (B, BEAM, STEPS) or all_ids.min() < 0 or all_ids.max() >= VOCAB:
        raise AssertionError(f"all_ids of shape {all_ids.shape} in [{all_ids.min()}, "
                             f"{all_ids.max()}]")
    if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
        raise AssertionError(f"ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
    check_maps(out, (B,))
    scores = out.all_scores
    if tuple(scores.shape) != (B, BEAM) or not torch.isfinite(scores).all():
        raise AssertionError("all_scores malformed")
    best = scores.argmax(1)
    img = torch.arange(B, device=scores.device)
    if not torch.equal(out.score, scores[img, best]):
        raise AssertionError("score is not all_scores at the best beam")
    if not torch.equal(out.ids, out.all_ids[img, best]):
        raise AssertionError("ids are not all_ids at the best beam")
    if not (scores[:, :-1] >= scores[:, 1:]).all():
        raise AssertionError("beams are not sorted by score")

    distinct = len({tuple(r) for r in ids.tolist()})
    total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
    log(f"[end-to-end beam {BEAM} bf16] {smi}: batch {B}, {STEPS} steps, mean of {E2E_REPEATS} "
        f"runs: total {total:.3f} ms {total_ms}, encoder {enc:.3f} ms {enc_ms}, decode loop "
        f"{total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; launches {launches}; "
        f"{distinct} distinct best captions, first: {ids[0, :12].tolist()} score "
        f"{float(out.score[0]):.4f}")
    if profile_dir:
        profile_decode(lambda: decode(net, images), profile_dir, smi, f"beam{BEAM}")
    return launches, {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3}


# ----------------------------------------------------------------- phase 5
def feature_check(name, got, ref):
    """Encoder features against a reference run: the bound of the JAX
    package's fused-kernel integration tests (tests/test_pallas.py:522-526),
    max |d| < 0.05 max |ref| and cosine > 0.9999. Returns the count of
    elements that differ."""
    import torch

    g, r = got.double(), ref.double()
    if g.shape != r.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: features of shape {tuple(g.shape)}, or not finite")
    err, scale = float((g - r).abs().max()), float(r.abs().max())
    cos = float((g * r).sum() / (g.norm() * r.norm()))
    if not (err < 0.05 * scale and cos > 0.9999):
        raise AssertionError(f"{name}: max |d| {err:.3e} against max |ref| {scale:.3e}, cos {cos}")
    return int((g != r).sum())


def int8_end_to_end(net, cf, images_u8, smi, profile_dir=None):
    """The int8 encoder end to end in bf16 at batch B on phase 3's model and
    images: build_model(encoder_quant="int8") -> calibrate_model (INT8_CALIB
    images) -> make_greedy_decoder, in three modes: (a) the bench's default
    (per-channel scales, s2d stem, no fused kernels), (b) per-tensor scales
    with every layer's identity blocks through kernel 5, (c) per-tensor
    scales with every layer's tails through kernel 6; and (t), per-tensor
    scales without kernels, the control of (b) and (c), whose features are
    held against its."""
    import torch

    from adaptive_tpu_torch.decoding import make_greedy_decoder
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models.infer import calibrate_model
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    images = torch.as_tensor(images_u8, device="cuda")
    cf_a = cf.replace(encoder_quant="int8")
    cf_t = cf_a.replace(encoder_quant_granularity="tensor")
    t0 = time.perf_counter()
    model_a = calibrate_model(build_model(cf_a), cf_a, net, images_u8[:INT8_CALIB])
    model_t = calibrate_model(build_model(cf_t), cf_t, net, images_u8[:INT8_CALIB])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    base = {"adaptive_decode_cell_fused": STEPS, "greedy_head_argmax": STEPS,
            "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0}
    none = {"bottleneck_identity_int8": 0, "tail_conv1_int8": 0}
    modes = {
        "a": (model_a, cf_a, none),
        "t": (model_t, cf_t, none),  # the control of (b) and (c): no kernels
        "b": (model_t._replace(int8_fused_layers=INT8_FUSED), cf_t,
              {"bottleneck_identity_int8": INT8_LAUNCHES, "tail_conv1_int8": 0}),
        "c": (model_t._replace(int8_fused_tails=INT8_FUSED), cf_t,
              {"bottleneck_identity_int8": 0, "tail_conv1_int8": INT8_LAUNCHES}),
    }
    with torch.no_grad():
        x = eval_preprocess(images, cf.train_crop_size, model_t.compute_dtype)
        ref = model_t.encode_inference(model_t.prepare_inference(net), x)[0]
    results, launches = {}, {}
    for tag, (model, mcf, extra) in modes.items():
        decode = make_greedy_decoder(model, mcf)
        out, got, total_ms, enc_ms = timed_decodes(decode, net, model, mcf, images,
                                                   {**base, **extra})
        launches[tag] = got
        ids = out.ids.cpu().numpy()
        if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
            raise AssertionError(f"int8 {tag}: ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
        check_maps(out, (B,))
        differ = ""
        if tag in "bc":
            with torch.no_grad():
                V = model.encode_inference(decode.prepare(net), x)[0]
            differ = (f"; V against per-tensor scales without kernels: "
                      f"{feature_check(f'int8 {tag}', V, ref)}/{V.numel()} elements differ")
        distinct = len({tuple(r) for r in ids.tolist()})
        total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
        log(f"[end-to-end int8 {tag} bf16] {smi}: {mcf.encoder_quant_granularity} scales, fused "
            f"layers {model.int8_fused_layers}, tails {model.int8_fused_tails}, s2d stem "
            f"{model._resolved_fusion()[2]}; batch {B}, mean of {E2E_REPEATS} runs: total "
            f"{total:.3f} ms {total_ms}, encoder {enc:.3f} ms {enc_ms}, decode loop "
            f"{total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; launches {got}; "
            f"{distinct} distinct captions, first: {ids[0, :12].tolist()}{differ}")
        results[tag] = {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3}
        if profile_dir and tag == "a":
            profile_decode(lambda: decode(net, images), profile_dir, smi, "int8_a")
        del decode, out
        torch.cuda.empty_cache()
    log(f"[int8 calibration] two calibrate_model calls on {INT8_CALIB} images: {calib_s:.2f} s")
    return launches, results


# ----------------------------------------------------------------- phase 6
def int8_parity(cf, net_g, net_c):
    """int8 in fp32 on 8 images, card against CPU, in modes (a) and (c):
    scales calibrated once on the card and handed to both. The images are
    at the crop size (224 px, no resize: the card's antialiased resize rounds
    otherwise than the CPU's). The trunk features (the int8 ResNet's output)
    are held to phase 5's bound, 0 differing elements expected (exact
    products, the same IEEE epilogues, a device-exact BN fold); greedy ids
    under phase 4's top-2 gap rule."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models import infer as I
    from adaptive_tpu_torch.models.infer import calibrate_model
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    imgs = seeded_images(8, SEED + 1, size=cf.train_crop_size)

    def trunk(model, net, dev):
        fused, tails, s2d = model._resolved_fusion()
        x = eval_preprocess(torch.as_tensor(imgs, device=dev), cf.train_crop_size)
        with torch.no_grad():
            return I.resnet_apply_folded_int8(model.prepare_inference(net)["encoder"]["resnet"], x,
                                              model.arch, model.int8_scales, fused, tails,
                                              stem_s2d=s2d)

    for tag, gran, kw in (("a", "channel", {}), ("c", "tensor", {"int8_fused_tails": INT8_FUSED})):
        cf_i = cf.replace(encoder_quant="int8", encoder_quant_granularity=gran)
        mg = calibrate_model(build_model(cf_i), cf_i, net_g, imgs)._replace(**kw)
        mc = build_model(cf_i, device="cpu")._replace(int8_scales=mg.int8_scales, **kw)
        reset_launch_counts()
        Ag = trunk(mg, net_g, "cuda").cpu()
        n6 = launch_counts()["tail_conv1_int8"]
        if n6 != (INT8_LAUNCHES if kw else 0):
            raise AssertionError(f"int8 parity {tag}: kernel 6 launched {n6} times")
        Ac = trunk(mc, net_c, "cpu")
        differ = feature_check(f"int8 parity {tag}", Ag, Ac)
        log(f"[int8 parity fp32 {tag}] {gran} scales, fused tails {mg.int8_fused_tails}: trunk "
            f"features card vs CPU: {differ}/{Ac.numel()} elements differ, max abs diff "
            f"{float((Ag - Ac).abs().max()):.3e}")
        cross_device_parity(cf_i, mg, net_g, mc, net_c, imgs, tag=f"int8 parity fp32 {tag}")


def profile_decode(run, out_dir, smi, tag):
    """torch.profiler over one end-to-end decode: device time by kernel name
    (all of it to out_dir/profile_e2e_<tag>.txt, the largest printed) and the
    device's busy share of the window (union of kernel intervals over the
    wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]  # e.g. Optimizer.step ranges
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for k in kernels:
        us, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (us + k.time_range.elapsed_us(), n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total = sum(us for us, _ in by_name.values())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_e2e_{tag}.txt"), "w") as f:
        f.write(f"{smi}; wall {wall_us:.1f} us, busy {busy:.1f} us\n")
        f.writelines(f"{us:12.1f} us {n:6d}x  {name}\n" for name, (us, n) in rows)
    log(f"[profile {tag} bf16] {smi}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({busy / wall_us:.4f} of the window), kernel time {total / 1e3:.3f} ms; top: "
        + "; ".join(f"{name[:70]} {us / 1e3:.3f} ms x{n}" for name, (us, n) in rows[:10]))


# ----------------------------------------------------------------- phase 4
def cpu_gaps(model, prepared, images_u8, cf):
    """Top-2 logit gap of every row at every step of the CPU's greedy decode,
    with the head twin's arithmetic; also returns its ids."""
    import torch

    from adaptive_tpu_torch.models import decoders as Dm
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    with torch.no_grad():
        V, v_g, h0, c0 = model.encode_inference(prepared, eval_preprocess(
            torch.as_tensor(images_u8), cf.train_crop_size))
        dec, (w, b) = prepared["decoder"], prepared["head"]
        pv = model.precompute_slots(dec, V)
        st = model.init_decode_state(h0, c0)
        tok = torch.full((V.shape[0],), cf.decode_start_token, dtype=torch.int32)
        ids, gaps = [], []
        for _ in range(STEPS):
            x = torch.cat([dec["embed"][tok], v_g], dim=-1)
            h_new, c_new, chat, _, _ = Dm._fused_cell(dec, x, st, False, V, pv)
            logits = (chat + h_new) @ w + b
            logits[:, VOCAB:] = -1e30
            top2 = logits.topk(2, dim=1)
            gaps.append(top2.values[:, 0] - top2.values[:, 1])
            tok = top2.indices[:, 0].to(torch.int32)
            ids.append(tok)
            st = Dm.DecodeState(h_new, c_new, h_new)
    return torch.stack(ids, 1), torch.stack(gaps, 1)


def fp32_models(images_u8):
    """The fp32 model on the card and the same weights on the CPU."""
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cf = Config(compute_dtype="float32")
    model_g, net_g = random_model(cf, "cuda", images_u8[:32])
    model_c = build_model(cf, device="cpu")
    net_c = model_c.init(SEED)
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    return cf, model_g, net_g, model_c, net_c


def cross_device_parity(cf, model_g, net_g, model_c, net_c, images_u8, tag="parity fp32"):
    from adaptive_tpu_torch.decoding import make_greedy_decoder

    imgs = images_u8[:8]
    out_g = make_greedy_decoder(model_g, cf)(net_g, imgs)
    out_c = make_greedy_decoder(model_c, cf)(net_c, imgs)
    ids_g, ids_c = out_g.ids.cpu(), out_c.ids
    ref_ids, gaps = cpu_gaps(model_c, model_c.prepare_inference(net_c), imgs, cf)
    att_err = 0.0
    for row in range(imgs.shape[0]):
        diff = (ids_g[row] != ids_c[row]).nonzero()
        t = int(diff[0]) if len(diff) else STEPS
        if t < STEPS:
            gap = float(gaps[row, t])
            log(f"[{tag}] row {row} differs from step {t}: CPU top-2 gap there {gap:.3e}")
            if gap >= PARITY_GAP_EPS or int(ref_ids[row, t]) != int(ids_c[row, t]):
                raise AssertionError(f"row {row}: ids differ at step {t} with top-2 gap {gap:.3e}")
        # up to the first differing id both devices decode the same tokens
        for name, a, b in (("attention", out_g.attention, out_c.attention),
                           ("beta", out_g.beta, out_c.beta)):
            att_err = max(att_err, check_close(
                f"parity {name} row {row}", a[row, :t + 1].cpu(), b[row, :t + 1], PARITY_ATOL, 0.0))
    n_same = int((ids_g == ids_c).all(1).sum())
    distinct = len({tuple(r) for r in ids_c.tolist()})
    log(f"[{tag}, TF32 off] card vs CPU: {n_same}/{imgs.shape[0]} captions identical "
        f"({distinct} distinct); attention/beta max abs err {att_err:.3e} (atol {PARITY_ATOL}); "
        f"min top-2 gap over all steps {float(gaps.min()):.3e}; first: {ids_g[0, :12].tolist()}")


# ---------------------------------------------------------------- phase 4b
def cpu_beam_gaps(model, prepared, images_u8, cf, W):
    """The CPU's beam decode (fused path, plain twins) step by step, with
    each row's top W+1 tokens: the flat top W+1 of the beam x token
    candidates holds every candidate that could take one of the W slots,
    and the smallest gap between two adjacent ones says how near a swap
    was. Returns (all_ids [n, W, STEPS], per-step min gap [n, STEPS])."""
    import torch

    from adaptive_tpu_torch.models.decoders import DecodeState
    from adaptive_tpu_torch.ops.fused_step import topk_lower_index_first
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    with torch.no_grad():
        V, v_g, h0, c0 = model.encode_inference(prepared, eval_preprocess(
            torch.as_tensor(images_u8), cf.train_crop_size))
        dec, head = prepared["decoder"], prepared["head"]
        pv = model.precompute_slots(dec, V)
        n, k = V.shape[0], W + 1
        st = model.init_decode_state(h0.repeat_interleave(W, 0), c0.repeat_interleave(W, 0))
        vg = v_g.repeat_interleave(W, 0)
        dead = torch.tensor([0.0] + [-1e9] * W)
        scores = dead[:W].expand(n, W)
        tok = torch.full((n, W), cf.decode_start_token, dtype=torch.int32)
        finished = torch.zeros((n, W), dtype=torch.bool)
        img = torch.arange(n)[:, None]
        toks, parents, gaps = [], [], []
        for _ in range(STEPS):
            lp, tk, _, _, st = model.beam_decode_step(dec, tok.reshape(-1), vg, st, V, k,
                                                      pv=pv, head=head, beam_w=W)
            lp = torch.where(finished[..., None], dead, lp.reshape(n, W, k))
            tk = tk.reshape(n, W, k).masked_fill(finished[..., None], cf.decode_eos_token)
            top, idx = topk_lower_index_first((scores[..., None] + lp).reshape(n, W * k), k)
            gaps.append((top[:, :-1] - top[:, 1:]).min(1).values)
            scores, idx = top[:, :W], idx[:, :W]
            src = idx // k
            tok = tk.reshape(n, W * k).gather(1, idx)
            st = DecodeState(*(x.reshape(n, W, -1)[img, src].reshape(n * W, -1) for x in st))
            finished = finished.gather(1, src) | (tok == cf.decode_eos_token)
            toks.append(tok)
            parents.append(src)
        ptr, ids = torch.arange(W).expand(n, W), []
        for tok_t, par_t in zip(reversed(toks), reversed(parents)):
            ids.append(tok_t.gather(1, ptr))
            ptr = par_t.gather(1, ptr)
    return torch.stack(ids[::-1], 2), torch.stack(gaps, 1)


def beam_parity(cf, model_g, net_g, model_c, net_c, images_u8):
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder

    imgs = images_u8[:8]
    out_g = make_beam_decoder(model_g, cf, beam_size=BEAM)(net_g, imgs)
    out_c = make_beam_decoder(model_c, cf, beam_size=BEAM)(net_c, imgs)
    ref_ids, gaps = cpu_beam_gaps(model_c, model_c.prepare_inference(net_c), imgs, cf, BEAM)
    if not torch.equal(ref_ids, out_c.all_ids):
        raise AssertionError("the step-by-step CPU beam decode disagrees with make_beam_decoder")
    err = 0.0
    n_same = 0
    for row in range(imgs.shape[0]):
        gap = float(gaps[row].min())
        if not torch.equal(out_g.all_ids[row].cpu(), out_c.all_ids[row]):
            log(f"[beam parity fp32] image {row}: beams differ; CPU min adjacent flat-candidate "
                f"gap over the steps {gap:.3e}")
            if gap >= PARITY_GAP_EPS:
                raise AssertionError(f"image {row}: beams differ with candidate gaps >= {gap:.3e}")
            continue
        n_same += 1
        err = max(err, check_close(f"beam parity all_scores image {row}",
                                   out_g.all_scores[row].cpu(), out_c.all_scores[row],
                                   BEAM_SCORE_ATOL, 0.0))
        if not torch.equal(out_g.ids[row].cpu(), out_c.ids[row]):
            log(f"[beam parity fp32] image {row}: another best beam (scores "
                f"{out_c.all_scores[row].tolist()})")
            continue
        for name, a, b in (("attention", out_g.attention, out_c.attention),
                           ("beta", out_g.beta, out_c.beta)):
            err = max(err, check_close(f"beam parity {name} image {row}", a[row].cpu(), b[row],
                                       PARITY_ATOL, 0.0))
    distinct = len({tuple(r) for r in out_c.ids.tolist()})
    log(f"[beam parity fp32, TF32 off] beam {BEAM}, card vs CPU: {n_same}/{imgs.shape[0]} images' "
        f"beams identical ({distinct} distinct best captions); scores/attention/beta max abs "
        f"err {err:.3e} (atol {BEAM_SCORE_ATOL}/{PARITY_ATOL}); min adjacent candidate gap "
        f"{float(gaps.min()):.3e}; first: {out_g.ids[0, :12].tolist()}")


# ----------------------------------------------------------------- phase 7
def eval_split(root, n, seed):
    """A synthetic caption split of n images under root: a COCO annotation
    JSON with EVAL_REFS captions an image (data/synthetic.py, no image
    files), its images phase 3's seeded_images at 256 px made EVAL_CHUNK at a
    time and held in memory, and a vocabulary of the captions' words, then
    filler words up to VOCAB. Returns (annotation path, images, dataset,
    Vocabulary): the dataset, for coco_eval(dataset=), lists (image, image
    id), so the phase needs no JPEG codec (Pillow), which a card's machine
    need not have."""
    import numpy as np

    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset
    from adaptive_tpu_torch.data.vocab import build_vocab

    ann, _ = make_synthetic_dataset(root, num_images=n, captions_per_image=EVAL_REFS,
                                    seed=seed, write_images=False)
    images = np.concatenate([seeded_images(min(EVAL_CHUNK, n - s), seed + 1 + s // EVAL_CHUNK)
                             for s in range(0, n, EVAL_CHUNK)])
    vocab = build_vocab((a["caption"] for a in COCO(ann).anns.values()), threshold=1)
    for i in range(len(vocab), VOCAB):
        vocab.add_word(f"filler{i}")
    return ann, images, list(zip(images, range(1, n + 1))), vocab


@contextlib.contextmanager
def timed_spans(spans):
    """Wrap each (owner, attribute, label) so that its calls add their host
    seconds to times[label]; restores the originals on exit."""
    times = {label: 0.0 for _, _, label in spans}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in spans]

    def wrap(fn, label):
        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[label] += time.perf_counter() - t0
        return timed

    for (owner, attr, label), (_, _, fn) in zip(spans, saved):
        setattr(owner, attr, wrap(fn, label))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def eval_spans():
    """The driver's stages and the scorers, as timed_spans takes them."""
    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.evalcap import bleu, cider, coco_eval, eval as ev, meteor, ptbtokenizer, rouge
    from adaptive_tpu_torch.models import infer

    return [(infer, "calibrate_model", "calibrate"), (coco_eval, "decode_split", "decode"),
            (json, "dump", "write"), (COCO, "__init__", "load"), (COCO, "loadRes", "load"),
            (ev.COCOEvalCap, "evaluate", "score"), (ptbtokenizer.PTBTokenizer, "tokenize", "ptb"),
            (bleu.Bleu, "compute_score", "bleu"), (meteor.Meteor, "compute_score", "meteor"),
            (rouge.Rouge, "compute_score", "rouge"), (cider.Cider, "compute_score", "cider")]


def text_backends():
    """Which caption tokenizer and METEOR stemmer run: nltk's, or the
    packages' fallbacks where nltk is not installed."""
    from adaptive_tpu_torch.data import tokenizer
    from adaptive_tpu_torch.evalcap import meteor

    return ("nltk" if tokenizer._TREEBANK is not None else "fallback",
            "fallback" if meteor._STEM is meteor._fallback_stem else "nltk")


def read_results(path, n):
    """The results JSON: one caption for each of the split's n images."""
    with open(path) as f:
        results = json.load(f)
    if sorted(r["image_id"] for r in results) != list(range(1, n + 1)):
        raise AssertionError(f"{path}: {len(results)} results, not one for each of {n} images")
    if not all(isinstance(r["caption"], str) for r in results):
        raise AssertionError(f"{path}: a caption is not a string")
    return results


def eval_driver(net, cf, smi):
    """Phase 7a: coco_eval at full width in bf16 over a 5,000-image split
    with 5 captions an image at the reference's eval batch (400; 13 batches,
    the last padded), greedy, beam 3 and int8 (a) (per-channel scales that
    coco_eval calibrates on the split's first 32 images), each with the
    launch counts set to 0 before and read after; the wall time and its
    split into decode, results JSON, annotation loads and scoring."""
    import tempfile

    import numpy as np
    import torch

    from adaptive_tpu_torch.evalcap.coco_eval import coco_eval
    from adaptive_tpu_torch.models import build_model

    n_batches = -(-EVAL_IMAGES // EVAL_BATCH)
    loop = n_batches * STEPS
    greedy = {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
              "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0}
    beam = {"adaptive_decode_cell_fused": 0, "greedy_head_argmax": 0,
            "adaptive_decode_cell_fused_beam": loop, "beam_head_topk": loop}
    none = {"bottleneck_identity_int8": 0, "tail_conv1_int8": 0}
    modes = (("greedy", {}, {**greedy, **none}), (f"beam{BEAM}", {"beam_size": BEAM}, {**beam, **none}),
             ("int8_a", {"encoder_quant": "int8"}, {**greedy, **none}))
    tok, stem = text_backends()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ann, images, split, vocab = eval_split(root, EVAL_IMAGES, SEED + 100)
        log(f"[eval split] {EVAL_IMAGES} images at 256 px ({images.nbytes / 2**20:.1f} MiB in "
            f"host memory), {EVAL_REFS} captions an image, vocabulary {len(vocab)}: made in "
            f"{time.perf_counter() - t0:.2f} s")
        jpeg_decode(images[:EVAL_BATCH])
        for epoch, (tag, kw, expect) in enumerate(modes, 1):
            ecf = cf.replace(val_anno_path=ann, eval_batch_size=EVAL_BATCH, exp_dir=root, **kw)
            model = build_model(ecf)
            per_image = {}
            torch.cuda.synchronize()
            with timed_spans(eval_spans()) as t:
                reset_launch_counts()
                t0 = time.perf_counter()
                cider = coco_eval(ecf, model, net, epoch=epoch, vocab=vocab, per_image_out=per_image,
                                  dataset=split)
                wall = time.perf_counter() - t0
                launches = launch_counts()
            for name, n in expect.items():
                if launches[name] != n:
                    raise AssertionError(f"eval {tag}: {name} launched {launches[name]} times, "
                                         f"expected {n}")
            results = read_results(os.path.join(root, "val_results", f"validation-{epoch}.json"),
                                   EVAL_IMAGES)
            if len(per_image) != EVAL_IMAGES or not np.isfinite(cider):
                raise AssertionError(f"eval {tag}: {len(per_image)} per-image scores, CIDEr {cider}")
            distinct = len({r["caption"] for r in results})
            rest = wall - t["decode"] - t["write"] - t["load"] - t["score"] - t["calibrate"]
            log(f"[eval driver {tag} bf16] {smi}: {EVAL_IMAGES} images, batch {EVAL_BATCH} "
                f"({n_batches} batches): coco_eval {wall:.3f} s, {EVAL_IMAGES / wall:.1f} images/s; "
                f"decode_split {t['decode']:.3f} s ({EVAL_IMAGES / t['decode']:.1f} images/s), "
                f"calibration {t['calibrate']:.3f} s, results JSON {t['write']:.3f} s, annotation "
                f"loads {t['load']:.3f} s, COCOEvalCap.evaluate {t['score']:.3f} s (PTB tokenizer "
                f"{t['ptb']:.3f}, BLEU {t['bleu']:.3f}, METEOR {t['meteor']:.3f}, ROUGE-L "
                f"{t['rouge']:.3f}, CIDEr {t['cider']:.3f}), the rest {rest:.3f} s; launches "
                f"{ {k: v for k, v in launches.items() if v} }; {len(results)} results "
                f"({distinct} distinct captions), CIDEr {cider:.6g}; tokenizer {tok}, stemmer {stem}")
            out[tag] = {"wall_s": wall, "images_per_s": EVAL_IMAGES / wall,
                        **{f"{k}_s": v for k, v in t.items()}, "launches": launches,
                        "results": len(results), "cider": cider}
            del model
            torch.cuda.empty_cache()
    return {"card": smi, "images": EVAL_IMAGES, "batch": EVAL_BATCH, "tokenizer": tok,
            "stemmer": stem, "modes": out}


def jpeg_decode(images):
    """An extra line, where PIL is installed: the host time of decoding the
    split's images as 256 px JPEGs, one thread (the JPEG split's loader,
    data/loader.py, runs such decodes on dataloader_num_workers threads)."""
    import io

    from adaptive_tpu_torch.data.loader import _load_image_uint8

    try:
        from PIL import Image
    except ImportError:
        log("[eval jpeg] PIL is not installed here: JPEG decode not timed")
        return
    blobs = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG")
        blobs.append(buf.getvalue())
    t0 = time.perf_counter()
    for b in blobs:
        _load_image_uint8(io.BytesIO(b))
    s = time.perf_counter() - t0
    log(f"[eval jpeg] {len(blobs)} images of 256 px, {sum(map(len, blobs)) / len(blobs) / 1024:.1f} "
        f"KiB each: {s / len(blobs) * 1e3:.3f} ms an image on one thread")


def explain_by_gaps(tag, model_c, net_c, cf, batches_g, batches_c, index):
    """An image whose caption differs card vs CPU: its ids must differ where
    the CPU's decode was within PARITY_GAP_EPS of another choice (phase 4's
    top-2 gap rule, greedy; phase 4b's adjacent-candidate rule, beam)."""
    b, row = divmod(index, len(batches_c[0][0]))
    imgs = batches_c[b][0]
    prepared = model_c.prepare_inference(net_c)
    if cf.beam_size > 1:
        _, gaps = cpu_beam_gaps(model_c, prepared, imgs, cf, cf.beam_size)
        gap = float(gaps[row].min())
    else:
        ids_g, ids_c = batches_g[b][1].ids[row].cpu(), batches_c[b][1].ids[row]
        t = int((ids_g != ids_c).nonzero()[0])
        ref_ids, gaps = cpu_gaps(model_c, prepared, imgs, cf)
        gap = float(gaps[row, t])
        if int(ref_ids[row, t]) != int(ids_c[t]):
            raise AssertionError(f"[eval parity {tag}] the step-by-step CPU decode disagrees")
    log(f"[eval parity {tag}] image {index + 1}: captions differ; CPU gap {gap:.3e}")
    if gap >= PARITY_GAP_EPS:
        raise AssertionError(f"eval parity {tag}: image {index + 1} differs with gap {gap:.3e}")


def eval_parity(cf, model_g, net_g, model_c, net_c, smi):
    """Phase 7b: coco_eval in fp32 (TF32 off) on a 16-image split at batch 12
    (the second batch short), greedy and beam 3, on the card and on the CPU
    with the same weights: equal results JSON, CIDEr and per-image scores,
    or each differing caption explained by the gap rules of phases 4 and 4b.
    Then valid mode on the card with "auto" over a model.npz of the same
    weights written with the key codec: equal to the in-memory greedy run."""
    import tempfile

    import numpy as np

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.evalcap.coco_eval import _results_name, coco_eval
    from adaptive_tpu_torch.models.jax_params import to_jax
    from adaptive_tpu_torch.training.checkpoint import checkpoint_name, flatten_tree

    n = EVAL_PARITY_IMAGES
    with tempfile.TemporaryDirectory() as root:
        ann, _, split, vocab = eval_split(root, n, SEED + 200)
        base = cf.replace(val_anno_path=ann, eval_batch_size=EVAL_PARITY_BATCH, exp_dir=root)
        runs = {}
        for tag, kw in (("greedy", {}), (f"beam {BEAM}", {"beam_size": BEAM})):
            ecf = base.replace(**kw)
            got = {}
            for dev, model, net in (("card", model_g, net_g), ("CPU", model_c, net_c)):
                make = make_beam_decoder if ecf.beam_size > 1 else make_greedy_decoder
                decode, batches = make(model, ecf), []

                def recorded(net_, imgs, decode=decode, batches=batches):
                    res = decode(net_, imgs)
                    batches.append((imgs, res))
                    return res

                per_image = {}
                d = os.path.join(root, tag.replace(" ", ""), dev)
                c = coco_eval(ecf.replace(exp_dir=d), model, net, epoch=1, vocab=vocab,
                              decoder=recorded, per_image_out=per_image, dataset=split)
                res = read_results(os.path.join(d, "val_results", "validation-1.json"), n)
                got[dev] = (res, c, per_image, batches)
            (rg, cg, pg, bg), (rc, cc, pc, bc) = got["card"], got["CPU"]
            same = [i for i in range(n) if rg[i] == rc[i]]
            for i in sorted(set(range(n)) - set(same)):
                explain_by_gaps(tag, model_c, net_c, ecf, bg, bc, i)
            if len(same) == n and cg != cc:
                raise AssertionError(f"eval parity {tag}: CIDEr {cg} on the card, {cc} on the CPU")
            for i in same:
                if pg[rg[i]["image_id"]] != pc[rc[i]["image_id"]]:
                    raise AssertionError(f"eval parity {tag}: image {i + 1}'s scores differ")
            log(f"[eval parity fp32 {tag}, TF32 off] {smi}: card vs CPU through coco_eval, {n} "
                f"images at batch {EVAL_PARITY_BATCH}: {len(same)}/{n} captions identical, their "
                f"per-image scores equal; CIDEr {cg!r} vs {cc!r}; first: {rg[0]['caption'][:60]!r}")
            runs[tag] = {"identical": len(same), "cider_card": cg, "cider_cpu": cc}
            if tag == "greedy":
                in_memory = (rg, cg, pg)

        exp = os.path.join(root, "valid")
        ckpt = os.path.join(exp, "trained_models", checkpoint_name(0.5, 1))
        os.makedirs(ckpt)
        params, state = to_jax(net_g.state_dict(), model_g.arch)
        np.savez(os.path.join(ckpt, "model.npz"), **flatten_tree({"params": params, "state": state}))
        per_image = {}
        reset_launch_counts()
        c = coco_eval(base.replace(valid_pretrained_model="auto", exp_dir=exp), valid_mode=True,
                      vocab=vocab, per_image_out=per_image, dataset=split)
        launches = launch_counts()
        loop = -(-n // EVAL_PARITY_BATCH) * STEPS
        if (launches["adaptive_decode_cell_fused"], launches["greedy_head_argmax"]) != (loop, loop):
            raise AssertionError(f"eval valid mode: launches {launches}")
        res = read_results(os.path.join(exp, "val_results", _results_name(ckpt)), n)
        if (res, c, per_image) != in_memory:
            raise AssertionError("eval valid mode: the restored model.npz scores otherwise than "
                                 "the in-memory weights")
        log(f"[eval valid fp32] {smi}: valid_pretrained_model='auto' picked {os.path.basename(ckpt)}, "
            f"a model.npz written with the key codec, restored on the card: results, CIDEr "
            f"{c!r} and per-image scores equal to the in-memory greedy run; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        runs["valid_auto_equal"] = True
    return runs


# ----------------------------------------------------------------- phase 8
def train_batch(n, seed, device):
    """n seeded 256 px images with captions in bucket 24 (lengths 17..24:
    <start>, random words, <end>, padding), on device."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(TRAIN_T - 7, TRAIN_T + 1, n)
    caps = rng.integers(4, VOCAB, (n, TRAIN_T))
    caps[:, 0] = 1
    caps[np.arange(n), lengths - 1] = 2
    caps[np.arange(TRAIN_T)[None, :] >= lengths[:, None]] = 0
    return {"images": torch.as_tensor(seeded_images(n, seed + 1), device=device),
            "captions": torch.as_tensor(caps.astype(np.int32), device=device),
            "lengths": torch.as_tensor(lengths.astype(np.int32), device=device)}


@contextlib.contextmanager
def step_marks():
    """CUDA events at the train step's seams: before the augmentation
    (forward starts), after the masked loss (forward ends, backward
    starts), before the LSTM clip (backward and the gradients' division
    end) and after each group's update. Yields the list of (label, event)
    the calls record; restores the functions on exit."""
    import torch

    from adaptive_tpu_torch.ops import preprocess
    from adaptive_tpu_torch.training import optim, step

    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def around(owner, attr, before=None, after=None):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if before:
                mark(before)
            out = fn(*a, **kw)
            if after:
                mark(after)
            return out
        return owner, attr, fn, wrapped

    patches = [around(preprocess, "train_preprocess", before="start"),
               around(step, "masked_ce_sum", after="forward"),
               around(step, "clip_lstm_grads", before="backward"),
               around(optim.DualOptimizer, "step", after="optimizer")]
    for owner, attr, _, wrapped in patches:
        setattr(owner, attr, wrapped)
    try:
        yield marks
    finally:
        for owner, attr, fn, _ in patches:
            setattr(owner, attr, fn)


def train_throughput(smi, profile_dir=None):
    """Phase 8a: make_train_step at full width in bf16, batch 256, encoder
    off and on (fine-tuning layers 2-4): TRAIN_WARMUP steps, then
    TRAIN_STEPS timed (host clock around synchronised steps), the peak of
    allocated memory over them, one instrumented step split into forward,
    backward and optimizer by CUDA events, and one step under
    torch.utils.flop_counter.FlopCounterMode (the operations of every
    convolution and matmul, forward and backward, from their shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    cf = Config(compute_dtype="bfloat16", vocab_pad_multiple=128, train_batch_size=TRAIN_B)
    model = build_model(cf)
    net = model.init(SEED)
    dual = make_dual_optimizer(net, cf)
    step = make_train_step(model, dual, cf)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = train_batch(TRAIN_B, SEED + 300, "cuda")
    out = {}
    for tag, on in (("encoder_off", False), ("encoder_on", True)):
        for _ in range(TRAIN_WARMUP):
            step(net, batch, gen, on)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step(net, batch, gen, on).loss for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).float().cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"train {tag}: losses {losses.tolist()}")
        with step_marks() as marks:
            step(net, batch, gen, on)
        torch.cuda.synchronize()
        ev = dict(marks[:3])
        split = {"forward": ev["start"].elapsed_time(ev["forward"]),
                 "backward": ev["forward"].elapsed_time(ev["backward"]),
                 "optimizer": ev["backward"].elapsed_time(marks[-1][1])}
        with FlopCounterMode(display=False) as fc:
            step(net, batch, gen, on)
        flops = fc.get_total_flops()
        share = flops / (ms * 1e-3) / PEAK_FLOPS["bfloat16"]
        log(f"[train step {tag} bf16] {smi}: batch {TRAIN_B}, captions {TRAIN_T}, mean of "
            f"{TRAIN_STEPS} steps after {TRAIN_WARMUP}: {ms:.3f} ms a step, "
            f"{TRAIN_B / ms * 1e3:.1f} images/s; one instrumented step: forward "
            f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, optimizer "
            f"{split['optimizer']:.3f} ms; peak allocated {peak / 2**30:.2f} GiB; "
            f"{flops / 1e12:.3f} TFLOP a step (convolutions and matmuls), "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {share:.4f} of the bf16 peak; losses "
            f"{[round(v, 4) for v in losses.tolist()]}")
        if profile_dir:
            profile_decode(lambda: step(net, batch, gen, on), profile_dir, smi, f"train_{tag}")
        out[tag] = {"ms": ms, "images_per_s": TRAIN_B / ms * 1e3, **{f"{k}_ms": v for k, v in
                    split.items()}, "peak_bytes": peak, "tflop": flops / 1e12,
                    "bf16_peak_share": share, "losses": losses.tolist()}
    del net, dual, step
    torch.cuda.empty_cache()
    return out


def train_split(root, vocab):
    """Phase 8b's train split: TRAIN_IMAGES seeded 256 px images held in
    memory, one synthetic caption each, served through CocoCaptionDataset's
    interface (TrainBatches reads its ids, coco.anns and vocab)."""
    from adaptive_tpu_torch.data.loader import CocoCaptionDataset
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset

    ann, _ = make_synthetic_dataset(os.path.join(root, "train"), num_images=TRAIN_IMAGES,
                                    seed=SEED + 400, write_images=False)
    images = seeded_images(TRAIN_IMAGES, SEED + 401)

    class Memory(CocoCaptionDataset):
        def __getitem__(self, index):
            a = self.coco.anns[self.ids[index]]
            return images[a["image_id"] - 1], self.vocab.encode_caption(a["caption"]), a["image_id"]

    return ann, Memory(root, ann, vocab)


def train_loop(smi):
    """Phase 8b: main_train at full width in bf16 on a 1,024-image train
    split in memory (batch 256, 4 steps an epoch), 2 epochs, fine-tuning
    from epoch 2, a step checkpoint every 2 steps, the per-epoch eval
    (greedy, one shared decoder) on 400-image train_eval and val splits in
    memory. Checks the launches (2 epochs x 2 coco_eval x 1 batch x 30
    steps of kernels 1 and 2, none of 3-6), the two epoch checkpoints, no
    step checkpoint left, and that valid mode "auto" restores the best one
    and writes the captions its epoch's val eval wrote."""
    import tempfile

    import numpy as np
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.evalcap import coco_eval as ce
    from adaptive_tpu_torch.evalcap.coco_eval import _results_name
    from adaptive_tpu_torch.training import checkpoint as ckpt
    from adaptive_tpu_torch.training.train_loop import main_train

    with tempfile.TemporaryDirectory() as root:
        val_ann, _, val_split, vocab = eval_split(os.path.join(root, "val"), TRAIN_EVAL_IMAGES,
                                                  SEED + 500)
        te_ann, _, te_split, _ = eval_split(os.path.join(root, "train_eval"),
                                            TRAIN_EVAL_IMAGES, SEED + 600)
        vocab_path = os.path.join(root, "vocab.json")
        vocab.save(vocab_path)
        ann, train_ds = train_split(root, vocab)
        cf = Config(compute_dtype="bfloat16", vocab_pad_multiple=128, vocab_path=vocab_path,
                    train_anno_path=ann, val_anno_path=val_ann, train_eval_anno_path=te_ann,
                    exp_dir=root, train_batch_size=TRAIN_B, train_num_epochs=TRAIN_EPOCHS,
                    opt_fine_tune_cnn_start_epoch=1, train_evalOrnot=True,
                    train_checkpoint_every_steps=2, eval_batch_size=EVAL_BATCH)
        spans = [(ce, "coco_eval", "eval"), (ckpt, "_model_flat", "copy_model"),
                 (ckpt, "_opt_flat", "copy_opt"), (ckpt.AsyncCheckpointer, "wait", "ckpt_wait")]
        torch.cuda.synchronize()
        with timed_spans(spans) as t:
            reset_launch_counts()
            t0 = time.perf_counter()
            net, best, best_epoch = main_train(
                cf, dataset=train_ds, eval_datasets={"val": val_split, "train_eval": te_split})
            wall = time.perf_counter() - t0
            launches = launch_counts()
        loop = TRAIN_EPOCHS * 2 * STEPS
        expect = {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
                  "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0,
                  "bottleneck_identity_int8": 0, "tail_conv1_int8": 0}
        if launches != expect:
            raise AssertionError(f"main_train launches {launches}, expected {expect}")
        d = os.path.join(root, "trained_models")
        names = sorted(os.listdir(d))
        want = [n for n in names if n.startswith("cider-") and n.endswith(("_model-1", "_model-2"))]
        if len(want) != 2 or len(names) != 2:
            raise AssertionError(f"trained_models holds {names}")
        with open(os.path.join(d, names[-1], "manifest.json")) as f:
            meta = json.load(f)
        losses = meta["train_epoch_losses"]
        if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"epoch losses {losses}")
        sizes = {n: sum(os.path.getsize(os.path.join(d, n, f)) for f in os.listdir(
            os.path.join(d, n))) for n in names}

        # valid mode "auto": the best checkpoint, restored, writes its epoch's captions
        vcf = cf.replace(valid_pretrained_model="auto", vocab_length=len(vocab))
        t1 = time.perf_counter()
        cider = ce.coco_eval(vcf, valid_mode=True, vocab=vocab, dataset=val_split)
        valid_s = time.perf_counter() - t1
        path = ckpt.find_best_checkpoint(d)
        with open(os.path.join(root, "val_results", _results_name(path))) as f:
            restored = json.load(f)
        epoch = ckpt.epoch_from_filename(path)
        with open(os.path.join(root, "val_results", f"validation-{epoch}.json")) as f:
            in_memory = json.load(f)
        if restored != in_memory or cider != meta["cider_scores"][epoch - 1]:
            raise AssertionError(f"valid 'auto' from {path}: captions or CIDEr {cider} differ "
                                 f"from epoch {epoch}'s val eval")
    steps = TRAIN_EPOCHS * TRAIN_IMAGES // TRAIN_B
    copy_s = t["copy_model"] + t["copy_opt"]
    train_s = wall - t["eval"] - copy_s - t["ckpt_wait"]
    log(f"[train loop bf16] {smi}: main_train, {TRAIN_IMAGES} images, batch {TRAIN_B}, "
        f"{TRAIN_EPOCHS} epochs ({steps} steps, encoder on in epoch 2), eval on 2 x "
        f"{TRAIN_EVAL_IMAGES} images an epoch: {wall:.3f} s ({wall / TRAIN_EPOCHS:.3f} s an epoch "
        f"with its eval); the per-epoch coco_eval {t['eval']:.3f} s, checkpoints' host copies "
        f"{copy_s:.3f} s (weights {t['copy_model']:.3f}, moments {t['copy_opt']:.3f}), waits "
        f"for the writer thread {t['ckpt_wait']:.3f} s, the rest (loader, steps, "
        f"logging) {train_s:.3f} s; launches { {k: v for k, v in launches.items() if v} }; "
        f"epoch losses {losses}, CIDEr {meta['cider_scores']} (best epoch {best_epoch}); "
        f"checkpoints {names} ({[round(v / 2**30, 3) for v in sizes.values()]} GiB), step "
        f"checkpoints pruned; valid 'auto' restored {os.path.basename(path)} in {valid_s:.3f} s: "
        f"captions and CIDEr equal to epoch {epoch}'s val eval")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "epoch_s": wall / TRAIN_EPOCHS, "eval_s": t["eval"],
            "ckpt_copy_s": copy_s, "ckpt_wait_s": t["ckpt_wait"], "rest_s": train_s,
            "launches": launches, "epoch_losses": losses, "cider": meta["cider_scores"],
            "checkpoint_bytes": sizes, "valid_auto_equal": True}


def train_parity(cf, net_g, net_c, smi):
    """Phase 8c: one train step in fp32 (TF32 off) from the same full-width
    weights (phase 4's) and batch of TRAIN_PARITY_B on the card and on the
    CPU, with the encoder off and then on (each from the original weights),
    the crops and flips drawn once on the CPU for both. Held: loss and LSTM
    grad norm within TRAIN_RTOL (relative); BN running statistics within
    TRAIN_BN_TOL; the decoder group's gradients within TRAIN_GRAD_ATOL +
    TRAIN_GRAD_RTOL max|g| (the tensor's) and its weights within
    TRAIN_PARAM_ATOL where the gradient is past that bound (elsewhere Adam may
    take either sign: up to 2 lr). The encoder group's gradients
    (encoder on) are ill-conditioned at these weights: train-mode BN's
    backward subtracts each channel's mean gradient over 4 images, and the
    cancellation grows rounding through ResNet-152's blocks, so the CPU run
    again with another thread count (another summation order) moves them by
    about 1% of their norm. They are held to TRAIN_ENC_GRAD_REL of their
    norm, and the encoder's weights to Adam's bound on a first update, lr
    each way. With the encoder off its weights do not move on either."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = {k: v.detach().cpu().clone() for k, v in net_c.state_dict().items()}
    batch = train_batch(TRAIN_PARITY_B, SEED + 700, "cpu")
    threads = torch.get_num_threads()

    def run(net, on):
        device = next(net.parameters()).device
        net.load_state_dict(start)
        model = build_model(cf, device=device)
        dual = make_dual_optimizer(net, cf)
        res = make_train_step(model, dual, cf)(
            net, {k: v.to(device) for k, v in batch.items()}, torch.Generator().manual_seed(SEED),
            on)
        grads = {n: p.grad.detach().cpu() for n, p in net.named_parameters()
                 if p.grad is not None}
        return (float(res.loss), float(res.lstm_grad_norm), grads,
                {k: v.detach().cpu() for k, v in net.state_dict().items()}, dual)

    def group_rel(ga, gb, names):
        num = sum(float((ga[k] - gb[k]).double().pow(2).sum()) for k in names)
        den = sum(float(gb[k].double().pow(2).sum()) for k in names)
        return (num / den) ** 0.5

    out = {}
    for tag, on in (("encoder_off", False), ("encoder_on", True)):
        lg, ng, gg, sg, _ = run(net_g, on)
        lc, nc, gc, sc, dual = run(net_c, on)
        d_loss, d_norm = abs(lg - lc) / abs(lc), abs(ng - nc) / abs(nc)
        bn = [k for k in sc if k.endswith(("running_mean", "running_var"))]
        d_bn = max(float(((sg[k] - sc[k]).abs() / sc[k].abs().clamp(min=1)).max()) for k in bn)
        d_bn_abs = max(float((sg[k] - sc[k]).abs().max()) for k in bn)
        if d_loss > TRAIN_RTOL or d_norm > TRAIN_RTOL or d_bn > TRAIN_BN_TOL:
            raise AssertionError(f"train parity {tag}: loss {lg} vs {lc}, LSTM norm {ng} vs {nc}, "
                                 f"BN statistics {d_bn:.3e}")
        dec, enc = dual.names("decoder"), dual.names("encoder")
        g_tol = {k: TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * float(gc[k].abs().max()) for k in dec}
        d_grad = max(float((gg[k] - gc[k]).abs().max()) / g_tol[k] for k in dec)
        if d_grad > 1:
            worst = max(dec, key=lambda k: float((gg[k] - gc[k]).abs().max()) / g_tol[k])
            raise AssertionError(f"train parity {tag}: the gradient of {worst} differs by "
                                 f"{float((gg[worst] - gc[worst]).abs().max()):.3e}, max |g| "
                                 f"{float(gc[worst].abs().max()):.3e}")
        # weights whose gradient's sign the bound determines, and the rest
        d_param, flips, d_flip = 0.0, 0, 0.0
        for k in dec:
            d = (sg[k] - sc[k]).abs()
            floor = gc[k].abs() <= g_tol[k]
            if (~floor).any():
                d_param = max(d_param, float(d[~floor].max()))
            if floor.any():
                d_flip = max(d_flip, float(d[floor].max()))
                flips += int((d[floor] > TRAIN_PARAM_ATOL).sum())
        if d_param > TRAIN_PARAM_ATOL or d_flip > 2 * cf.opt_rnn_adam_learning_rate \
                + TRAIN_PARAM_ATOL:
            raise AssertionError(f"train parity {tag}: decoder weights differ by {d_param:.3e} "
                                 f"where the gradient's sign is determined, {d_flip:.3e} where "
                                 f"it is not")
        d_enc = max(float((sg[k] - sc[k]).abs().max()) for k in enc)
        line = {"loss_rel": d_loss, "norm_rel": d_norm, "bn_rel": d_bn, "bn_abs": d_bn_abs,
                "dec_grad_of_bound": d_grad, "dec_param_abs": d_param, "dec_sign_flips": flips,
                "dec_sign_flip_abs": d_flip, "enc_param_abs": d_enc}
        text = ""
        if on:
            torch.set_num_threads(max(1, threads // 2))
            try:
                gc2 = run(net_c, on)[2]
            finally:
                torch.set_num_threads(threads)
            line["enc_grad_rel"] = group_rel(gg, gc, enc)
            line["enc_grad_rel_cpu_vs_cpu"] = group_rel(gc2, gc, enc)
            enc_bound = 2 * cf.opt_cnn_adam_learning_rate + TRAIN_PARAM_ATOL
            if line["enc_grad_rel"] > TRAIN_ENC_GRAD_REL or d_enc > enc_bound:
                raise AssertionError(f"train parity {tag}: encoder gradients "
                                     f"{line['enc_grad_rel']:.3e} of their norm, weights {d_enc:.3e}")
            text = (f"; encoder group: gradients |d| {line['enc_grad_rel']:.2e} of their norm (the "
                    f"CPU against itself at {max(1, threads // 2)} threads, not {threads}: "
                    f"{line['enc_grad_rel_cpu_vs_cpu']:.2e}), weights max |d| {d_enc:.2e}")
        elif d_enc != 0.0:
            raise AssertionError(f"train parity {tag}: the frozen encoder moved by {d_enc:.3e}")
        log(f"[train parity fp32 {tag}, TF32 off] {smi}: batch {TRAIN_PARITY_B}, card vs CPU: "
            f"loss {lg:.7f} vs {lc:.7f} (rel {d_loss:.2e}), LSTM grad norm rel {d_norm:.2e}, BN "
            f"running statistics max |d| {d_bn_abs:.2e} (relative to max(1, |v|) {d_bn:.2e}); "
            f"decoder group: gradients max |d| {d_grad:.2e} of their bound, weights max |d| "
            f"{d_param:.2e} where the gradient is past its bound ({flips} elements of gradients "
            f"0 within it moved past {TRAIN_PARAM_ATOL}, max |d| {d_flip:.2e}){text}")
        out[tag] = line
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one end-to-end decode of each path with "
                         "torch.profiler; the kernel tables go to DIR/profile_e2e_<path>.txt")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "adaptive_tpu_torch", "ops", "cuda", "csrc")):
        print("chip_smoke.py: adaptive_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from adaptive_tpu_torch.ops.cuda import build

    # phase 1: the card, versions, the kernels' build
    smi = smi_line()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    log(f"[build] {os.path.basename(lib)} built/loaded in {time.perf_counter() - t0:.2f} s")

    # phase 2: each kernel against its plain twin at the main path's shapes
    warm_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {dt: kernel_checks(dt) for dt in ("float32", "bfloat16")}

    # phase 2b: the beam kernels against their twins, beam 3 timed, beam 5 checked
    for dt in ("float32", "bfloat16"):
        checks[dt].update(beam_kernel_checks(dt, BEAM))
        beam_kernel_checks(dt, 5, timed=False)

    # phase 3: the greedy path end to end, bf16, full width
    from adaptive_tpu_torch import Config

    images_u8 = seeded_images(B, SEED)
    cf = Config(compute_dtype="bfloat16")
    model, net = random_model(cf, "cuda", images_u8[:32])
    launches, e2e = end_to_end(model, net, cf, images_u8, smi, args.profile)

    # phase 3b: beam search end to end on the same model and images
    beam_launches, e2e_beam = beam_end_to_end(model, net, cf, images_u8, smi, args.profile)
    launches.update(beam_launches)

    # phase 2c, run after the exact paths so that phases 3 and 3b meet the
    # card fresh from the decode kernels' checks: the int8 kernels against
    # their twins
    del model
    torch.cuda.empty_cache()
    int8_checks = int8_kernel_checks()

    # phase 5: the int8 encoder end to end, modes (a), (t), (b), (c)
    int8_launches, e2e_int8 = int8_end_to_end(net, cf, images_u8, smi, args.profile)
    launches["bottleneck_identity_int8"] = int8_launches["b"]["bottleneck_identity_int8"]
    launches["tail_conv1_int8"] = int8_launches["c"]["tail_conv1_int8"]

    # phases 4 and 4b: fp32 greedy ids and beams on the card equal the CPU's
    fp32 = fp32_models(images_u8)
    cross_device_parity(*fp32, images_u8)
    beam_parity(*fp32, images_u8)

    # phase 6: int8 in fp32, card vs CPU, modes (a) and (c)
    int8_parity(fp32[0], fp32[2], fp32[4])

    # phase 7a: the eval driver over a 5,000-image split, bf16, on phase 3's
    # weights
    del images_u8
    t0 = time.perf_counter()
    eval_line = eval_driver(net, cf, smi)
    del net
    torch.cuda.empty_cache()

    # phase 7b: the eval driver in fp32, card vs CPU, and valid mode from a
    # model.npz
    t1 = time.perf_counter()
    eval_line["parity_fp32"] = eval_parity(*fp32, smi)
    eval_line["phase_s"] = {"7a": t1 - t0, "7b": time.perf_counter() - t1}
    log(f"[eval phases] 7a {eval_line['phase_s']['7a']:.1f} s, 7b {eval_line['phase_s']['7b']:.1f} s")

    # phase 8: training; 8a the step's throughput at batch 256, 8b main_train
    # end to end, 8c one fp32 step card vs CPU on phase 4's weights
    t2 = time.perf_counter()
    train_line = {"card": smi, "step": train_throughput(smi, args.profile)}
    t3 = time.perf_counter()
    train_line["main_train"] = train_loop(smi)
    t4 = time.perf_counter()
    train_line["parity_fp32"] = train_parity(fp32[0], fp32[2], fp32[4], smi)
    train_line["phase_s"] = {"8a": t3 - t2, "8b": t4 - t3, "8c": time.perf_counter() - t4}
    log(f"[train phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in train_line["phase_s"].items()))

    csrc = "adaptive_tpu_torch/ops/cuda/csrc/"
    sources = {
        "adaptive_decode_cell_fused": ("adaptive_tpu/ops/pallas/fused_step.py:221",
                                       csrc + "cell_mma.cuh"),
        "greedy_head_argmax": ("adaptive_tpu/ops/pallas/fused_step.py:354",
                               csrc + "fused_step.cu"),
        "adaptive_decode_cell_fused_beam": ("adaptive_tpu/ops/pallas/fused_step.py:221",
                                            csrc + "cell_mma.cuh"),
        "beam_head_topk": ("adaptive_tpu/ops/pallas/fused_step.py:448", csrc + "head_topk.cu"),
    }
    kernels = []
    for name, (replaces, source) in sources.items():
        bf, fp = checks["bfloat16"][name], checks["float32"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "dtype": "bfloat16",
            # the heads: each launch after a 256 MB write (L2 cold); the
            # cells: the instance, its plan and each stage alone
            **{k: bf[k] for k in ("cold_ms", "library_cold_ms", "instance", "plan", "stage_ms")
               if k in bf},
            "fp32": {k: fp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        })
    int8_sources = {
        "bottleneck_identity_int8": ("adaptive_tpu/ops/pallas/fused_block.py:137",
                                     csrc + "fused_block.cu"),
        "tail_conv1_int8": ("adaptive_tpu/ops/pallas/fused_tail.py:91", csrc + "fused_tail.cu"),
    }
    for name, (replaces, source) in int8_sources.items():
        # per decode: the launch-weighted sums over the four layers' shapes
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], **int8_summary(int8_checks[name]), "library_ms": None,
            "dtype": "int8", "per_layer": int8_checks[name]})
    log(json.dumps({"kernels": kernels, "end_to_end_bf16": e2e,
                    f"end_to_end_beam{BEAM}_bf16": e2e_beam,
                    **{f"end_to_end_int8_{t}_bf16": v for t, v in e2e_int8.items()},
                    "card": smi}))
    log(json.dumps({"eval_driver": eval_line}))
    log(json.dumps({"train": train_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
