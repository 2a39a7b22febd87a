"""Teacher-forced training: training/step.py::make_train_step with the
port's DualOptimizer, fed by data/loader.py::TrainBatches and
device_prefetch over an in-memory pool of seeded images with COCO-shaped
captions.

Traffic parameters: batch, encoder_on (fine-tune the trunk from
opt_fine_tune_cnn_start_layer), images (distinct pool images),
captions_per_image, caption_tokens (the length distribution: min, max,
mean, sigma of a shifted log-normal, tokens including <start> and <end>),
buckets, trace_steps. The loader runs as the main path runs it
(training/train_loop.py): cf.dataloader_num_workers threads, its default
prefetch.

Every seed gets the same multiset of caption lengths (quantiles of the
distribution), so the same batches of each bucket an epoch, in another
order. Set-up builds one train step, optimizer and net, and drives them
through one batch of each bucket the window's plan uses (the warm-up) with
the window's call and feed; the reference follows the first three of those
steps from the same weights, batches and crop/flip draws.

End to end: train_images_per_s, the images of the steps issued in the
window over the seconds from the window's start until the last of them has
ended on the card. With --trace 1 the profiled slice is the next
trace_steps steps of the same feed, after the window has closed, so that
the profiler's cost on the host stays out of the window's seconds.
Checked: loss_gap (each of the three steps' loss), grad_gap (the first
step's gradient as the optimizer holds it, a leaf's norm),
top_stage_grad_gap (the same over the trained trunk's last stage),
change_gap (each leaf's change over the three steps), bn_gap (each BN
running statistic's change), nonfinite_losses (the window's and the
slice's).
"""

from __future__ import annotations

import collections
import math
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import flops, trace
from benchmark.lib.images import seeded_images
from benchmark.lib.program import (
    build_port, free_device, port_config, reference_config, seeded_weights, synchronize,
    to_device, to_host,
)
from benchmark.reference.compare import change_norms, leaf_gaps, norms, worst
from benchmark.reference.model import TRUNK
from benchmark.reference.train import bn_buffers, follow, groups

FOLLOWED = 3  # steps the reference follows


def caption_lengths(spec: Dict, n: int) -> List[int]:
    """n lengths at the distribution's quantiles (i + 0.5) / n: min +
    round(exp(mu + sigma z)), clipped to max, mu set so the mean is mean."""
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]

    def lengths(mu):
        return [min(spec["max"], spec["min"] + round(math.exp(mu + spec["sigma"] * x))) for x in z]

    lo, hi = -5.0, 5.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if sum(lengths(mid)) / n < spec["mean"] else (lo, mid)
    return lengths((lo + hi) / 2)


def plan_buckets(lengths, batch: int, buckets) -> List[int]:
    """The buckets of TrainBatches' batches for these lengths: full batches
    of one bucket, then the leftovers in bucket order, each chunk of a
    batch at its longest member's bucket (short tails dropped)."""
    from adaptive_tpu_torch.data.loader import pad_to_bucket

    counts = collections.Counter(pad_to_bucket(n, buckets) for n in lengths)
    used = {b for b in buckets if counts[b] >= batch}
    left = [b for b in buckets for _ in range(counts[b] % batch)]
    used.update(max(left[s:s + batch]) for s in range(0, len(left) - batch + 1, batch))
    return sorted(used)


class Pool:
    """An in-memory caption dataset as TrainBatches reads one: ids,
    coco.anns[id]["caption"], vocab.encode_caption and __getitem__ ->
    (uint8 image, token ids, image id). Captions are token lists already."""

    def __init__(self, images: np.ndarray, captions: List[List[int]], image_of: List[int]):
        self.images, self.captions, self.image_of = images, captions, image_of
        self.ids = list(range(len(captions)))
        self.coco = type("Anns", (), {"anns": {i: {"caption": c} for i, c in enumerate(captions)}})
        self.vocab = type("Tokens", (), {"encode_caption": staticmethod(list)})

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, i: int):
        return self.images[self.image_of[i]], self.captions[i], self.image_of[i]


def seeded_captions(lengths: List[int], vocab: int, rng) -> List[List[int]]:
    """<start>, random word ids, <end>, for each length."""
    return [[1] + rng.integers(4, vocab, n - 2).tolist() + [2] for n in lengths]


def draws(gen: torch.Generator, batch: int, size: int, crop: int):
    """The crop/flip draws of one step: data augmentation's recipe
    (ops/preprocess.py::draw_crop_flip), on a generator seeded as the
    program's."""
    dev = gen.device
    tops = torch.randint(0, size - crop + 1, (batch,), generator=gen, device=dev)
    lefts = torch.randint(0, size - crop + 1, (batch,), generator=gen, device=dev)
    flips = torch.rand((batch,), generator=gen, device=dev) < 0.5
    return tops, lefts, flips


def run(ctx, log) -> None:
    from adaptive_tpu_torch.data.loader import TrainBatches, device_prefetch, pad_to_bucket
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    tr, config, dev = ctx.traffic, ctx.config, ctx.device
    B, on = tr["batch"], tr["encoder_on"]
    rcfg = reference_config(config)
    size, crop = config["resized_image_size"], config["train_crop_size"]
    cf = port_config(config, train_batch_size=B, **ctx.overrides)
    weights = seeded_weights(config, ctx.seed, dev, ctx.mark)
    synchronize(dev)
    ctx.mark("calibration")
    model, net = build_port(cf, weights, dev)
    ctx.mark("weights")
    dual = make_dual_optimizer(net, cf)
    step = make_train_step(model, dual, cf)
    draw_seed = ctx.seed + 3
    gen = torch.Generator(device=dev).manual_seed(draw_seed)

    rng = np.random.default_rng(ctx.seed)
    images = seeded_images(tr["images"], ctx.seed + 2, size, dev).cpu().numpy()
    n_cap = tr["images"] * tr["captions_per_image"]
    lengths = [int(x) for x in rng.permutation(caption_lengths(tr["caption_tokens"], n_cap))]
    pool = Pool(images, seeded_captions(lengths, config["vocab_length"], rng),
                [i // tr["captions_per_image"] for i in range(n_cap)])
    # the warm-up: a batch of each bucket the plan uses (at least FOLLOWED
    # batches), distinct images, lengths of the pool's in that bucket
    used = plan_buckets(lengths, B, tr["buckets"])
    buckets = [used[i % len(used)] for i in range(max(FOLLOWED, len(used)))]
    if len(buckets) * B > tr["images"]:
        raise ValueError("the warm-up needs a distinct image a row")
    warm_lengths = []
    for b in buckets:
        mine = [n for n in lengths if pad_to_bucket(n, tr["buckets"]) == b]
        warm_lengths += [mine[i % len(mine)] for i in range(B)]
    warm = Pool(images, seeded_captions(warm_lengths, config["vocab_length"], rng),
                list(range(len(warm_lengths))))

    ctx.mark("images")
    prog = {"losses": []}
    followed = []
    w0 = {n: t for n, t in weights.items()}
    trainable = groups(w0, rcfg, on)
    trainable_names = trainable["decoder"] + trainable["encoder"]
    params = dict(net.named_parameters())
    bufs = dict(net.named_buffers())
    for k, batch in enumerate(device_prefetch(iter(TrainBatches(
            warm, B, seed=ctx.seed, buckets=tr["buckets"],
            num_workers=cf.dataloader_num_workers)), dev)):
        if k < FOLLOWED:
            followed.append({n: batch[n].clone() for n in ("images", "captions", "lengths")})
        out = step(net, batch, gen, on)
        if k < FOLLOWED:
            prog["losses"].append(float(out.loss))
        if k == 0:  # the first gradient, from Adam's first moment after one step
            g = {}
            for grp, beta in (("decoder", cf.opt_rnn_adam_alpha), ("encoder", cf.opt_cnn_adam_alpha)):
                opt = dual.group(grp)
                for n in dual.names(grp):
                    st = opt.state.get(params[n])
                    if st:
                        g[n] = (st["exp_avg"] / (1 - beta)).cpu()
            prog["grad1"] = g
            prog["grad_norms"] = norms(g)
        if k == FOLLOWED - 1:
            with torch.no_grad():
                prog["change_norms"] = change_norms(params, w0, trainable_names)
                prog["bn_norms"] = change_norms(bufs, w0, bn_buffers(w0))
    synchronize(dev)
    weights = to_host(weights)
    del w0

    loader = TrainBatches(pool, B, seed=ctx.seed, buckets=tr["buckets"],
                          num_workers=cf.dataloader_num_workers)

    def epochs():
        while True:
            yield from loader

    src = epochs()
    feed = device_prefetch(src, dev)
    losses, shapes = [], []
    t0 = ctx.window_starts()
    for batch in feed:
        losses.append(step(net, batch, gen, on).loss)
        shapes.append(batch["captions"].shape[1])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    ctx.e2e["train_images_per_s"] = len(shapes) * B / elapsed
    ctx.work = {"flops": sum(flops.train_step_flops(rcfg, B, t, on) for t in shapes),
                "s": elapsed}
    ctx.attempted, ctx.failed = len(shapes) * B, 0
    if ctx.trace:  # the profiled slice: the next steps of the same feed, after the window
        captured, T = {}, []
        with trace.capture(captured, dev):
            ta = time.perf_counter()
            for batch in feed:
                losses.append(step(net, batch, gen, on).loss)
                T.append(batch["captions"].shape[1])
                if len(T) == tr["trace_steps"]:
                    break
            synchronize(dev)
            tb = time.perf_counter()
        ctx.memo["captured"] = captured
        ctx.slice = {"iters": len(T), "wall_s": tb - ta,
                     "flops": sum(flops.train_step_flops(rcfg, B, t, on) for t in T)}
    feed.close()
    src.close()
    ctx.numbers["nonfinite_losses"] = float((~torch.isfinite(torch.stack(losses))).sum())
    log(f"[window] {len(shapes)} steps, buckets {dict(collections.Counter(shapes))}, "
        f"{elapsed:.3f} s", file=sys.stderr)
    ctx.read_peak()
    ctx.read_layer_metrics()
    del step, dual, net, model, params, bufs, feed, loader, pool, losses
    free_device(dev)

    ref_gen = torch.Generator(device=dev).manual_seed(draw_seed)
    for batch in followed:
        batch.update(zip(("tops", "lefts", "flips"), draws(ref_gen, B, size, crop)))
    w0 = to_device(weights, dev)
    side = ctx.memo.get("program_side")
    if side is not None:  # a control or a fault in the program's place
        prog = side(w0, rcfg, followed, on)
    ref = follow(w0, rcfg, followed, on)
    ref_read = readings(ref, w0, rcfg, on)
    worst = compare(ctx.numbers, prog, ref_read)
    log(f"[check] worst leaves {worst}; every number "
        f"{ {k: v for k, v in ctx.numbers.items()} }", file=sys.stderr)
    log(f"[check] losses program {prog['losses']} reference {ref_read['losses']}",
        file=sys.stderr)


def readings(run: Dict, w0: Dict[str, torch.Tensor], rcfg: Dict, on: bool) -> Dict:
    """The norms compared, from a reference run (reference/train.py::follow)."""
    g = groups(w0, rcfg, on)
    names = g["decoder"] + g["encoder"]
    return {"losses": run["losses"], "grad1": {n: t.cpu() for n, t in run["grad1"].items()},
            "grad_norms": norms(run["grad1"]),
            "change_norms": change_norms(run["weights"], w0, names),
            "bn_norms": change_norms(run["weights"], w0, bn_buffers(w0))}


def compare(numbers: Dict, prog: Dict, ref: Dict) -> Dict[str, str]:
    """The numbers of two sets of readings: loss_gap, the worst of the three
    steps' relative loss gaps; grad_gap, change_gap and bn_gap, the worst
    leaf's gap of norms (compare.leaf_gaps); grad_median_gap and
    change_median_gap, the median leaf's; top_stage_grad_gap, the worst
    leaf's gradient gap in the trained trunk's last stage (top_stage),
    where the trunk's backward has not yet magnified bf16's rounding.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the gradient and change gaps (they move by
    rounding alone); BN statistics whose change is under a thousandth of
    the median one's, out of bn_gap.
    Returns each worst gap's leaf."""
    numbers["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    moved = quiet_out(ref["grad_norms"])
    gaps = {"grad": leaf_gaps(prog["grad_norms"], moved),
            "change": leaf_gaps(prog["change_norms"], {
                n: v for n, v in ref["change_norms"].items() if n in moved}),
            "bn": leaf_gaps(prog["bn_norms"], quiet_out(ref["bn_norms"]))}
    names = {}
    for k, g in gaps.items():
        numbers[f"{k}_gap"], names[k] = worst(g)
    for k in ("grad", "change"):
        numbers[f"{k}_median_gap"] = statistics.median(gaps[k].values())
    top = top_stage(gaps["grad"])
    if top:
        numbers["top_stage_grad_gap"], names["top_stage_grad"] = worst(top)
    return names


def top_stage(gaps: Dict[str, float]) -> Dict[str, float]:
    """The gaps of the trained trunk's last stage (the ResNet child nearest
    the heads): the leaves whose gradient the trunk's backward has carried
    through the fewest layers."""
    trunk = [n for n in gaps if n.startswith(TRUNK + ".")]
    if not trunk:
        return {}
    last = max(int(n.split(".")[2]) for n in trunk)
    return {n: gaps[n] for n in trunk if int(n.split(".")[2]) == last}


def quiet_out(ref: Dict[str, float]) -> Dict[str, float]:
    med = statistics.median(ref.values())
    return {n: v for n, v in ref.items() if v >= 1e-3 * med}
