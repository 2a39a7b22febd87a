"""Offline greedy captioning with a hybrid LM decoder (the granite_h_micro
variant, adaptive_tpu_torch/models/hybrid_lm.py): back-to-back batches of
seeded uint8 images through decoding/greedy.py::make_greedy_decoder, each
batch's images in pinned host memory and its ids read back to the host, as
kinds/offline_decode.py runs the LSTM decoders.

Traffic parameters: batch, pool_batches (distinct batches made at set-up
and cycled), warmup (batches before the window), trace_batches, sample
(captions checked against the reference).

End to end: captions_per_s, as kinds/offline_decode.py's. Checked (lib/
hybrid.py::served_check) over a seeded sample of the window's captions, the
longest among them, one a pooled image: logit_gap, the served tokens under
the reference's logits; replay_logit_gap, each sampled row's pool batch,
whole, encoded, prefilled and teacher-forced with the ids the window served
through the same prefill and step functions once the window has closed,
its logits against the reference's one pass; encoder_gap, the image tokens
of that replay against the reference's.

A control (benchmark/hybrid_controls.py) sets ctx.memo["served_control"],
an operand rounding in the program's place, or patches the program before
the run.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.lib import hybrid, trace
from benchmark.lib.images import seeded_images
from benchmark.lib.program import free_device, port_config, synchronize
from benchmark.lib.served import sample_rows, served_ids
from benchmark.reference.compare import served_length
from benchmark.reference.model import slots


def run(ctx, log) -> None:
    # the port's hybrid LM first: a program without it fails here, before any work
    from adaptive_tpu_torch.decoding import make_greedy_decoder
    from adaptive_tpu_torch.models.hybrid_lm import PUBLISHED, HybridCache

    tr, config, dev = ctx.traffic, ctx.config, ctx.device
    B = tr["batch"]
    cf = port_config(config, eval_batch_size=B,
                     hybrid_lm={k: config[k] for k in PUBLISHED}, **ctx.overrides)
    weights = hybrid.seeded_weights(config, ctx.seed, dev, ctx.mark)
    ctx.mark("calibration")
    model, net = hybrid.build_port(cf, weights, dev)
    trunk = hybrid.trunk_part(weights)
    del weights
    free_device(dev)
    ctx.mark("weights")
    size = config["resized_image_size"]
    pool = seeded_images(B * tr["pool_batches"], ctx.seed + 2, size, dev).cpu()
    if dev != "cpu":
        pool = pool.pin_memory()
    batches = [pool[i * B:(i + 1) * B] for i in range(tr["pool_batches"])]
    ctx.mark("images")
    positions = slots(config) + config["decode_max_len"]
    kinds = HybridCache(model.lm, B, positions, model.compute_dtype, "meta").nbytes()
    log("[cache] bytes a batch of " + str(B) + ": " + ", ".join(
        f"{k} {v}" for k, v in kinds.items()) + f", total {sum(kinds.values())}",
        file=sys.stderr)
    decode = make_greedy_decoder(model, cf)
    for i in range(tr["warmup"]):
        decode(net, batches[i % len(batches)]).ids.cpu()
    synchronize(dev)

    t0 = ctx.window_starts()
    ids, n = [], 0
    traced = not ctx.trace
    while True:
        if not traced and time.perf_counter() - t0 >= ctx.seconds / 3:
            traced = True
            synchronize(dev)
            captured = {}
            with trace.capture(captured, dev):
                ta = time.perf_counter()
                for _ in range(tr["trace_batches"]):
                    ids.append(decode(net, batches[n % len(batches)]).ids.cpu())
                    n += 1
                tb = time.perf_counter()
            ctx.memo["captured"] = captured
            ctx.slice = {"iters": tr["trace_batches"], "wall_s": tb - ta}
            continue
        ids.append(decode(net, batches[n % len(batches)]).ids.cpu())
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    ctx.e2e["captions_per_s"] = n * B / elapsed
    ctx.work = {"flops": hybrid.decode_flops(config, n * B), "s": elapsed}
    ctx.attempted, ctx.failed = n * B, 0
    ctx.read_peak()
    ctx.read_layer_metrics()

    eos, start = config["decode_eos_token"], config["decode_start_token"]
    flat = torch.cat(ids)  # [n * B, L]
    lengths = [served_length(r, eos) for r in flat.tolist()]
    rows, seen = [], set()
    for r in sample_rows(len(lengths), tr["sample"], lengths, ctx.seed):
        image = ((r // B) % len(batches), r % B)
        if image not in seen:  # an image served twice is checked once
            seen.add(image)
            rows.append(r)
    # the replay: each sampled row's pool batch whole, fed the ids the window served
    prepared = decode.prepare(net)
    tokens, logits = {}, {}
    for k in sorted({(r // B) % len(batches) for r in rows}):
        mine = [r for r in rows if (r // B) % len(batches) == k]
        first = next(i for i in range(n) if i % len(batches) == k)
        served = flat[first * B:(first + 1) * B].clone()
        for r in mine:
            served[r % B] = flat[r]
        got = hybrid.replay(model, prepared, batches[k], hybrid.fed_ids(served.long(), start),
                            [r % B for r in mine], cf.train_crop_size)
        for r, t, lg in zip(mine, *got):
            tokens[r], logits[r] = t, lg
    del decode, net, model, prepared
    free_device(dev)

    images = torch.stack([batches[(r // B) % len(batches)][r % B] for r in rows])
    served = [served_ids(flat[r], eos) for r in rows]
    ctx.numbers.update(hybrid.served_check(
        config, ctx.seed, trunk, images, served, torch.stack([tokens[r] for r in rows]),
        torch.stack([logits[r] for r in rows]), dev, control=ctx.memo.get("served_control")))
    log(f"[check] {len(rows)} captions, {sum(map(len, served))} served tokens compared",
        file=sys.stderr)
