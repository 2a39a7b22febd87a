"""Offline greedy captioning: back-to-back batches of seeded uint8 images
through decoding/greedy.py::make_greedy_decoder, each batch's images in
pinned host memory and its ids read back to the host, as the eval driver
hands them over.

Traffic parameters: batch, pool_batches (distinct batches made at set-up
and cycled), warmup (batches before the window), trace_batches, sample
(captions checked against the reference).

End to end: captions_per_s, the captions whose ids reached the host in the
window over the window's seconds; the window starts at the first timed
batch and ends when the ids of the batch that crosses --seconds are on the
host. Checked: logit_gap (lib/served.py) over a seeded sample of the
window's captions, the longest among them; beta_gap, the sentinel shares
the window returned for them (the adaptive variant's); encoder_gap, the
encoder's outputs of their images, their pool batches encoded whole by the
decoder's own prepared tree once the window has closed.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.lib import flops, trace
from benchmark.lib.images import seeded_images
from benchmark.lib.program import (
    build_port, free_device, port_config, reference_config, seeded_weights, synchronize, to_host,
)
from benchmark.lib.served import program_features, sample_rows, served_check, served_ids
from benchmark.reference.compare import served_length


def run(ctx, log) -> None:
    from adaptive_tpu_torch.decoding import make_greedy_decoder

    tr, config, dev = ctx.traffic, ctx.config, ctx.device
    B = tr["batch"]
    cf = port_config(config, eval_batch_size=B, **ctx.overrides)
    weights = seeded_weights(config, ctx.seed, dev, ctx.mark)
    synchronize(dev)
    ctx.mark("calibration")
    model, net = build_port(cf, weights, dev)
    ctx.mark("weights")
    weights = to_host(weights)
    size = config["resized_image_size"]
    pool = seeded_images(B * tr["pool_batches"], ctx.seed + 2, size, dev).cpu()
    if cf.encoder_quant == "int8":  # a control's int8 encoder, calibrated as served
        from adaptive_tpu_torch.models.infer import calibrate_model

        model = calibrate_model(model, cf, net, pool[:32].numpy())
    if dev != "cpu":
        pool = pool.pin_memory()
    batches = [pool[i * B:(i + 1) * B] for i in range(tr["pool_batches"])]
    ctx.mark("images")
    decode = make_greedy_decoder(model, cf)
    for i in range(tr["warmup"]):
        decode(net, batches[i % len(batches)]).ids.cpu()
    synchronize(dev)

    t0 = ctx.window_starts()
    ids, betas, n = [], [], 0
    traced = not ctx.trace
    while True:
        if not traced and time.perf_counter() - t0 >= ctx.seconds / 3:
            traced = True
            synchronize(dev)
            captured = {}
            with trace.capture(captured, dev):
                ta = time.perf_counter()
                for _ in range(tr["trace_batches"]):
                    out = decode(net, batches[n % len(batches)])
                    ids.append(out.ids.cpu())
                    betas.append(out.beta)
                    n += 1
                tb = time.perf_counter()
            ctx.memo["captured"] = captured
            ctx.slice = {"iters": tr["trace_batches"], "wall_s": tb - ta}
            continue
        out = decode(net, batches[n % len(batches)])
        ids.append(out.ids.cpu())
        betas.append(out.beta)  # kept on the card, read after the window
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    ctx.e2e["captions_per_s"] = n * B / elapsed
    ctx.work = {"flops": n * flops.decode_flops(reference_config(config), B), "s": elapsed}
    ctx.attempted, ctx.failed = n * B, 0
    ctx.read_peak()
    ctx.handles = {"model": model, "net": net, "decode": decode, "cf": cf,
                   "images": batches[0].to(dev)}
    ctx.read_layer_metrics()
    ctx.handles = {}
    beta = torch.cat(betas).float().cpu()

    eos = config["decode_eos_token"]
    flat = torch.cat(ids)  # [n * B, L]
    lengths = [served_length(r, eos) for r in flat.tolist()]
    rows = sample_rows(len(lengths), tr["sample"], lengths, ctx.seed)
    # the encoder's outputs of the sampled rows, each pool batch whole, as the window ran it
    prepared = decode.prepare(net)
    whole = {k: program_features(model, prepared, batches[k], cf.train_crop_size)
             for k in sorted({(r // B) % len(batches) for r in rows})}
    features = [torch.stack([whole[(r // B) % len(batches)][j][r % B] for r in rows])
                for j in range(4)]
    del decode, net, model, out, betas, prepared, whole
    free_device(dev)

    images = torch.stack([batches[(r // B) % len(batches)][r % B] for r in rows])
    served = [served_ids(flat[r], eos) for r in rows]
    adaptive = config["atten_model_name"] == "adaptive_attention"
    ctx.numbers.update(served_check(config, weights, images, served,
                                    [beta[r, :len(s)].tolist() if adaptive else []
                                     for r, s in zip(rows, served)], features, dev,
                                    control=ctx.memo.get("served_control")))
    log(f"[check] {len(rows)} captions, {sum(map(len, served))} served tokens compared",
        file=sys.stderr)
