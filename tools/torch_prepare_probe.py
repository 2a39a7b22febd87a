#!/usr/bin/env python3
"""Time the host side of a decode on one NVIDIA card: the prepared-weight
cache's check end to end, and the host time of a decode step.

    python3 tools/torch_prepare_probe.py [--rounds 5] [--steps 12] [--step-runs 5]

decoding/greedy.py::prepare_cached reads the version counters of the
model's parameters and buffers (951 for ResNet-152) on every decode call.
This probe builds chip_smoke.py's full-width bf16 model (random weights
from its seed, 1,024 seeded images on the card) and, for the greedy and
beam 3 decoders, times decode(net, images), which checks the counters,
against decode.decode_prepared(prepared, images), which skips the check as
a cache keyed on the module alone does on a hit. The two run in turns
(check, skip, skip, check) for --rounds rounds, each decode on the host
clock up to torch.cuda.synchronize(), as chip_smoke.py times them. Prints
for each path the mean ms of both, their difference and each one's spread,
and the host time of the check alone. Then it decodes --steps steps of
each path --step-runs times more through a model whose decode step stamps its entry on
the host clock and on the card's stream: at the first step the card is
drained and then held by a sleep kernel (~0.1 s), so that the steps queue
without waiting on the card. It prints the median over the runs, and each
run's value, of the host time of a step (the Python, the wrappers' checks
and the launches of the step and of the decoder's bookkeeping around it)
and of the device time of a step run back to back from the queue, and
whether the hold outlasted the host's queueing in every run (if not, the
host waited and its time is not a step's alone). Needs a
CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import timeit

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds of check, skip, skip, check (0: none)")
    ap.add_argument("--steps", type=int, default=12,
                    help="decode steps of the host-time run (few enough for the launch queue)")
    ap.add_argument("--step-runs", type=int, default=5, help="host-time runs a path")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_prepare_probe.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.ops.cuda import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.build()
    build.load()
    images_u8 = cs.seeded_images(cs.B, cs.SEED)
    cf = Config(compute_dtype="bfloat16")
    model, net = cs.random_model(cf, "cuda", images_u8[:32])
    images = torch.as_tensor(images_u8, device="cuda")
    cs.warm_card()

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for name, decode in (("greedy", make_greedy_decoder(model, cf)),
                         (f"beam {cs.BEAM}", make_beam_decoder(model, cf, beam_size=cs.BEAM))):
        if not args.rounds:
            break
        prepared = decode.prepare(net)
        check = lambda: decode(net, images)  # noqa: E731
        skip = lambda: decode.decode_prepared(prepared, images)  # noqa: E731
        for fn in (check, skip):  # warm-up: cuDNN plans, the allocator
            timed(fn)
        ms = {"check": [], "skip": []}
        for _ in range(args.rounds):
            for kind in ("check", "skip", "skip", "check"):
                ms[kind].append(timed(check if kind == "check" else skip))
        host_us = timeit.timeit(lambda: decode.prepare(net), number=200) / 200 * 1e6
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        spread = {k: max(v) - min(v) for k, v in ms.items()}
        print(f"[prepare probe {name} bf16] batch {cs.B}, {args.rounds} rounds: with the check "
              f"{mean['check']:.3f} ms (spread {spread['check']:.3f}), without "
              f"{mean['skip']:.3f} ms (spread {spread['skip']:.3f}); difference "
              f"{mean['check'] - mean['skip']:.3f} ms; the check alone {host_us:.1f} us of host "
              f"time ({decode.prepare.misses} misses, {decode.prepare.hits} hits); all ms "
              f"{ms}", flush=True)

    for name, make in (("greedy", make_greedy_decoder),
                       (f"beam {cs.BEAM}", lambda m, c: make_beam_decoder(m, c, beam_size=cs.BEAM))):
        print(f"[step host {name} bf16] " + step_times(model, cf.replace(
            decode_max_len=args.steps), make, net, images, args.step_runs), flush=True)
    return 0


HOLD_CYCLES = 200_000_000  # the sleep kernel's SM cycles: ~0.1 s at an H100's clocks


def step_times(model, cf, make, net, images, runs) -> str:
    """Host and device time of a decode step of make(model, cf), each step's
    entry stamped on the host clock and recorded as an event on the stream;
    at the first step the card is drained and then held by a sleep kernel,
    so that the steps queue without waiting on the card."""
    import torch

    host, events = [], []

    def stamp():
        if not host:
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
        host.append(time.perf_counter())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    class Stamped(type(model)):
        def greedy_decode_step(self, *a, **k):
            stamp()
            return super().greedy_decode_step(*a, **k)

        def beam_decode_step(self, *a, **k):
            stamp()
            return super().beam_decode_step(*a, **k)

    decode = make(Stamped(*model), cf)
    prepared = decode.prepare(net)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    end.record()
    end.synchronize()
    hold_ms = start.elapsed_time(end)
    host_us, dev_us, held = [], [], True
    for run in range(runs + 1):  # a warm-up, then the stamped runs
        host.clear()
        events.clear()
        decode.decode_prepared(prepared, images)
        torch.cuda.synchronize()
        n = len(host) - 1  # steps between the first and the last stamp
        if run:
            host_us.append((host[-1] - host[0]) / n * 1e6)
            dev_us.append(events[0].elapsed_time(events[-1]) / n * 1e3)
            held &= (host[-1] - host[0]) * 1e3 < hold_ms
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    return (f"{n} steps queued behind a {hold_ms:.3f} ms sleep kernel, {runs} runs (held in "
            f"all: {held}): host {med(host_us):.1f} us a step (median; runs "
            f"{[round(v, 1) for v in host_us]}), device {med(dev_us):.1f} us a step back to back "
            f"(runs {[round(v, 1) for v in dev_us]})")


if __name__ == "__main__":
    sys.exit(main())
