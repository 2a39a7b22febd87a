#!/usr/bin/env python3
"""Time the prepared-weight cache's check end to end on one NVIDIA card.

    python3 tools/torch_prepare_probe.py [--rounds 5]

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
and the host time of the check alone. Needs a CUDA card and nvcc; imports
no JAX.
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
    ap.add_argument("--rounds", type=int, default=5, help="rounds of check, skip, skip, check")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
