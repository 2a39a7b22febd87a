#!/usr/bin/env python3
"""Time end-to-end decodes of the PyTorch port on one NVIDIA card, at
several batches, for the port found in a given tree.

    python3 tools/torch_decode_timing.py [--tree DIR] [--batches 32,1024] [--runs 10]

Builds chip_smoke.py's full-width bf16 model (ResNet-152 at 224, embed 256,
hidden 512, vocab 10,123, 30 steps; random weights from its seed, BN
calibrated on 32 images) from the adaptive_tpu_torch and chip_smoke.py of
--tree (this checkout by default), and for greedy and beam 3 at each batch
times --runs decodes of seeded images already on the card, each on the
host clock up to torch.cuda.synchronize() after two warm-up decodes, as
chip_smoke.py phase 3 times them. Prints one JSON line: the tree, the card
and, per path and batch, the mean ms, each run's ms and captions/s. Run it
on two trees in turns within one call (A, B, B, A) to compare them. Needs a
CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    ap.add_argument("--batches", default="32,1024")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_timing.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    smi = cs.smi_line()
    batches = [int(b) for b in args.batches.split(",")]
    images = cs.seeded_images(max(batches), cs.SEED)
    cf = Config(compute_dtype="bfloat16")
    model, net = cs.random_model(cf, "cuda", images[:32])
    cs.warm_card()
    out = {"tree": tree, "card": smi, "paths": {}}
    for path, decode in (("greedy", make_greedy_decoder(model, cf)),
                         (f"beam{cs.BEAM}", make_beam_decoder(model, cf.replace(beam_size=cs.BEAM)))):
        for b in batches:
            x = torch.as_tensor(images[:b], device="cuda")
            for _ in range(2):
                decode(net, x)
            torch.cuda.synchronize()
            runs = []
            for _ in range(args.runs):
                t0 = time.perf_counter()
                decode(net, x)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            mean = sum(runs) / len(runs)
            out["paths"][f"{path}_b{b}"] = {"ms": mean, "runs_ms": runs,
                                            "captions_per_s": b / mean * 1e3}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
