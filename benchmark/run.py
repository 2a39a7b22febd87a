#!/usr/bin/env python3
"""The benchmark of adaptive_tpu_torch on NVIDIA cards: one cell a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in BENCHMARK.json from the root of a checkout: set-up
(weights and inputs made on the card from the seed, the cell's shapes
warmed), a window of --seconds, and the comparison of what the window
produced with the plain reference. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, breakdown (traced
runs) and checks (each compared number beside its limit). The checks are
also the last lines of standard error. Exits 1 and prints no result where
there is no card, where fewer cards are visible than the cell asks for,
and where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"  # fixed paths inside the checkout: the second run finds them
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark.harness import RunFailed, load_json, run_cell

    try:
        out = run_cell(load_json(ROOT / "BENCHMARK.json"), args.workload, args.seed,
                       args.seconds, bool(args.trace), t_start=T_START)
    except RunFailed as e:
        print(f"benchmark/run.py: {e}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
