#!/usr/bin/env python3
"""Readings that set the limits of `correct` in the hybrid LM decoder's cell
(kinds/offline_decode_hybrid.py), on the card at the cell's own size (the
benchmark's own runs never run this):

    python3 benchmark/hybrid_controls.py --mode <mode> --seeds a,b,c [--seconds 2]

Modes:
* program: the program as it is (a sound run: the lower readings);
* fp8: the reference computed on float8 (e4m3) operands
  (reference/model.py::fp8_operand), the precision one step below the
  configuration's bf16, in the program's place: its image tokens and logits
  are compared, and its own first token at each position is read;
* no_dx: a fault, the program's decode step without D x (kernel 8 handed
  D = 0; the prefill keeps it).

PERF.md gives the readings. One JSON line a seed: {"seed", "mode",
"correct", "checks"}; all seeds run in one process.
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

CELL = "granite_h_micro.greedy.b1024"
MODES = ("program", "fp8", "no_dx")


def adjuster(mode: str, patch=setattr):
    """adjust(ctx) for run_cell; patch(obj, name, value) plants the fault
    (monkeypatch.setattr in a test, which undoes it)."""

    def adjust(ctx):
        if mode == "fp8":
            from benchmark.reference.model import fp8_operand

            ctx.memo["served_control"] = fp8_operand
        elif mode == "no_dx":
            import torch

            from adaptive_tpu_torch.ops import ssm_step as SS

            real = SS.ssm_step

            def without_dx(xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, D, state):
                return real(xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, torch.zeros_like(D),
                            state)

            without_dx.launches = real.launches  # the wrapper counts its launches here
            patch(SS, "ssm_step", without_dx)
        elif mode != "program":
            raise SystemExit(f"no mode {mode!r}: one of {MODES}")
    return adjust


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=MODES, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--workload", default=CELL)
    args = p.parse_args(argv)
    from benchmark.harness import load_json, run_cell

    spec = load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(spec, args.workload, seed, args.seconds, False,
                       adjust=adjuster(args.mode))
        print(json.dumps({"seed": seed, "mode": args.mode, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
