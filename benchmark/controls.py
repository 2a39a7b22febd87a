#!/usr/bin/env python3
"""Readings that set the limits of `correct`, on the card at a cell's own
size (the benchmark's own runs never run this):

    python3 benchmark/controls.py --workload <cell> --mode <mode> --seeds a,b,c [--seconds 2]

Modes:
* program: the program as it is (a sound run: the lower readings);
* int8: the program's own int8 path, one step below the configuration's
  bf16: the int8 encoder (models/infer.py, per-channel, calibrated on
  32 of the cell's images) in a decode or serving cell,
  the int8 convolution backward (ops/quant_conv.py) in a train cell that
  fine-tunes the trunk;
* fp8: the reference computed on float8 (e4m3) operands in the program's
  place (a decode or serving cell: fed the served tokens, its own first
  token at each position is read);
* half: a train cell's fault, half of each batch left out and the mean
  taken over the rest, the reference in the program's place.

PERF.md names each cell's control among these and gives the readings.
One JSON line a seed: {"seed", "mode", "correct", "checks"}; all seeds run
in one process (set-up once for the kernels).
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def adjuster(mode: str):
    from benchmark.reference.model import fp8_operand
    from benchmark.reference.train import follow

    def from_reference(**kw):
        from benchmark.kinds.train_steps import readings

        def side(w0, rcfg, batches, on):
            return readings(follow(w0, rcfg, batches, on, **kw), w0, rcfg, on)
        return side

    def adjust(ctx):
        kind = ctx.traffic["kind"]
        served = kind in ("offline_decode", "serve_open_loop")
        if mode == "half" and not served:
            ctx.memo["program_side"] = from_reference(rows=ctx.traffic["batch"] // 2)
        elif mode == "int8" and served:
            ctx.overrides["encoder_quant"] = "int8"
        elif mode == "int8" and ctx.traffic["encoder_on"]:
            from adaptive_tpu_torch.ops.quant_conv import set_conv_bwd_quant

            set_conv_bwd_quant("int8")
        elif mode == "fp8" and served:
            ctx.memo["served_control"] = fp8_operand
        elif mode == "fp8":
            ctx.memo["program_side"] = from_reference(operand=fp8_operand)
        elif mode != "program":
            raise SystemExit(f"{ctx.cell} has no {mode} mode")
    return adjust


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "int8", "fp8", "half"), required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from benchmark.harness import load_json, run_cell, with_later

    spec = with_later(load_json(ROOT / "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(spec, args.workload, seed, args.seconds, False,
                       adjust=adjuster(args.mode))
        print(json.dumps({"seed": seed, "mode": args.mode, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
