"""Profiling trace reports: summarise a torch.profiler Chrome trace into
device-time tables (counterpart of adaptive_tpu/utils/trace_report.py).

Capture with utils.profiling.profile_trace (or ``chip_smoke.py --profile``),
then

    python -m adaptive_tpu_torch.utils.trace_report DIR [--iters N] [--top K]

prints the card's time by kernel name. The device events of a torch.profiler
trace are its "kernel", "gpu_memcpy" and "gpu_memset" events; the host's
(CPU ops, Python functions, CUDA runtime calls, annotations) are left out.
``stage_split`` files each kernel under the port's stages: the six hand
kernels by name (ops/cuda/csrc), cuDNN's convolutions, cuBLAS's and
CUTLASS's products, PyTorch's elementwise and reduction kernels, copies, and
the rest; and gives the card's busy share of the trace's window.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's stages, tested in this order against a kernel's name
STAGES = (
    ("kernel 1/3 cell", ("cell_gates_kernel", "cell_attend_kernel", "adaptive_cell_kernel")),
    ("kernel 2 head argmax", ("head_argmax_",)),
    ("kernel 4 head top-W", ("head_topk_",)),
    ("kernel 5 int8 block", ("bottleneck_block_kernel",)),
    ("kernel 6 int8 tail", ("tail_conv1_kernel",)),
    ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d")),
    ("gemm (cuBLAS/CUTLASS)", ("gemm", "gemv", "cublas", "cutlass", "dot_kernel")),
    ("elementwise/reduce", ("elementwise", "reduce", "batch_norm", "SoftMax", "index",
                            "gather", "scatter", "upsample", "cat", "sort", "topk")),
    ("memcpy/memset", ("Memcpy", "Memset")),
)


def load_trace_events(trace_dir: str) -> List[dict]:
    """The events of the newest Chrome trace (*.trace.json or
    *.trace.json.gz) under a torch.profiler trace dir."""
    paths = sorted(
        (p for pat in ("*.trace.json", "*.trace.json.gz")
         for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {trace_dir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS and e.get("name")]


def _category(name: str) -> str:
    return re.sub(r"(\.\d+)+$", "", name)  # an instance suffix: ".12"


def device_op_summary(events: List[dict], iters: int = 1) -> List[Tuple[str, float, int]]:
    """[(kernel name, ms per iteration, launches)] sorted by time, host
    events excluded; a trailing instance suffix (".N") is stripped so that
    every instance of a kernel adds up under one name."""
    agg: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    for e in device_events(events):
        cat = _category(e["name"])
        agg[cat] += e["dur"]
        cnt[cat] += 1
    return sorted(((k, v / iters / 1e3, cnt[k]) for k, v in agg.items()), key=lambda t: -t[1])


def stage_of(name: str) -> str:
    for stage, keys in STAGES:
        if any(k in name for k in keys):
            return stage
    return "other"


def stage_split(events: List[dict], iters: int = 1) -> Dict[str, float]:
    """Device ms per iteration of each stage (STAGES, "other" for the rest),
    with "busy_ms" (the union of the device intervals), "window_ms" (the
    trace's span over all its timed events, host ones included) and
    "busy_share" (busy over window)."""
    out = {stage: 0.0 for stage, _ in STAGES}
    out["other"] = 0.0
    spans = []
    for e in device_events(events):
        out[stage_of(e["name"])] += e["dur"]
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    window = (max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
              if timed else 0.0)
    split = {k: v / iters / 1e3 for k, v in out.items()}
    split.update(busy_ms=busy / iters / 1e3, window_ms=window / iters / 1e3,
                 busy_share=busy / window if window else 0.0)
    return split


def format_report(summary: List[Tuple[str, float, int]], top: int = 20) -> str:
    total = sum(ms for _, ms, _ in summary)
    lines = [f"device time: {total:.3f} ms/iter", "-" * 56]
    for cat, ms, n in summary[:top]:
        lines.append(f"{ms:10.3f} ms  {100 * ms / max(total, 1e-9):5.1f}%  x{n:<6} {cat[:100]}")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--iters", type=int, default=1, help="iterations captured in the trace")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    events = load_trace_events(args.trace_dir)
    print(format_report(device_op_summary(events, args.iters), args.top))
    split = stage_split(events, args.iters)
    print("-" * 56)
    print("  ".join(f"{k} {v:.4f}" if k == "busy_share" else f"{k} {v:.3f}"
                    for k, v in split.items()))


if __name__ == "__main__":
    main()
