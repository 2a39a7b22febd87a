"""The device-time split of a torch.profiler Chrome trace, frozen here so
that the yardstick does not move with the program: a copy of
adaptive_tpu_torch/utils/trace_report.py's ``device_events``,
``device_op_summary`` and ``stage_split`` (its STAGES), plus the idle gaps
of the device named by what the host was doing in them."""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation", "cuda_runtime", "cuda_driver")

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


def device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS and e.get("name")]


def _category(name: str) -> str:
    return re.sub(r"(\.\d+)+$", "", name)  # an instance suffix: ".12"


def device_op_summary(events: List[dict]) -> List[Tuple[str, float, int]]:
    """[(kernel name, device seconds, launches)] sorted by time."""
    agg: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    for e in device_events(events):
        cat = _category(e["name"])
        agg[cat] += e["dur"]
        cnt[cat] += 1
    return sorted(((k, v / 1e6, cnt[k]) for k, v in agg.items()), key=lambda t: -t[1])


def stage_of(name: str) -> str:
    for stage, keys in STAGES:
        if any(k in name for k in keys):
            return stage
    return "other"


def busy_intervals(events: List[dict]) -> List[Tuple[float, float]]:
    """The union of the device events' intervals (microseconds), sorted."""
    merged: List[List[float]] = []
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events(events)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def stage_split(events: List[dict]) -> Dict[str, float]:
    """Device seconds of each stage (STAGES, "other" for the rest), with
    "busy_s" (the union of the device intervals), "window_s" (the trace's
    span over all its timed events, host ones included) and "busy_share"."""
    out = {stage: 0.0 for stage, _ in STAGES}
    out["other"] = 0.0
    for e in device_events(events):
        out[stage_of(e["name"])] += e["dur"] / 1e6
    busy = sum(t - s for s, t in busy_intervals(events)) / 1e6
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    window = ((max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)) / 1e6
              if timed else 0.0)
    out.update(busy_s=busy, window_s=window, busy_share=busy / window if window else 0.0)
    return out


def idle_gaps(events: List[dict], top: int = 10) -> List[Tuple[str, float]]:
    """[(host op, idle device seconds)]: each gap between the device's busy
    intervals, inside the trace's window, is charged to the host event
    that overlaps it most (the shortest of equals, the most specific);
    summed by name, the largest `top`."""
    busy = busy_intervals(events)
    host = [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in HOST_CATS and e.get("name")]
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    agg: Dict[str, float] = defaultdict(float)
    host.sort(key=lambda e: e["ts"])
    active: List[dict] = []
    i = 0
    for s, t in gaps:  # sorted: a sweep keeps the host events that reach the gap
        while i < len(host) and host[i]["ts"] < t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e["ts"] + e["dur"] > s]
        best, best_key = "device idle, host untraced", (0.0, 0.0)
        for e in active:
            ov = min(t, e["ts"] + e["dur"]) - max(s, e["ts"])
            key = (ov, -e["dur"])
            if ov > 0 and key > best_key:
                best, best_key = _category(e["name"]), key
        agg[best] += (t - s) / 1e6
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top]
