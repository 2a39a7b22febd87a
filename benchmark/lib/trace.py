"""A torch.profiler capture of a slice of the window, read back as Chrome
trace events. On the card it records CUDA activity alone: the kernels,
copies and the host's CUDA runtime calls, and no CPU operators, whose
recording would slow the host and widen the device's idle gaps. The trace
file goes to a temporary directory under TMPDIR and is deleted once
read."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List


@contextlib.contextmanager
def capture(out: Dict, device):
    """Profile the body (CUDA activity on the card, CPU operators on the
    CPU); on exit out["profile"] holds the stopped profiler, for `events`
    to read once the window has closed (exporting holds the interpreter
    lock for seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        out["profile"] = prof


def events(out: Dict) -> List[dict]:
    """The Chrome trace events of a capture."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        out.pop("profile").export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def kernel_stats(events: List[dict], names) -> tuple:
    """(total device seconds, launches of names[0]) of the kernels whose
    name contains one of `names`: a launch of a hand kernel that starts
    several CUDA kernels (the bf16 cell's two) is counted by the first."""
    from benchmark.lib.stage_split import device_events

    total, launches = 0.0, 0
    for e in device_events(events):
        if any(n in e["name"] for n in names):
            total += e["dur"] / 1e6
            launches += names[0] in e["name"]
    return total, launches
