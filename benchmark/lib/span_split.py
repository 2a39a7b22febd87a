"""The traced slice's device and host time split by the port's spans
(adaptive_tpu_torch/utils/profiling.py::span, take_spans).

The slice is the only part of a run under a profiler, so the spans the
program kept are exactly the slice's; a reader takes them once a run
(``ctx.memo``). A program without spans (one older than take_spans, or a
slice that opened none) gives None, and its metrics are left out.

Clocks: a span's start_ns and end_ns are the system clock; a Chrome trace's
``ts`` (us) is that clock less the process's ``baseTimeNanoseconds``, which
lib/trace.py's events leave out, so it is read from an empty trace of the
same process (``trace_base_ns``).

A device event (kernel, copy or set) is launched under a span when the CUDA
runtime call of the same ``correlation`` starts inside the span's interval,
whatever thread made it (the autograd engine launches the backward from its
own thread while the main thread is inside ``train.backward``); it goes to
the innermost such span, the one that opened last. Device-idle time is the
gaps between the device's busy intervals (lib/stage_split.py::idle_gaps'),
split by the innermost span of one thread open in them."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.lib.stage_split import busy_intervals, device_events

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
RUNTIME = "(CUDA runtime call)"  # idle under no span, in a runtime call
UNTRACED = "(no span, no runtime call)"


def trace_base_ns() -> int:
    """This process's baseTimeNanoseconds, from an empty CPU trace."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "base.json")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pass
        prof.export_chrome_trace(path)
        with open(path) as f:
            return int(json.load(f)["baseTimeNanoseconds"])


def spans_us(spans, base_ns: int) -> List[Tuple[float, float, str, int]]:
    """(start, end, name, thread) on the trace's clock (us), by start."""
    return sorted(((s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3, s.name, s.thread)
                  for s in spans)


def union(pairs) -> List[List[float]]:
    """The union of (start, end) intervals, sorted."""
    merged: List[List[float]] = []
    for s, t in sorted(pairs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


class Innermost:
    """The innermost span (the last to open) of those open at a time."""

    def __init__(self, spans: Sequence[Tuple[float, float, str, int]]):
        self.spans = list(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> Optional[str]:
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[i][1] >= t:
                return self.spans[i][2]
        return None


def launched(events: List[dict], spans) -> Dict[Optional[str], float]:
    """Device seconds by the span each event was launched under (None: no
    span, or no runtime call of its correlation in the trace)."""
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    inner = Innermost(spans)
    out: Dict[Optional[str], float] = defaultdict(float)
    for e in device_events(events):
        t = calls.get(e.get("args", {}).get("correlation"))
        out[None if t is None else inner.at(t)] += e["dur"] / 1e6
    return dict(out)


def idle_split(events: List[dict], spans, thread: int) -> Dict[str, float]:
    """Device-idle seconds by the innermost span of `thread` open in them;
    under none, RUNTIME where a CUDA runtime call of any thread runs,
    UNTRACED elsewhere."""
    mine = Innermost([s for s in spans if s[3] == thread])
    calls = union((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in RUNTIME_CATS and "dur" in e)
    call_starts = [c[0] for c in calls]
    cuts = sorted({x for s in mine.spans for x in s[:2]} | {x for c in calls for x in c})
    busy = busy_intervals(events)
    out: Dict[str, float] = defaultdict(float)
    for (_, s), (t, _) in zip(busy, busy[1:]):
        if t <= s:
            continue
        pts = [s] + cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, t)] + [t]
        for a, b in zip(pts, pts[1:]):
            m = (a + b) / 2
            name = mine.at(m)
            if name is None:
                i = bisect.bisect_right(call_starts, m) - 1
                name = RUNTIME if i >= 0 and calls[i][1] >= m else UNTRACED
            out[name] += (b - a) / 1e6
    return dict(out)


def slice_spans(ctx) -> Optional[list]:
    """The slice's spans on the trace's clock (spans_us), taken once a run;
    None where the program kept none."""
    if "spans" not in ctx.memo:
        try:
            from adaptive_tpu_torch.utils.profiling import take_spans
        except ImportError:  # a program without spans
            taken = []
        else:
            taken = take_spans()
        ctx.memo["spans"] = spans_us(taken, trace_base_ns()) if taken else None
    return ctx.memo["spans"]


def _per_step(ctx, seconds: float) -> float:
    return 1e3 * seconds / ctx.slice["iters"]


def _ready(ctx, device: bool) -> bool:
    if not ctx.slice.get("iters") or slice_spans(ctx) is None:
        return False
    return not device or bool(ctx.events and device_events(ctx.events))


def launched_ms(ctx, *names: str) -> Optional[float]:
    """Device ms an iteration of the slice launched under the named spans."""
    if not _ready(ctx, device=True):
        return None
    if "launched" not in ctx.memo:
        ctx.memo["launched"] = launched(ctx.events, slice_spans(ctx))
    return _per_step(ctx, sum(ctx.memo["launched"].get(n, 0.0) for n in names))


def host_ms(ctx, *names: str) -> Optional[float]:
    """Host ms an iteration of the slice inside the named spans."""
    if not _ready(ctx, device=False):
        return None
    return _per_step(ctx, sum(b - a for a, b, n, _ in slice_spans(ctx) if n in names) / 1e6)


def idle_ms(ctx, *names: str) -> Optional[float]:
    """Device-idle ms an iteration of the slice under the named spans of
    the main thread (the innermost open)."""
    if not _ready(ctx, device=True):
        return None
    if "idle_split" not in ctx.memo:
        ctx.memo["idle_split"] = idle_split(ctx.events, slice_spans(ctx),
                                            threading.main_thread().native_id)
    return _per_step(ctx, sum(ctx.memo["idle_split"].get(n, 0.0) for n in names))
