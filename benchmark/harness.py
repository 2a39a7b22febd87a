"""The benchmark's harness: finds a cell by name and runs it.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name in BENCHMARK.json:

* ``configs/<config>.json``: the port's Config knobs as they are run, with
  the source and what was assumed;
* ``traffic/<traffic>.json``: a mix's parameters, its ``kind`` and the
  limits of the numbers that decide ``correct``;
* ``kinds/<kind>.py``: the one driver of a kind of traffic (``run(ctx)``);
* ``metrics/<metric>.py``: one reader a per-layer metric (``read(ctx)``,
  None where it finds nothing to read);
* ``later.json``: cells kept out of BENCHMARK.json, with their metrics, in
  its form; the tools and tests still run them (``with_later``).

A run: set-up, a measured window of ``--seconds``, with ``--trace 1`` a
profiled slice of it and the per-layer readers, the peak of device memory,
then the comparison with the plain reference (``reference/``), once the
program's state is freed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adaptive_tpu")


class RunFailed(RuntimeError):
    """A run that prints no result."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def with_later(spec: Dict) -> Dict:
    """spec with later.json's cells and metrics added (those whose names it
    lacks), for the tools and tests that still run them; the benchmark's
    own runs read BENCHMARK.json alone."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in spec.items()}
    for key, entries in load_json(HERE / "later.json").items():
        names = {e["name"] for e in out[key]}
        out[key] += [e for e in entries if e["name"] not in names]
    return out


def cell_spec(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise RunFailed(f"no workload {name!r} in BENCHMARK.json")


def _in_cell(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_metrics(spec: Dict, cell: str) -> List[Dict]:
    return [m for m in spec["end_to_end"] if _in_cell(m, cell)]


def per_layer_metrics(spec: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those whose workloads list
    it. Every per-layer entry of this benchmark lists its cells."""
    unlisted = [m["name"] for m in spec["per_layer"] if "workloads" not in m]
    if unlisted:
        raise RunFailed(f"per-layer metrics without a workloads list: {unlisted}")
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def load_reader(name: str, base: Path = HERE):
    """The module metrics/<name>.py (a name may hold dots)."""
    path = base / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def smi() -> str:
    """The card's name, SM clock and power limit from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class Context:
    """What a kind's driver and the metric readers share."""

    def __init__(self, spec: Dict, cell: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, base: Path = HERE):
        self.spec, self.cell, self.seed, self.seconds, self.trace = spec, cell, seed, seconds, trace
        self.device, self.t_start, self.base = device, t_start, base
        w = cell_spec(spec, cell)
        self.config = load_json(base / "configs" / f"{w['config']}.json")
        self.traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
        self.chips = w["chips"]
        self.e2e: Dict[str, float] = {}  # the driver's end-to-end values
        self.layer: Dict[str, float] = {}  # the per-layer values read
        self.numbers: Dict[str, Optional[float]] = {}  # compared with the limits
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.memory_peak = 0
        self.events: Optional[List[dict]] = None  # the traced slice's trace
        self.slice: Dict = {}  # the traced slice's iterations and wall seconds
        self.work: Dict = {}  # the window's model FLOPs and seconds
        self.handles: Dict = {}  # program objects a reader may time (freed after)
        self.memo: Dict = {}  # measurements shared by readers
        self.overrides: Dict = {}  # Config knobs a control run changes
        self.marks: List = []  # (label, seconds since the process started)

    def mark(self, label: str) -> None:
        """Note the end of a set-up phase (printed on standard error)."""
        self.marks.append((label, time.perf_counter() - self.t_start))

    def window_starts(self) -> float:
        """Marks the end of set-up; returns the window's start (host clock)."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        self.mark("warm-up")
        return now

    def read_peak(self) -> None:
        import torch

        if self.device != "cpu":
            self.memory_peak = max(torch.cuda.max_memory_allocated(d)
                                   for d in range(self.chips))

    def read_layer_metrics(self) -> None:
        """Read the traced slice's events, then run the cell's per-layer
        readers (trace runs); a reader that finds nothing returns None and
        its metric is left out."""
        if not self.trace:
            return
        if "captured" in self.memo:
            from benchmark.lib.trace import events

            self.events = events(self.memo.pop("captured"))
        for m in per_layer_metrics(self.spec, self.cell):
            v = load_reader(m["name"], self.base).read(self)
            if v is not None:
                self.layer[m["name"]] = float(v)

    def split(self) -> Dict[str, float]:
        if "split" not in self.memo:
            from benchmark.lib.stage_split import stage_split

            self.memo["split"] = stage_split(self.events)
        return self.memo["split"]


def device_record(ctx: Context) -> Dict:
    import torch

    if ctx.device == "cpu":
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": ctx.memory_peak}
    else:
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.chips,
               "memory_peak_bytes": ctx.memory_peak}
    if ctx.trace and ctx.events is not None:
        sp = ctx.split()
        rec.update(busy_s=sp["busy_s"], window_s=sp["window_s"])
    return rec


def breakdown(ctx: Context) -> Optional[Dict]:
    if not (ctx.trace and ctx.events):
        return None
    from benchmark.lib.stage_split import device_op_summary, idle_gaps

    ops = [[n, s] for n, s, _ in device_op_summary(ctx.events)[:10]]
    return {"device_ops": ops, "idle_gaps": [[n, s] for n, s in idle_gaps(ctx.events)]}


def run_cell(spec: Dict, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None, base: Path = HERE,
             log=print, adjust=None) -> Dict:
    """Run one cell; returns the result line's object (the checks last).
    adjust(ctx), where given, changes the run before it starts (a control's
    overrides or a side in the program's place, benchmark/controls.py)."""
    import torch

    from benchmark.reference.compare import judge

    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(spec, cell, seed, seconds, trace, device, t_start, base)
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RunFailed("torch.cuda.is_available() is False: the benchmark runs on the card")
        if torch.cuda.device_count() < ctx.chips:
            raise RunFailed(f"{cell} asks for {ctx.chips} cards, "
                            f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        log(f"[device] {torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} card(s) "
            f"visible, {ctx.chips} used; nvidia-smi name, SM clock, max SM clock, power limit: "
            f"{smi()}", file=sys.stderr)
    if adjust is not None:
        adjust(ctx)
    kind = importlib.import_module(f"benchmark.kinds.{ctx.traffic['kind']}")
    ctx.mark("imports")
    kind.run(ctx, log)
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in ctx.marks), file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RunFailed(f"modules of JAX or of the JAX package are loaded: {found}")
    correct, checks = judge(ctx.numbers, ctx.traffic["limits"])
    if trace:
        metrics = {m["name"]: {"value": ctx.layer[m["name"]], "unit": m["unit"]}
                   for m in per_layer_metrics(spec, cell) if m["name"] in ctx.layer}
    else:
        e2e = dict(ctx.e2e, setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_metrics(spec, cell)}
    for m in metrics.values():
        if m["value"] is None or not math.isfinite(m["value"]):
            raise RunFailed(f"a metric has no finite value: {metrics}")
    out = {"correct": bool(correct), "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": device_record(ctx)}
    bd = breakdown(ctx)
    if bd is not None:
        out["breakdown"] = bd
    out["checks"] = checks
    return out
