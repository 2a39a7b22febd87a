"""Profiling harness: wall-clock timers + torch.profiler traces (counterpart
of adaptive_tpu/utils/profiling.py).

``Timer`` times steps on the host clock; ``stop`` waits for the card first
(``torch.cuda.synchronize``, where JAX blocks on the step's arrays), so the
device work is inside the sample. ``profile_trace`` records the CPU and CUDA
activity of its block with torch.profiler and writes a gzipped Chrome trace
under ``logdir``, which utils/trace_report.py summarises.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch


class Timer:
    """Collects step latencies (seconds); stop() synchronises the card (where
    one is in use), so the step's device work is inside the sample."""

    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *block_on):
        """End the sample, after the card has finished its work where one is
        in use. block_on (the step's outputs, which JAX's Timer blocks on)
        is accepted for its contract: the whole card is synchronised."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.samples.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def measure(self, *unused):
        self.start()
        out = []
        yield out
        self.stop(*out)

    def p50(self) -> float:
        s = sorted(self.samples)
        return s[len(s) // 2] if s else float("nan")

    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else float("nan")

    def best(self) -> float:
        return min(self.samples) if self.samples else float("nan")


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """torch.profiler over the block, CPU and (where a card is in use) CUDA
    activity; the Chrome trace lands in logdir as <host>_<pid>.<ms>.pt.trace.
    json.gz (view with perfetto or chrome://tracing; summarise with
    ``python -m adaptive_tpu_torch.utils.trace_report logdir``)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir, use_gzip=True)):
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
