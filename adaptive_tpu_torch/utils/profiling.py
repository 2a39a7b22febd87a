"""Profiling harness: wall-clock timers + torch.profiler traces (counterpart
of adaptive_tpu/utils/profiling.py).

``Timer`` times steps on the host clock; ``stop`` waits for the card first
(``torch.cuda.synchronize``, where JAX blocks on the step's arrays), so the
device work is inside the sample. ``profile_trace`` records the CPU and CUDA
activity of its block with torch.profiler and writes a gzipped Chrome trace
under ``logdir``, which utils/trace_report.py summarises.

``span(name)`` marks a phase of the port (the train step's forward,
backward and optimizer, the loader's wait, the device prefetch, the greedy
decoder's encoder and loop; the function that opens a span names it in its
docstring). A span records only while a torch profiler runs on the calling
thread (``profile_trace``, a benchmark's traced slice): then it opens a
``torch.profiler.record_function`` range of its name, which a trace with
CPU activity shows as a ``user_annotation``, and keeps its name, start,
end, parent and thread in memory, where ``take_spans()`` collects them. A
trace with CUDA activity alone holds no such range, but its device events
and CUDA runtime calls are on the same clock as the kept spans. With no
profiler running a span costs one check and records nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import List, NamedTuple, Optional

import torch

# spans kept between two take_spans() calls; those past it are counted
SPAN_CAP = 100_000


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


class Span(NamedTuple):
    """A finished span. start_ns and end_ns are time.time_ns(): the clock of
    a torch.profiler Chrome trace's ``ts`` (us) plus its
    ``baseTimeNanoseconds``. parent: the index, in the same take_spans()
    list, of the span open on the same thread when this one opened (None at
    the thread's top level). thread: threading.get_native_id(), the ``tid``
    of the thread's events in a trace."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int


class _SpanRecorder:
    """The spans of the running profiler's sessions, kept in memory up to
    ``cap``; a record is [name, start_ns, end_ns, parent record, thread]."""

    def __init__(self, cap: int):
        self.cap = cap
        self.dropped = 0
        self._records: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def start(self, name: str, start_ns: int) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rec = [name, start_ns, 0, stack[-1] if stack else None, threading.get_native_id()]
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(rec)
            else:
                self.dropped += 1
        stack.append(rec)
        return rec

    def end(self, rec: list) -> None:
        self._local.stack.pop()
        rec[2] = time.time_ns()

    def take(self) -> List[Span]:
        with self._lock:
            records, self._records = self._records, []
            dropped, self.dropped = self.dropped, 0
        if dropped:
            warnings.warn(f"{dropped} spans past the cap of {self.cap} were not kept")
        done = [r for r in records if r[2]]  # those still open are left out
        index = {id(r): i for i, r in enumerate(done)}
        return [Span(r[0], r[1], r[2], None if r[3] is None else index.get(id(r[3])), r[4])
                for r in done]


_RECORDER = _SpanRecorder(SPAN_CAP)
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class _OpenSpan:
    __slots__ = ("name", "_range", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._record = _RECORDER.start(self.name, time.time_ns())
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _RECORDER.end(self._record)
        return False


def span(name: str):
    """A context manager that marks a phase of the port (module docstring).
    It records only while a torch profiler runs on this thread, and never
    while torch.export or torch.compile traces the code, so that a traced
    program holds no profiler operator; otherwise it is a shared no-op."""
    if not _profiler_enabled() or torch.compiler.is_compiling():
        return _NO_SPAN
    return _OpenSpan(name)


def take_spans() -> List[Span]:
    """The finished spans recorded since the last call, in the order they
    opened; clears them."""
    return _RECORDER.take()
