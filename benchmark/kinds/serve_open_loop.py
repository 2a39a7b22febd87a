"""Online captioning: serving.py::CaptionService in process, greedy, at a
fixed batch and batching window, under open-loop arrivals from a fixed pool
of client threads.

Traffic parameters: batch, max_wait_ms, rate (requests/s offered), clients
(threads), timeout_s (a request's limit), images (distinct pool images,
cycled), warmup (full batches before the window), trace_s (the profiled
slice), sample (answers checked against the reference).

Arrivals: rate x --seconds requests, their gaps the quantiles (i + 0.5) / n
of an exponential of mean 1 / rate, in an order drawn from the seed, so
every seed offers the same gaps. Each request is due at its time; a free
client thread sends it then, or late when every client is waiting, and the
generator's lateness is printed.

End to end: serve_p95_ms, the 95th percentile over every request due in the
window of its time from due to reply; a shed, failed or unanswered request
counts at timeout_s and is counted in failed. Checked: logit_gap
(lib/served.py) over a seeded sample of the answered requests, the longest
caption among them, its ids read back from the served words; beta_gap,
the sentinel shares the service returned with them; encoder_gap, the
encoder's outputs of their images, in batches of the service's size
through the service's own decoder's prepared tree once the window has
closed.
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib.images import seeded_images
from benchmark.lib.program import (
    build_port, free_device, port_config, seeded_weights, synchronize, to_host,
)
from benchmark.lib.served import program_features, sample_rows, served_check
from benchmark.lib import trace

SPECIALS = ("<pad>", "<start>", "<end>", "<unk>")


def words(vocab_length: int) -> List[str]:
    """A vocabulary of distinct filler words, so that a caption's words give
    back its ids."""
    return list(SPECIALS) + [f"w{i}" for i in range(vocab_length - len(SPECIALS))]


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s after the window's start) of round(rate x seconds)
    requests: exponential quantile gaps in a seeded order."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(np.random.default_rng(seed).permutation(gaps))


class OpenLoop:
    """Requests i = 0, 1, ... sent at t0 + due[i] by a pool of client
    threads, each sending the next due request once it is free: image
    pool[i % len(pool)] to caption(image, timeout=timeout). latency[i]:
    seconds from due to reply, `timeout` for an error (shed, failed or
    timed out); late[i]: seconds the request was sent after it was due;
    answers[i]: the reply, or None."""

    def __init__(self, caption, pool, due, clients: int, timeout: float, t0: float):
        n = len(due)
        self.caption, self.pool, self.due, self.timeout, self.t0 = caption, pool, due, timeout, t0
        self.latency = [math.nan] * n
        self.late = [0.0] * n
        self.answers: List = [None] * n
        self._next = 0
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._client) for _ in range(clients)]
        for t in self._threads:
            t.start()

    def _client(self) -> None:
        while True:
            with self._lock:
                i = self._next
                self._next += 1
            if i >= len(self.due):
                return
            due = self.t0 + self.due[i]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.late[i] = time.perf_counter() - due
            r = self.caption(self.pool[i % len(self.pool)], timeout=self.timeout)
            if "error" in r:
                self.latency[i] = self.timeout
            else:
                self.latency[i] = time.perf_counter() - due
                self.answers[i] = r

    def join(self) -> None:
        for t in self._threads:
            t.join()


class GcPauses:
    """The cyclic collector's pauses while open: (generation, seconds) each."""

    def __init__(self):
        self.pauses: List = []
        self._t0 = None
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def close(self) -> str:
        """Stops noting; a line of the pauses by generation (count, total ms,
        longest ms)."""
        gc.callbacks.remove(self._note)
        parts = []
        for g in range(3):
            ms = [1e3 * s for gen, s in self.pauses if gen == g]
            parts.append(f"gen{g} {len(ms)} ({sum(ms):.3f} ms, longest "
                         f"{max(ms, default=0.0):.3f} ms)")
        return ", ".join(parts)


def p95_ms(latency) -> float:
    """The 95th percentile (nearest rank) of latency seconds, in ms."""
    ms = sorted(1e3 * x for x in latency)
    return ms[min(len(ms) - 1, math.ceil(0.95 * len(ms)) - 1)]


def fill_share(before: Dict, after: Dict, batch: int) -> float:
    """The mean fill of the batches decoded between two stats() readings."""
    n = sum(int(k) * (after["batch_fill_hist"].get(k, 0) - before["batch_fill_hist"].get(k, 0))
            for k in after["batch_fill_hist"])
    b = after["batches"] - before["batches"]
    return n / (b * batch) if b else math.nan


def start_service(config: Dict, tr: Dict, seed: int, dev, overrides: Dict, mark=None):
    """(service, image pool, host weights, {word: id}): CaptionService on the
    seeded weights, warmed by `warmup` full batches of the pool's images."""
    from adaptive_tpu_torch.data.vocab import Vocabulary
    from adaptive_tpu_torch.serving import CaptionService

    B = tr["batch"]
    cf = port_config(config, eval_batch_size=B, **overrides)
    weights = seeded_weights(config, seed, dev, mark)
    _, net = build_port(cf, weights, dev)
    weights = to_host(weights)
    vocab_words = words(config["vocab_length"])
    size = config["resized_image_size"]
    pool = seeded_images(tr["images"], seed + 2, size, dev).cpu().numpy()
    calib = pool[:32] if cf.encoder_quant == "int8" else None  # a control's int8 encoder
    svc = CaptionService(cf, Vocabulary(vocab_words), net=net, batch_size=B,
                         max_wait_ms=tr["max_wait_ms"], calibration_images=calib, device=dev)
    warm = [threading.Thread(target=svc.caption, args=(pool[i % len(pool)],),
                             kwargs={"timeout": None}) for i in range(tr["warmup"] * B)]
    for t in warm:
        t.start()
    for t in warm:
        t.join()
    synchronize(dev)
    return svc, pool, weights, {w: i for i, w in enumerate(vocab_words)}


def run(ctx, log) -> None:
    tr, config, dev = ctx.traffic, ctx.config, ctx.device
    B = tr["batch"]
    svc, pool, weights, ids_of = start_service(config, tr, ctx.seed, dev, ctx.overrides,
                                               ctx.mark)
    ctx.mark("service")

    due = arrivals(tr["rate"], ctx.seconds, ctx.seed)
    n = len(due)
    before = svc.stats()
    t0 = ctx.window_starts()
    pauses = GcPauses()
    load = OpenLoop(svc.caption, pool, due, tr["clients"], tr["timeout_s"], t0)
    if ctx.trace:
        time.sleep(ctx.seconds / 3)
        captured = {}
        with trace.capture(captured, dev):
            ta = time.perf_counter()
            time.sleep(tr["trace_s"])
            tb = time.perf_counter()
        ctx.memo["captured"] = captured
        ctx.slice = {"wall_s": tb - ta}
    load.join()
    log(f"[gc] collections in the window: {pauses.close()}", file=sys.stderr)
    lat, late, answers = load.latency, load.late, load.answers
    after = svc.stats()
    failed = sum(1 for a in answers if a is None)
    ms = sorted(1e3 * x for x in lat)
    p95 = p95_ms(lat)
    ctx.e2e["serve_p95_ms"] = p95
    ctx.attempted, ctx.failed = n, failed
    lateness = sorted(late)
    log(f"[window] {n} requests due over {due[-1]:.3f} s at {tr['rate']} requests/s: "
        f"{failed} failed, p50 {ms[n // 2]:.3f} ms, p95 {p95:.3f} ms, max {ms[-1]:.3f} ms; "
        f"generator lateness p50 {1e3 * lateness[n // 2]:.3f} ms, p99 "
        f"{1e3 * lateness[min(n - 1, math.ceil(0.99 * n) - 1)]:.3f} ms, max "
        f"{1e3 * lateness[-1]:.3f} ms; batches {after['batches'] - before['batches']}, shed "
        f"{after['shed'] - before['shed']}, timeouts {after['timeouts'] - before['timeouts']}, "
        f"queue at the end {after['queue_depth']}", file=sys.stderr)
    ctx.read_peak()
    ctx.memo["fill_share"] = fill_share(before, after, B)
    ctx.read_layer_metrics()

    eos = config["decode_eos_token"]
    done = [i for i in range(n) if answers[i] is not None]
    served = {}
    for i in done:
        toks = [ids_of[w] for w in answers[i]["caption"].split()]
        served[i] = toks + [eos] if len(toks) < config["decode_max_len"] else toks
    rows = ([done[j] for j in sample_rows(len(done), tr["sample"],
                                          [len(served[i]) for i in done], ctx.seed)]
            if done else [])
    images = np.stack([pool[i % len(pool)] for i in rows]) if rows else None
    # the encoder's outputs of the sampled images, in the service's batches
    features = None
    if rows:
        prepared = svc.decode.prepare(svc.net)
        parts = [program_features(svc.model, prepared, images[s:s + B], svc.cf.train_crop_size)
                 for s in range(0, len(rows), B)]
        features = [torch.cat([p[j] for p in parts]) for j in range(4)]
        del prepared
    svc.close()
    del svc
    free_device(dev)
    if not rows:
        ctx.numbers.update(logit_gap=math.inf, beta_gap=math.inf, encoder_gap=math.inf)
        return
    ctx.numbers.update(served_check(config, weights, torch.as_tensor(images),
                                    [served[i] for i in rows],
                                    [answers[i]["beta"] for i in rows], features, dev,
                                    control=ctx.memo.get("served_control")))
