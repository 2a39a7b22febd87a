"""Serving: a captioning service with request micro-batching (counterpart of
adaptive_tpu/serving.py, whose contract it keeps).

One process owns the model; requests are micro-batched to a fixed shape and
decoded by the same greedy or beam decoder as the eval driver. A stdlib HTTP
front end lives in examples/torch_serve.py.

* Fixed batch: requests pad up to ``batch_size`` with the last image; the
  fill ratio is the latency/throughput dial.
* Micro-batching window: the worker waits up to ``max_wait_ms`` to fill a
  batch, so p50 latency stays near one decode plus the window.
* The weights stay on the card: the decoder prepares them once per
  checkpoint (decoding/greedy.py::prepare_cached), and ``stats()`` reports
  its hits and misses.
* One worker thread owns the decoder and launches every kernel, on that
  thread's current CUDA stream; the decoder is the service's own and is
  shared with no other thread.

Hardening: input validation returns an error dict (it never raises into the
caller's thread or stops the worker); a bounded queue (``max_queue``, 8x
the batch by default) sheds requests with {"error": "overloaded"} when full;
``healthy()`` (worker alive) and ``ready()`` (a batch decoded) back /healthz
and /readyz; ``stats()`` gives the counters and the latency and batch-fill
histograms. Each request is counted once: requests == completed + errors +
shed + invalid + timeouts under every race, through a claim-once cell per
request that only the lock changes.

Port differences: the weights come as ``net`` (an Encoder2Decoder), or are
drawn from ``cf.train_random_seed`` and restored from ``checkpoint``
(training/checkpoint.py::restore_model); ``device`` is where the model runs
("cuda" unless the caller asks for the CPU). ``scan_prefix``
(``decode_scan_prefix``) is accepted and changes nothing: the port's decode
loops are Python loops either way (ROADMAP.md §3).
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

# log-spaced latency buckets, milliseconds (upper edges; last is +inf)
_LAT_EDGES_MS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)


class CaptionService:
    """Thread-safe micro-batching captioner.

    caption(image_u8 [S,S,3]) -> {"caption": str, "beta": [float]} (or
    {"error": ...}); blocks until the batched decode completes.
    """

    def __init__(self, cf, vocab, net=None, checkpoint: str = "",
                 batch_size: Optional[int] = None, max_wait_ms: float = 5.0,
                 max_queue: Optional[int] = None,
                 calibration_images: Optional[np.ndarray] = None,
                 early_exit: Optional[bool] = None,
                 scan_prefix: Optional[int] = None,
                 device="cuda"):
        from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
        from adaptive_tpu_torch.models.factory import build_model

        self.vocab = vocab
        # early_exit=None keeps the config's decode_early_exit (an explicitly
        # configured knob is never overwritten); True stops the decode once
        # every row has emitted <end>, with the same ids.
        if early_exit is None:
            early_exit = bool(getattr(cf, "decode_early_exit", False))
        if scan_prefix is None:
            scan_prefix = int(getattr(cf, "decode_scan_prefix", 0))
        self.cf = cf.replace(vocab_length=len(vocab), decode_early_exit=early_exit,
                             decode_scan_prefix=scan_prefix)
        self.batch_size = batch_size or cf.eval_batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.image_size = self.cf.resized_image_size
        self.model = build_model(self.cf, device=device)
        if net is None:
            net = self.model.init(self.cf.train_random_seed)
            if checkpoint:
                from adaptive_tpu_torch.training import checkpoint as ckpt

                ckpt.restore_model(checkpoint, net, self.model.arch)
        self.net = net
        if self.cf.encoder_quant == "int8":
            # static PTQ needs representative data; refusing beats serving
            # with scales from zeros
            if calibration_images is None:
                raise ValueError(
                    "encoder_quant='int8' requires calibration_images "
                    "(uint8 [N,S,S,3], a representative sample)")
            from adaptive_tpu_torch.models.infer import calibrate_model

            self.model = calibrate_model(self.model, self.cf, net, calibration_images)
        self.decode = (make_beam_decoder(self.model, self.cf) if self.cf.beam_size > 1
                       else make_greedy_decoder(self.model, self.cf))
        # each entry: (image, t_enqueue, reply_queue, flags); flags is a
        # {"abandoned": bool, "claimed": bool} cell changed ONLY under
        # self._lock, so exactly one of caller-timeout / worker-delivery
        # claims a request
        self._queue: "queue.Queue[Tuple[np.ndarray, float, queue.Queue, Dict]]" = queue.Queue(
            maxsize=max_queue if max_queue is not None else 8 * self.batch_size)
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._lock = threading.Lock()
        self._counters = {"requests": 0, "completed": 0, "errors": 0,
                          "shed": 0, "invalid": 0, "batches": 0, "timeouts": 0}
        self._lat_hist = [0] * (len(_LAT_EDGES_MS) + 1)
        self._fill_hist = [0] * (self.batch_size + 1)  # index = requests in batch
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ api
    def caption(self, image_u8: np.ndarray, timeout: Optional[float] = 60.0) -> Dict:
        with self._lock:
            self._counters["requests"] += 1
        err = self._validate(image_u8)
        if err:
            with self._lock:
                self._counters["invalid"] += 1
            return {"error": err}
        if self._stop.is_set():
            with self._lock:  # counted so the counter identity still holds
                self._counters["errors"] += 1
            return {"error": "service closed"}
        reply: "queue.Queue" = queue.Queue(1)
        flags = {"abandoned": False, "claimed": False}
        try:
            self._queue.put_nowait((image_u8, time.monotonic(), reply, flags))
        except queue.Full:
            with self._lock:
                self._counters["shed"] += 1
            return {"error": "overloaded", "queue_depth": self._queue.qsize()}
        if self._stop.is_set():
            # close() may have set _stop and drained the queue between the
            # check above and the put: abandon the request unless the worker
            # or the drain already claimed it (then a reply is coming)
            with self._lock:
                if not flags["claimed"]:
                    flags["abandoned"] = True
                    self._counters["errors"] += 1
                    return {"error": "service closed"}
        try:
            return reply.get(timeout=timeout)
        except queue.Empty:
            # the abandoned flag tells the worker to skip the reader-less
            # reply and count the request under 'timeouts' only; if the
            # worker claimed delivery first, its reply is in flight
            with self._lock:
                if not flags["claimed"]:
                    flags["abandoned"] = True
                    self._counters["timeouts"] += 1
                    return {"error": "timeout", "timeout_s": timeout}
            return reply.get()  # claimed: the put follows the claim

    def warmup(self):
        img = np.zeros((self.image_size,) * 2 + (3,), np.uint8)
        self.caption(img, timeout=None)  # the first batch builds the kernels and prepares

    def healthy(self) -> bool:
        """Liveness: the batching worker is running."""
        return self._worker.is_alive() and not self._stop.is_set()

    def ready(self) -> bool:
        """Readiness: at least one batch decoded."""
        return self.healthy() and self._ready.is_set()

    def stats(self) -> Dict:
        """Counters and histograms (plain ints; JSON-safe).

        prepare_cache_{hits,misses}: the decoder prepares the weights once
        per checkpoint (decoding/greedy.py::prepare_cached); steady serving
        shows misses == 1, and a miss a batch means the weights change
        between batches."""
        prep = self.decode.prepare
        with self._lock:
            return {
                **self._counters,
                "prepare_cache_hits": prep.hits,
                "prepare_cache_misses": prep.misses,
                "queue_depth": self._queue.qsize(),
                "batch_size": self.batch_size,
                "latency_ms_hist": {
                    **{f"le_{e}": c for e, c in zip(_LAT_EDGES_MS, self._lat_hist)},
                    "inf": self._lat_hist[-1],
                },
                "batch_fill_hist": {str(n): c for n, c in enumerate(self._fill_hist) if n},
            }

    def close(self):
        """Stop the worker and fail any queued request."""
        self._stop.set()
        self._worker.join(timeout=10)
        while True:  # drain: callers must not block forever
            try:
                _, _, reply, flags = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                if flags["abandoned"]:
                    continue
                flags["claimed"] = True
                self._counters["errors"] += 1
            reply.put({"error": "service closed"})

    # ------------------------------------------------------------- internals
    def _validate(self, img) -> str:
        if not isinstance(img, np.ndarray):
            return f"image must be a numpy array, got {type(img).__name__}"
        if img.dtype != np.uint8:
            return f"image dtype must be uint8, got {img.dtype}"
        s = self.image_size
        if img.shape != (s, s, 3):
            return f"image shape must be ({s}, {s}, 3), got {tuple(img.shape)}"
        return ""

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._process(batch)

    def _process(self, batch):
        n = len(batch)
        images = np.stack([b[0] for b in batch] + [batch[-1][0]] * (self.batch_size - n))
        try:
            # everything that can raise happens before any claim, so a
            # failure reaches the error path with no request claimed: each
            # waiter gets one reply and is counted once
            out = self.decode(self.net, images)
            ids = out.ids.cpu().numpy()
            betas = out.beta.float().cpu().numpy()
            replies = []
            for i in range(n):
                caption = self.vocab.decode_ids(ids[i])
                n_words = len(caption.split())
                replies.append({"caption": caption,
                                "beta": [float(b) for b in betas[i][:n_words]]})
        except Exception as e:  # surface errors to every live waiter
            with self._lock:
                live = [b for b in batch if not b[3]["abandoned"]]
                for b in live:
                    b[3]["claimed"] = True
                self._counters["errors"] += len(live)
            for _, _, reply, _ in live:
                reply.put({"error": f"{type(e).__name__}: {e}"})
            return
        done = time.monotonic()
        with self._lock:  # claim delivery atomically against caller timeouts
            live = [b for b in batch if not b[3]["abandoned"]]
            for b in live:
                b[3]["claimed"] = True
            self._counters["batches"] += 1
            self._counters["completed"] += len(live)
            self._fill_hist[n] += 1
            for _, t0, _, _ in live:
                ms = (done - t0) * 1e3
                self._lat_hist[bisect.bisect_left(_LAT_EDGES_MS, ms)] += 1
        self._ready.set()
        for (_, _, reply, flags), r in zip(batch, replies):
            if flags["claimed"]:  # not claimed: timed out; counted in caption()
                reply.put(r)
