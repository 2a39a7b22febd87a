"""The PyTorch port's CaptionService (adaptive_tpu_torch/serving.py) and its
HTTP front end (examples/torch_serve.py) on the CPU: each test of
tests/test_serving.py against the port, and the served captions equal to
the JAX package's CaptionService on the same weights."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from adaptive_tpu.data.vocab import SPECIALS
from adaptive_tpu_torch.data.vocab import Vocabulary
from adaptive_tpu_torch.serving import CaptionService
from tests.torch_port_util import port_cf
from tests.torch_port_util import port_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = SPECIALS + [f"w{i}" for i in range(28)]


def _cf(tiny_cf, **kw):
    return port_cf(tiny_cf, vocab_length=len(WORDS), **kw)


def _img(seed):
    return np.random.default_rng(seed).integers(0, 255, (72, 72, 3), dtype=np.uint8)


def _identity(st):
    return st["requests"] == (
        st["completed"] + st["errors"] + st["shed"] + st["invalid"] + st["timeouts"])


@pytest.fixture(scope="module")
def service(tiny_cf):
    cf = _cf(tiny_cf, eval_batch_size=4, decode_max_len=5)
    svc = CaptionService(cf, Vocabulary(WORDS), batch_size=4, max_wait_ms=30, device="cpu")
    yield svc
    svc.close()


def test_single_request(service):
    out = service.caption(_img(0), timeout=120)
    assert "error" not in out
    assert isinstance(out["caption"], str)
    assert len(out["beta"]) == len(out["caption"].split())


def test_concurrent_requests_batch_together(service):
    imgs = [_img(100 + i) for i in range(6)]
    results = [None] * 6

    def ask(i):
        results[i] = service.caption(imgs[i], timeout=120)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r is not None and "caption" in r for r in results)


def test_deterministic_per_image(service):
    img = _img(2)
    assert service.caption(img, timeout=120)["caption"] == service.caption(img, timeout=120)["caption"]


def test_invalid_inputs_rejected_not_raised(service):
    assert "shape" in service.caption(np.zeros((10, 10, 3), np.uint8))["error"]
    assert "dtype" in service.caption(np.zeros((72, 72, 3), np.float32))["error"]
    assert "numpy" in service.caption([[1, 2]])["error"]
    assert service.healthy()  # the worker survives invalid inputs


def test_health_ready_and_stats(service):
    service.caption(_img(3), timeout=120)
    assert service.healthy() and service.ready()
    st = service.stats()
    assert st["completed"] >= 1 and st["batches"] >= 1
    assert sum(st["latency_ms_hist"].values()) == st["completed"]
    assert sum(st["batch_fill_hist"].values()) == st["batches"]
    # steady serving prepares the weights once; a miss a batch would mean
    # the prepared-weight cache is defeated
    assert st["prepare_cache_misses"] == 1
    assert st["prepare_cache_hits"] == st["batches"] - 1
    assert _identity(st)
    json.dumps(st)  # feeds /statz


def test_http_front_end(service):
    """examples/torch_serve.py: healthz/readyz/statz, a caption round trip,
    413 oversize, 400 non-image, 404."""
    import http.client
    import io

    from PIL import Image

    sys.path.insert(0, os.path.join(REPO, "examples"))
    from torch_serve import build_server

    server = build_server(service, port=0, max_body_mb=0.5)  # ephemeral port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]

        def req(method, path, body=None):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.request(method, path, body=body)
            r = c.getresponse()
            data = r.read()
            c.close()
            return r.status, data

        assert req("GET", "/healthz")[0] == 200
        service.warmup()  # one decode, so readiness holds in any test order
        assert req("GET", "/readyz")[0] == 200
        status, data = req("GET", "/statz")
        assert status == 200 and b"batch_fill_hist" in data

        buf = io.BytesIO()
        Image.fromarray(np.zeros((72, 72, 3), np.uint8)).save(buf, "PNG")
        status, data = req("POST", "/caption", buf.getvalue())
        assert status == 200 and b"caption" in data

        assert req("POST", "/caption", b"x" * (600 * 1024))[0] == 413
        assert req("POST", "/caption", b"not an image")[0] == 400
        assert req("GET", "/nope")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def test_int8_serving_requires_and_uses_calibration(tiny_cf):
    """encoder_quant='int8' without calibration images fails loudly; with
    them the service decodes through the calibrated int8 encoder."""
    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=4, encoder_quant="int8")
    with pytest.raises(ValueError, match="calibration_images"):
        CaptionService(cf, Vocabulary(WORDS), batch_size=2, device="cpu")
    calib = np.random.default_rng(9).integers(0, 255, (4, 72, 72, 3), dtype=np.uint8)
    svc = CaptionService(cf, Vocabulary(WORDS), batch_size=2, calibration_images=calib,
                         device="cpu")
    try:
        assert "caption" in svc.caption(calib[0], timeout=180)
        assert svc.model.int8_scales  # the scales are in the served model
    finally:
        svc.close()


def test_timeout_counted_once_and_worker_survives(tiny_cf):
    """A request whose caller gives up counts under 'timeouts' only; the
    worker skips the reader-less reply, later requests succeed, and the
    counter identity holds."""
    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=4)
    svc = CaptionService(cf, Vocabulary(WORDS), batch_size=2, max_wait_ms=5, device="cpu")
    try:
        img = np.zeros((72, 72, 3), np.uint8)
        # the first batch prepares the weights and waits out the window: a
        # 1 ms deadline loses
        assert svc.caption(img, timeout=0.001)["error"] == "timeout"
        deadline = time.monotonic() + 180
        while svc.stats()["batches"] < 1:  # the worker finishes the abandoned one
            assert time.monotonic() < deadline, "worker never processed the batch"
            time.sleep(0.05)
        st = svc.stats()
        assert st["timeouts"] == 1 and st["completed"] == 0
        assert "caption" in svc.caption(img, timeout=180)  # the worker survived
        st = svc.stats()
        assert _identity(st)
        assert st["completed"] == 1 and st["timeouts"] == 1
    finally:
        svc.close()


def test_mid_delivery_failure_counts_each_request_once(tiny_cf):
    """A failure after the decode (caption conversion) reaches every waiter
    as one error dict: no second reply, no request counted as both
    completed and error."""
    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=4)
    vocab = Vocabulary(WORDS)
    # a 2 s window puts both requests in one batch of 2
    svc = CaptionService(cf, vocab, batch_size=2, max_wait_ms=2000, device="cpu")
    calls = {"n": 0}
    real = svc.vocab.decode_ids

    def flaky(ids):
        calls["n"] += 1
        if calls["n"] == 2:  # second row of the first batch
            raise RuntimeError("boom")
        return real(ids)

    svc.vocab = type("V", (), {"decode_ids": staticmethod(flaky)})()
    try:
        img = np.zeros((72, 72, 3), np.uint8)
        results = [None, None]

        def ask(i):
            results[i] = svc.caption(img, timeout=180)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        assert all("boom" in r.get("error", "") for r in results), results
        st = svc.stats()
        assert st["errors"] == 2 and st["completed"] == 0
        assert _identity(st)
        svc.vocab = vocab  # the worker survived; service resumes
        assert "caption" in svc.caption(img, timeout=180)
    finally:
        svc.close()


def test_overload_shedding(tiny_cf):
    """A full queue sheds with 'overloaded' instead of blocking."""
    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=4)
    svc = CaptionService(cf, Vocabulary(WORDS), batch_size=2, max_wait_ms=1, max_queue=1,
                         device="cpu")
    try:
        svc._stop.set()  # freeze the worker so the queue cannot drain
        svc._worker.join(timeout=10)
        assert not svc._worker.is_alive()
        img = np.zeros((72, 72, 3), np.uint8)
        svc._stop.clear()  # allow enqueue; the worker stays stopped
        svc._queue.put_nowait((img, 0.0, None, {"abandoned": False, "claimed": False}))
        out = svc.caption(img, timeout=5)
        assert out["error"] == "overloaded"
        assert svc.stats()["shed"] == 1
    finally:
        svc._stop.set()


def test_close_fails_queued_requests(tiny_cf):
    """close() answers a request still in the queue with 'service closed'
    and counts it once, as an error."""
    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=4)
    svc = CaptionService(cf, Vocabulary(WORDS), batch_size=2, device="cpu")
    svc._stop.set()
    svc._worker.join(timeout=10)
    assert not svc._worker.is_alive()
    import queue

    reply = queue.Queue(1)
    svc._queue.put_nowait((_img(5), 0.0, reply, {"abandoned": False, "claimed": False}))
    svc.close()
    assert reply.get(timeout=5) == {"error": "service closed"}
    assert svc.stats()["errors"] == 1
    assert svc.caption(_img(5))["error"] == "service closed"


def test_two_phase_service_matches_default(tiny_cf):
    """scan_prefix + early_exit at the service level give the default
    service's caption (scan_prefix changes nothing in the port; early exit
    keeps the ids)."""
    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=5)
    img = _img(3)
    fixed = CaptionService(cf, Vocabulary(WORDS), batch_size=2, max_wait_ms=1, device="cpu")
    try:
        want = fixed.caption(img, timeout=120)["caption"]
    finally:
        fixed.close()
    two = CaptionService(cf, Vocabulary(WORDS), batch_size=2, max_wait_ms=1, early_exit=True,
                         scan_prefix=3, device="cpu")
    try:
        assert two.cf.decode_early_exit and two.cf.decode_scan_prefix == 3
        assert two.caption(img, timeout=120)["caption"] == want
    finally:
        two.close()


def test_checkpoint_restores_into_the_service(tiny_cf, tmp_path):
    """checkpoint= restores a checkpoint dir over the seeded weights: the
    service captions as a service handed the same net does."""
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.training.checkpoint import save_checkpoint

    cf = _cf(tiny_cf, eval_batch_size=2, decode_max_len=5)
    net = build_model(cf, device="cpu").init(7)
    save_checkpoint(str(tmp_path / "cider-0.5000_model-1"), net)
    img = _img(11)
    a = CaptionService(cf, Vocabulary(WORDS), net=net, batch_size=2, max_wait_ms=1, device="cpu")
    b = CaptionService(cf, Vocabulary(WORDS), checkpoint=str(tmp_path / "cider-0.5000_model-1"),
                       batch_size=2, max_wait_ms=1, device="cpu")
    try:
        assert b.caption(img, timeout=120) == a.caption(img, timeout=120)
    finally:
        a.close()
        b.close()


def test_service_defaults_to_cuda(tiny_cf, monkeypatch):
    """No silent CPU fallback: without a card the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CaptionService(_cf(tiny_cf), Vocabulary(WORDS), batch_size=2)


def test_served_captions_equal_jax_service(tiny_cf):
    """The port's service and the JAX package's CaptionService on the same
    fp32 weights (the port's init, BN calibrated on the images, handed to
    JAX through models/jax_params.py) caption four images alike, greedy and
    beam 2."""
    from adaptive_tpu.data.vocab import Vocabulary as JVocabulary
    from adaptive_tpu.serving import CaptionService as JaxService
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.models.jax_params import to_jax
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    imgs = [_img(200 + i) for i in range(4)]
    cf = _cf(tiny_cf, eval_batch_size=4, decode_max_len=5)
    model = build_model(cf, device="cpu")
    net = model.init(3)
    calibrate_bn_(net.encoder.resnet_conv,
                  eval_preprocess(torch.as_tensor(np.stack(imgs)), cf.train_crop_size))
    params, state = to_jax(net.state_dict(), model.arch)
    for beam in (1, 2):
        jcf = tiny_cf.replace(vocab_length=len(WORDS), eval_batch_size=4, decode_max_len=5,
                              beam_size=beam)
        jsvc = JaxService(jcf, JVocabulary(WORDS), params=params, state=state, batch_size=4,
                          max_wait_ms=1)
        tsvc = CaptionService(cf.replace(beam_size=beam), Vocabulary(WORDS), net=net,
                              batch_size=4, max_wait_ms=1, device="cpu")
        try:
            for img in imgs:
                assert tsvc.caption(img, timeout=120)["caption"] == \
                    jsvc.caption(img, timeout=120)["caption"]
        finally:
            jsvc.close()
            tsvc.close()
