#!/usr/bin/env python3
"""Minimal captioning HTTP server over the PyTorch port's CaptionService
(stdlib only; twin of examples/serve.py).

    python3 examples/torch_serve.py --vocab data/vocab.json --checkpoint <ckpt> --port 8000
    curl -X POST --data-binary @photo.jpg http://localhost:8000/caption

POST /caption with raw JPEG/PNG bytes -> {"caption": "...", "beta": [...]}.
GET /healthz (worker alive), /readyz (warmed), /statz (counters+histograms).
Oversized bodies get 413; a full queue gets 503 (load shedding). The model
runs on the CUDA card; Pillow decodes the request bodies.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_server(service, port: int, max_body_mb: float = 10.0) -> ThreadingHTTPServer:
    """HTTP front end over a CaptionService (factored out for tests)."""
    from PIL import Image

    size = service.image_size
    max_body = int(max_body_mb * 1024 * 1024)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                ok = service.healthy()
                self._json(200 if ok else 503, {"healthy": ok})
            elif self.path == "/readyz":
                ok = service.ready()
                self._json(200 if ok else 503, {"ready": ok})
            elif self.path == "/statz":
                self._json(200, service.stats())
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/caption":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body:
                # drain (bounded) so the client can finish sending and read
                # the 413 instead of hitting a broken pipe mid-upload
                remaining = min(length, 8 * max_body)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.send_error(413, f"body {length} bytes > limit {max_body}")
                return
            body = self.rfile.read(length)
            try:
                with Image.open(io.BytesIO(body)) as im:
                    img = np.asarray(im.convert("RGB").resize((size, size)), np.uint8)
            except Exception as e:  # any undecodable body is the client's fault
                self.send_error(400, f"{type(e).__name__}: {e}")
                return
            result = service.caption(img, timeout=30)
            if "error" in result:
                code = 503 if result["error"] in ("overloaded", "service closed",
                                                  "timeout") else 400
                self._json(code, result)
            else:
                self._json(200, result)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer(("", port), Handler)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", required=True)
    ap.add_argument("-c", "--config", default="", help="optional config.py/json with model dims")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--model", default="adaptive_attention")
    ap.add_argument("--backbone", default="resnet152")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beam", type=int, default=1)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-body-mb", type=float, default=10.0,
                    help="reject request bodies larger than this (413)")
    ap.add_argument("--quant", default=None, choices=["none", "int8"],
                    help="encoder quantization (int8 needs --calib-glob); "
                         "defaults to the config file's encoder_quant")
    ap.add_argument("--calib-glob", default="",
                    help="glob of images for int8 PTQ calibration")
    ap.add_argument("--calib-n", type=int, default=32)
    args = ap.parse_args(argv)

    from adaptive_tpu_torch.config import Config, load_config
    from adaptive_tpu_torch.data.vocab import Vocabulary
    from adaptive_tpu_torch.serving import CaptionService

    vocab = Vocabulary.load(args.vocab)
    if args.config:
        cf = load_config(args.config).replace(eval_batch_size=args.batch, beam_size=args.beam)
    else:
        cf = Config(atten_model_name=args.model, encoder_backbone=args.backbone,
                    eval_batch_size=args.batch, beam_size=args.beam)
    if args.quant is not None:  # only override when explicitly passed
        cf = cf.replace(encoder_quant=args.quant)
    calib = None
    if cf.encoder_quant == "int8":
        import glob as globlib

        from PIL import Image

        paths = sorted(globlib.glob(args.calib_glob))[: args.calib_n]
        if not paths:
            raise SystemExit("--quant int8 needs --calib-glob matching images")
        s = cf.resized_image_size
        calib = np.stack(
            [np.asarray(Image.open(p).convert("RGB").resize((s, s)), np.uint8) for p in paths])
    service = CaptionService(cf, vocab, checkpoint=args.checkpoint, batch_size=args.batch,
                             calibration_images=calib, device=device)
    print("warming up...")
    service.warmup()
    server = build_server(service, args.port, args.max_body_mb)
    print(f"serving on :{args.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
