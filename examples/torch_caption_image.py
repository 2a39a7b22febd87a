#!/usr/bin/env python3
"""Caption a single image with the PyTorch port (twin of
examples/caption_image.py).

    python3 examples/torch_caption_image.py --image photo.jpg --checkpoint <ckpt_dir> \
        --vocab data/vocab.json [--beam 3]

Loads the adaptive-attention model, decodes one image on the CUDA card,
prints the caption and the per-token sentinel gate beta (how much the model
"looked away" from the image, adaptive_attention.py:50-56). ``main(argv,
device)`` takes the device for callers that run it on the CPU; the command
line has no flag for it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--model", default="adaptive_attention")
    ap.add_argument("--backbone", default="resnet152")
    ap.add_argument("--beam", type=int, default=1)
    ap.add_argument("--max-len", type=int, default=30)
    args = ap.parse_args(argv)

    from PIL import Image

    from adaptive_tpu_torch.config import Config
    from adaptive_tpu_torch.data.vocab import Vocabulary
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.training import checkpoint as ckpt

    vocab = Vocabulary.load(args.vocab)
    cf = Config(atten_model_name=args.model, encoder_backbone=args.backbone,
                vocab_length=len(vocab), eval_batch_size=1, decode_max_len=args.max_len,
                beam_size=args.beam)
    model = build_model(cf, device=device)
    net = model.init(0)
    if args.checkpoint:
        ckpt.restore_model(args.checkpoint, net, model.arch)

    with Image.open(args.image) as im:
        img = np.asarray(
            im.convert("RGB").resize((cf.resized_image_size, cf.resized_image_size)),
            dtype=np.uint8)[None]

    if args.beam > 1:
        out = make_beam_decoder(model, cf)(net, img)
        ids = out.ids[0].cpu().numpy()
        print("caption (beam %d):" % args.beam, vocab.decode_ids(ids))
        print("log-prob:", float(out.score[0]))
    else:
        out = make_greedy_decoder(model, cf)(net, img)
        caption = vocab.decode_ids(out.ids[0].cpu().numpy())
        print("caption:", caption)
        betas = out.beta[0].float().cpu().numpy()
        words = caption.split()
        if words:
            print("sentinel beta per token:")
            for w, b in zip(words, betas):
                print("  %-15s %.3f" % (w, float(b)))


if __name__ == "__main__":
    main()
