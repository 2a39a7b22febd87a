#!/usr/bin/env python3
"""Visualize where the PyTorch port's model looks: per-token spatial
attention overlays and the sentinel gate beta (twin of
examples/visualize_attention.py).

    python3 examples/torch_visualize_attention.py --image photo.jpg \
        --checkpoint <ckpt_dir> --vocab data/vocab.json --out attn.png

Decodes on the CUDA card; ``main(argv, device)`` takes the device for
callers that run it on the CPU. matplotlib and Pillow are imported inside
main.
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
    ap.add_argument("--max-len", type=int, default=20)
    ap.add_argument("--beam", type=int, default=1,
                    help=">1: visualize the winning beam's attention/beta")
    ap.add_argument("--out", default="attention.png")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    from adaptive_tpu_torch.config import Config
    from adaptive_tpu_torch.data.vocab import Vocabulary
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.training import checkpoint as ckpt

    vocab = Vocabulary.load(args.vocab)
    cf = Config(atten_model_name=args.model, encoder_backbone=args.backbone,
                vocab_length=len(vocab), eval_batch_size=1, decode_max_len=args.max_len)
    model = build_model(cf, device=device)
    net = model.init(0)
    if args.checkpoint:
        ckpt.restore_model(args.checkpoint, net, model.arch)

    with Image.open(args.image) as im:
        rgb = im.convert("RGB")
        img = np.asarray(rgb.resize((cf.resized_image_size,) * 2), np.uint8)[None]
        display = np.asarray(rgb.resize((224, 224)))

    decoder = (make_beam_decoder(model, cf, beam_size=args.beam) if args.beam > 1
               else make_greedy_decoder(model, cf))
    out = decoder(net, img)  # both return .ids/.attention/.beta
    ids = out.ids[0].cpu().numpy()
    attn = out.attention[0].float().cpu().numpy()  # [L, K]
    beta = out.beta[0].float().cpu().numpy()  # [L]
    words = []
    for i in ids:
        w = vocab.idx2word[int(i)]
        if w == "<end>":
            break
        words.append(w)
    n = len(words)
    if n == 0:
        print("empty caption")
        return
    k = int(round(attn.shape[1] ** 0.5))

    cols = min(n + 1, 6)
    rows = -(-(n + 1) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    axes[0].imshow(display)
    axes[0].set_title(" ".join(words), fontsize=8)
    axes[0].axis("off")
    for t, w in enumerate(words):
        ax = axes[t + 1]
        ax.imshow(display)
        amap = attn[t].reshape(k, k)
        amap = np.kron(amap, np.ones((224 // k + 1, 224 // k + 1)))[:224, :224]
        ax.imshow(amap, alpha=0.5, cmap="jet")
        ax.set_title(f"{w}  (beta={beta[t]:.2f})", fontsize=9)
        ax.axis("off")
    for ax in axes[n + 1:]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    print("caption:", " ".join(words))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
