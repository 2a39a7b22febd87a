#!/usr/bin/env python
"""Generate a synthetic COCO-format dataset + vocab for smoke runs of the
PyTorch port (counterpart of examples/make_synthetic_data.py: the same
flags, the same files).

    python examples/torch_make_synthetic_data.py --root data/synth --images 512
    python -m adaptive_tpu_torch.main -c <config pointing at data/synth>
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="data/synth")
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--captions-per-image", type=int, default=2)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset
    from adaptive_tpu_torch.data.vocab import build_vocab

    ann, resized = make_synthetic_dataset(
        args.root, args.images, args.captions_per_image, args.size, args.seed
    )
    coco = COCO(ann)
    vocab = build_vocab((a["caption"] for a in coco.anns.values()), threshold=1)
    vocab_path = os.path.join(args.root, "vocab.json")
    vocab.save(vocab_path)
    print(f"annotations: {ann}")
    print(f"images:      {resized} ({args.images} files)")
    print(f"vocab:       {vocab_path} ({len(vocab)} words)")


if __name__ == "__main__":
    main()
