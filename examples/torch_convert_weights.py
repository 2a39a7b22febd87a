#!/usr/bin/env python3
"""Offline weight converters of the PyTorch port (twin of
examples/convert_weights.py; numpy and torch only, no network).

1. torchvision ResNet -> .npz for Config.encoder_pretrained_npz:

    python3 examples/torch_convert_weights.py resnet --pth resnet152.pth \
        --arch resnet152 --out resnet152.npz

2. Reference Encoder2Decoder checkpoint (.pkl state_dict) -> a checkpoint
   dir in the JAX package's format, which both packages restore:

    python3 examples/torch_convert_weights.py checkpoint \
        --pkl cider-1.0850_model-25.pkl --variant adaptive_attention \
        --arch resnet152 --out ckpt_converted/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("resnet", help="torchvision resnet .pth -> .npz")
    r.add_argument("--pth", required=True)
    r.add_argument("--arch", default="resnet152")
    r.add_argument("--out", required=True)

    c = sub.add_parser("checkpoint", help="reference model .pkl -> checkpoint dir")
    c.add_argument("--pkl", required=True)
    c.add_argument("--variant", default="adaptive_attention")
    c.add_argument("--arch", default="resnet152")
    c.add_argument("--out", required=True)

    args = ap.parse_args(argv)
    from adaptive_tpu_torch.models import torch_import

    if args.cmd == "resnet":
        torch_import.save_resnet_npz(args.pth, args.arch, args.out)
    else:
        torch_import.save_reference_checkpoint_npz(args.pkl, args.variant, args.arch, args.out)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
