#!/usr/bin/env python3
"""int8 quality-gate ladder of the PyTorch port on one NVIDIA card (twin of
tools/int8_gate.py).

Trains a small but real model (ResNet-50 at 224, bf16) on a synthetic COCO
split, then scores the SAME checkpoint through each encoder path with the
full eval stack (greedy decode -> PTB tokenize -> BLEU/METEOR/ROUGE/CIDEr,
evalcap/coco_eval.py in valid mode): the JAX gate's four (bf16 exact, int8
per-tensor, per-channel, per-channel with bias correction) and the port's
two kernel modes, (b) per-tensor with every identity block through kernel 5
(ops/fused_block.py) and (c) per-tensor with every block tail through
kernel 6 (ops/fused_tail.py). Prints each mode's CIDEr, its delta against
bf16 with a paired per-image bootstrap 95% CI (10,000 draws, seed 0), and
for (b) and (c) the images whose caption differs from per-tensor's, which
they must reproduce (0 expected); writes <workdir>/gate_results.json.

    python3 tools/torch_int8_gate.py [--workdir DIR] [--epochs 7] [--images 512]

The split's images are synthetic_image(i, 256) served from memory
(image_source=), not the JPEG round trip JAX's gate trains on: the card's
machine is not promised Pillow. Needs a CUDA card and nvcc; imports no JAX.
``run_gate`` is the same run as a function, at any size and device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FUSED = ("layer1", "layer2", "layer3", "layer4")
TENSOR = dict(encoder_quant="int8", encoder_quant_granularity="tensor",
              encoder_quant_bias_correct=False)
# (name, Config fields, CaptionModel fields); the last two are the port's
LADDER = (
    ("bf16 exact", dict(encoder_quant="none"), {}),
    ("int8 per-tensor carry", TENSOR, {}),
    ("int8 per-channel carry", dict(encoder_quant="int8", encoder_quant_granularity="channel",
                                    encoder_quant_bias_correct=False), {}),
    ("int8 per-channel + bias-corr", dict(encoder_quant="int8",
                                          encoder_quant_granularity="channel",
                                          encoder_quant_bias_correct=True), {}),
    ("int8 per-tensor + kernel 5 (b)", TENSOR, {"int8_fused_layers": FUSED}),
    ("int8 per-tensor + kernel 6 (c)", TENSOR, {"int8_fused_tails": FUSED}),
)
CONTROL = "int8 per-tensor carry"  # what (b) and (c) must reproduce
# the JAX gate's settings (tools/int8_gate.py:66-89)
DEFAULTS = dict(
    vocab_pad_multiple=1, atten_model_name="adaptive_attention", encoder_backbone="resnet50",
    compute_dtype="bfloat16", train_crop_size=224, resized_image_size=256,
    train_batch_size=128, train_grad_accum_steps=2, eval_batch_size=128, train_num_epochs=7,
    opt_fine_tune_cnn_start_epoch=3, train_evalOrnot=False, train_early_stop=False,
    trainOrnot=True,
)


def synthetic_source(size: int):
    """image_source for the synthetic split: COCO_train2014_<i+1>.jpg ->
    synthetic_image(i, size), made in memory."""
    from adaptive_tpu_torch.data.synthetic import synthetic_image

    def read(path: str) -> np.ndarray:
        return synthetic_image(int(os.path.basename(path)[-16:-4]) - 1, size)

    return read


def paired_table(rows, checkpoint: str):
    """The JAX gate's paired per-image bootstrap against rows[0]: rows are
    (name, cider, per_image {image_id: {metric: score}}); returns
    (gate_results dict, markdown lines)."""
    base_name, base, base_per = rows[0]
    ids = sorted(base_per.keys())
    rng = np.random.default_rng(0)
    lines = [f"| Encoder path | CIDEr | delta vs bf16 | paired 95% CI (n={len(ids)}) |",
             "|---|---|---|---|"]
    out = {"checkpoint": checkpoint, "n_images": len(ids), "modes": {}}
    for name, cider, per in rows:
        if name == base_name:
            lines.append(f"| {name} | {cider:.4f} | — | — |")
            out["modes"][name] = {"cider": cider}
            continue
        deltas = np.array([per[i]["CIDEr"] - base_per[i]["CIDEr"] for i in ids])
        boot = rng.choice(deltas, size=(10_000, len(deltas)), replace=True).mean(axis=1)
        lo, hi = np.percentile(boot, [2.5, 97.5])
        lines.append(f"| {name} | {cider:.4f} | {cider - base:+.4f} | [{lo:+.4f}, {hi:+.4f}] |")
        out["modes"][name] = {
            "cider": cider, "delta": cider - base,
            "paired_ci95": [float(lo), float(hi)],
            "delta_nonzero_images": int(np.count_nonzero(deltas)),
        }
    return out, lines


def score_ladder(cf, ckpt: str, eval_dir: str, device="cuda", image_source=None):
    """Score checkpoint ckpt through coco_eval in valid mode in each mode of
    LADDER over cf's val split; returns (rows [(name, CIDEr, per-image
    scores)], {name: {image_id: caption}})."""
    from adaptive_tpu_torch.evalcap.coco_eval import (
        _results_name, coco_eval, get_testOrValid_model,
    )

    os.makedirs(eval_dir, exist_ok=True)
    rows, captions = [], {}
    for name, quant, fields in LADDER:
        c = cf.replace(valid_pretrained_model=ckpt, trainOrnot=False, exp_dir=eval_dir, **quant)
        # the kernel modes are CaptionModel fields, not Config knobs: the
        # model is built and restored as valid mode does, then handed over
        model, net, _ = get_testOrValid_model(c, False, True, device=device)
        per_image = {}
        cider = coco_eval(c, model._replace(**fields), net, valid_mode=True,
                          per_image_out=per_image, device=device, image_source=image_source)
        with open(os.path.join(eval_dir, "val_results", _results_name(ckpt))) as f:
            captions[name] = {r["image_id"]: r["caption"] for r in json.load(f)}
        rows.append((name, cider, per_image))
        print(f"[gate] {name}: CIDEr {cider:.4f}")
    return rows, captions


def run_gate(workdir: str, cf_overrides=None, device="cuda", images: int = 512,
             skip_train: str = "", vocab: str = ""):
    """Train (unless skip_train names a checkpoint dir), score the
    checkpoint in every mode of LADDER and write <workdir>/gate_results.json;
    returns its dict. cf_overrides go over DEFAULTS (the JAX gate's
    settings); images: the synthetic split's size (2 captions each, seed
    7); vocab: a vocabulary file (.json, or the reference's .pkl) in place
    of the one built from the captions. Each mode's results and per-image
    scores are under "modes", its captions' count of images that differ
    from the per-tensor control's under "captions_differ_from_control"."""
    from adaptive_tpu_torch.config import load_config
    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset
    from adaptive_tpu_torch.data.vocab import Vocabulary, build_vocab

    knobs = {**DEFAULTS, **(cf_overrides or {})}
    size = knobs["resized_image_size"]
    data_dir = os.path.join(workdir, "data")
    ann, resized = make_synthetic_dataset(data_dir, num_images=images, captions_per_image=2,
                                          image_size=size, seed=7, write_images=False)
    source = synthetic_source(size)
    if vocab:
        voc = Vocabulary.load(vocab)
    else:
        voc = build_vocab((a["caption"] for a in COCO(ann).anns.values()), threshold=1)
    vocab_path = os.path.join(data_dir, "vocab.json")
    voc.save(vocab_path)
    cf = load_config(None, **{
        "experiment_path": os.path.join(workdir, "Experiments"), "vocab_path": vocab_path,
        "vocab_length": len(voc), "resized_image_dir": resized, "train_anno_path": ann,
        "val_anno_path": ann, "train_eval_anno_path": ann, **knobs})

    if skip_train:
        ckpt = skip_train
    else:
        from adaptive_tpu_torch.experiment import Experiment
        from adaptive_tpu_torch.training.checkpoint import find_latest_checkpoint
        from adaptive_tpu_torch.training.train_loop import main_train

        exp = Experiment(cf)
        cf = exp.setup()
        try:
            main_train(cf, device=device, image_source=source)
        finally:
            exp.teardown()
        ckpt = find_latest_checkpoint(os.path.join(cf.exp_dir, "trained_models"))
        if not ckpt:
            raise RuntimeError(f"no checkpoint written under {cf.exp_dir}")
    print(f"gate checkpoint: {ckpt}")

    # eval artifacts go under the workdir (a --skip-train run makes no exp dir)
    rows, captions = score_ladder(cf, ckpt, os.path.join(workdir, "gate_evals"), device, source)
    out, lines = paired_table(rows, ckpt)
    print("\n" + "\n".join(lines))
    out["captions_differ_from_control"] = {
        name: sum(captions[name][i] != captions[CONTROL][i] for i in captions[CONTROL])
        for name, _, fields in LADDER if fields}
    out["per_image"] = {name: {str(i): s["CIDEr"] for i, s in per.items()}
                        for name, _, per in rows}
    print(f"captions differing from {CONTROL!r}: {out['captions_differ_from_control']}")
    with open(os.path.join(workdir, "gate_results.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "torch_int8_gate"),
                   help="data, checkpoints (~0.3 GB an epoch) and gate_results.json")
    p.add_argument("--epochs", type=int, default=7)
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--grad-accum", type=int, default=2)
    p.add_argument("--skip-train", default="",
                   help="path to an existing checkpoint dir: eval-only ladder")
    p.add_argument("--vocab", default="",
                   help="use this vocabulary (.json or the reference's .pkl) instead of "
                        "building one from the synthetic captions")
    p.add_argument("--vocab-pad", type=int, default=1,
                   help="vocab_pad_multiple (configs ship 128: 10123->10240)")
    p.add_argument("--out", default="", help="also copy gate_results.json here")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_gate.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    out = run_gate(args.workdir, dict(train_num_epochs=args.epochs,
                                      encoder_backbone=args.backbone,
                                      train_batch_size=args.batch,
                                      train_grad_accum_steps=args.grad_accum,
                                      vocab_pad_multiple=args.vocab_pad),
                   images=args.images, skip_train=args.skip_train, vocab=args.vocab)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
