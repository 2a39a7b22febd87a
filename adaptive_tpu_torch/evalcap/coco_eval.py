"""Evaluation driver: decode a split, score it with the COCO caption stack
(counterpart of adaptive_tpu/evalcap/coco_eval.py).

Reference parity: coco_eval (code_src/tools/utils.py:108-250) — decode every
image of the val/test/train_eval split, cut captions at <end>, write a
results JSON named per mode, run COCOEvalCap, print metrics, return CIDEr.
Modes: per-epoch val, per-epoch train_eval, standalone valid, standalone test
(utils.py:119-146, 205-222).

The weights are an ``Encoder2Decoder`` (``net``); a decoder is called as
``decoder(net, images_u8)``. In a process group of more than one rank every
rank reads each eval batch whole and the decoder splits it over the mesh's
data axis and all-gathers the ids (decoding/spmd.py), so every rank scores
the whole split and gets the same CIDEr for the scheduler and the early
stop; rank r > 0 writes its results to ``<results>.proc<r>.json``, as the
JAX driver's processes do. ``dataset=`` serves the split's images from any
object with ``__len__`` and ``__getitem__(i) -> (uint8 HWC image, image
id)`` in place of the JPEGs under ``cf.resized_image_dir``; it changes no
result. ``image_source=`` (a callable: file path -> uint8 HWC array) reads
those files in place of the JPEG decode, as the CLI's ``main`` passes it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from adaptive_tpu_torch.data.coco_api import COCO
from adaptive_tpu_torch.data.loader import EvalBatches, EvalImageDataset
from adaptive_tpu_torch.data.vocab import Vocabulary
from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
from adaptive_tpu_torch.evalcap.eval import COCOEvalCap
from adaptive_tpu_torch.parallel.mesh import get_rank


_CKPT_EXTS = (".pkl", ".ckpt", ".msgpack", ".npz")


def _results_name(model_path: str) -> str:
    """Results-JSON name derived from the checkpoint path.

    The reference flattens the path and truncates at the FIRST '.'
    (utils.py:205-222) — which collides for checkpoints whose names embed the
    CIDEr score: 'a/cider-0.9300_model-9' and 'a/cider-0.8100_model-3' both
    become 'a_cider-0.json'. Intentional deviation: strip only a real
    checkpoint extension, then map remaining dots to '_' so every checkpoint
    gets a distinct, filesystem-safe name.
    """
    flat = model_path.rstrip("/").replace("/", "_")
    stem, ext = os.path.splitext(flat)
    if ext.lower() in _CKPT_EXTS:
        flat = stem
    return flat.replace(".", "_") + ".json"


def decode_split(
    cf, model, net, ann_path: str, vocab: Vocabulary, decoder=None, dataset=None,
    image_source=None,
) -> List[Dict]:
    """Generate {'image_id', 'caption'} results for every image in a split."""
    if decoder is None:
        decoder = (
            make_beam_decoder(model, cf) if cf.beam_size > 1 else make_greedy_decoder(model, cf)
        )
    if dataset is None:
        dataset = EvalImageDataset(cf.resized_image_dir, ann_path, image_source)
    batches = EvalBatches(dataset, cf.eval_batch_size, cf.dataloader_num_workers)

    results: List[Dict] = []
    seen = set()
    for i, batch in enumerate(batches):
        out = decoder(net, batch["images"])
        ids = (out.ids if hasattr(out, "ids") else out[0]).cpu().numpy()
        for row in range(ids.shape[0]):
            if not batch["valid"][row]:
                continue
            img_id = int(batch["img_ids"][row])
            if img_id in seen:  # an image can appear once per split
                continue
            seen.add(img_id)
            sentence = vocab.decode_ids(ids[row])  # cut at <end> (utils.py:185-190)
            results.append({"image_id": img_id, "caption": sentence})
        if (i + 1) % 10 == 0:
            print("[%d/%d]" % (i + 1, len(batches)))
    return results


def coco_eval(
    cf,
    model=None,
    net=None,
    epoch: int = 0,
    train_mode: bool = False,
    test_mode: bool = False,
    valid_mode: bool = False,
    vocab: Optional[Vocabulary] = None,
    decoder=None,
    per_image_out: Optional[Dict] = None,
    device="cuda",
    dataset=None,
    image_source=None,
) -> float:
    """Returns the split's CIDEr (utils.py:108-250). Pass a prebuilt decoder
    to share one decoder (and its prepared weights) across calls (per-epoch
    evals). per_image_out: a dict to fill with {image_id: {metric: score}} —
    the per-image scores back paired statistics (e.g. the int8 gate's
    bootstrap-CI deltas). device: where valid and test mode build the model
    (the CPU only when asked for). dataset: the split's images in place of
    its JPEGs; image_source: the reader of those files (the module
    docstring)."""
    # at most ONE mode: pairwise conflicts would silently score the wrong
    # split (test wins every tiebreak below)
    assert sum((test_mode, valid_mode, train_mode)) <= 1, (
        "coco_eval modes are mutually exclusive"
    )

    if vocab is None:
        vocab = Vocabulary.load(cf.vocab_path)
    cf = cf.replace(vocab_length=len(vocab))

    if (test_mode or valid_mode) and model is None:
        model, net, resolved = get_testOrValid_model(cf, test_mode, valid_mode, device=device)
        # bake the resolved checkpoint back into cf so the results-file name
        # below reflects the actual checkpoint (with 'auto', naming from the
        # knob would collide every run on 'auto.json')
        cf = cf.replace(
            **{("test" if test_mode else "valid") + "_pretrained_model": resolved}
        )

    ann_path = cf.val_anno_path
    if test_mode:
        ann_path = cf.test_anno_path
    elif train_mode:
        ann_path = cf.train_eval_anno_path

    if cf.encoder_quant == "int8" and getattr(model, "int8_scales", None) is None:
        # static PTQ calibration on the split's first images — the same
        # contract as the bench (models/infer.py::calibrate_model); the
        # dynamic fallback is both slower and quantizes differently, so eval
        # must never silently score a different int8 path than production.
        from adaptive_tpu_torch.models.infer import calibrate_model

        ds = dataset if dataset is not None else EvalImageDataset(
            cf.resized_image_dir, ann_path, image_source)
        calib = np.stack([ds[i][0] for i in range(min(32, len(ds)))])
        model = calibrate_model(model, cf, net, calib)
        print(f"int8: calibrated static scales on {calib.shape[0]} split images")
        if decoder is not None:
            # a prebuilt decoder closed over the UNcalibrated model; using it
            # would silently score the dynamic int8 path every epoch. Rebuild
            # against the calibrated model (the scales must track the
            # current weights anyway).
            print("int8: rebuilding decode program for the calibrated scales")
            decoder = None

    banner = "evaluation on MS-COCO dataset"
    if test_mode:
        banner = "test on MS-COCO dataset"
    elif train_mode:
        banner = "evaluating a subset of training data on MS-COCO dataset"
    print(f"---------------------Start {banner}-----------------------")

    results = decode_split(cf, model, net, ann_path, vocab, decoder=decoder, dataset=dataset,
                           image_source=image_source)
    print("#-----------------------Caption Generated-----------------------#")

    # results file naming per mode (utils.py:205-222)
    exp_dir = cf.exp_dir or "."
    if test_mode:
        name = _results_name(cf.test_pretrained_model)
        resFile = os.path.join(exp_dir, name)
    elif train_mode:
        d = os.path.join(exp_dir, "train_eval_results")
        os.makedirs(d, exist_ok=True)
        resFile = os.path.join(d, f"train_eval-{epoch}.json")
    else:
        d = os.path.join(exp_dir, "val_results")
        os.makedirs(d, exist_ok=True)
        name = f"validation-{epoch}.json"
        if valid_mode:
            name = _results_name(cf.valid_pretrained_model)
        resFile = os.path.join(d, name)
    rank = get_rank()
    if rank > 0:
        # every rank scores the whole split: a rank's own file, so that a
        # peer's write never truncates the one another rank reads back
        root, ext = os.path.splitext(resFile)
        resFile = f"{root}.proc{rank}{ext}"
    with open(resFile, "w") as f:
        json.dump(results, f)

    coco = COCO(ann_path)
    cocoRes = coco.loadRes(resFile)
    cocoEval = COCOEvalCap(coco, cocoRes)
    cocoEval.params["image_id"] = cocoRes.getImgIds()
    cocoEval.evaluate()

    if per_image_out is not None:
        per_image_out.update(cocoEval.imgToEval)

    cider = 0.0
    for metric, score in cocoEval.eval.items():
        print("%s: %.4f" % (metric, score))
        if metric == "CIDEr":
            cider = score
    return cider


def get_testOrValid_model(cf, test_mode: bool, valid_mode: bool, device="cuda"):
    """Build the model and restore the configured checkpoint (utils.py:253-271).

    Returns (model, net, resolved_path) — the path with 'auto' resolved to
    the concrete checkpoint, for results-file naming."""
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.training import checkpoint as ckpt

    path = cf.test_pretrained_model if test_mode else cf.valid_pretrained_model
    if path == "auto":
        # one-command repro: test the best checkpoint of the training run that
        # just finished in this same invocation (RUNBOOK.md). Searches the
        # experiment's trained_models dir, then the auto-resume dir.
        for d in (
            os.path.join(cf.exp_dir or ".", "trained_models"),
            cf.train_auto_resume_dir,
        ):
            found = ckpt.find_best_checkpoint(d)
            if found:
                print(f"auto-selected checkpoint: {found}")
                path = found
                break
        else:
            raise ValueError(
                "test/valid_pretrained_model='auto' found no 'cider-*_model-N' "
                "checkpoint dirs; run training first or point at a checkpoint"
            )
    if not path:
        # The reference crashes in load_state_dict on a bad path (utils.py:262-266);
        # scoring random weights silently would be strictly worse — fail loudly.
        knob = "test_pretrained_model" if test_mode else "valid_pretrained_model"
        raise ValueError(
            f"{knob} must point at a checkpoint for this mode (cfg_wzn.py:78-80,124-126)"
        )
    model = build_model(cf, device=device)
    net = ckpt.restore_model(path, model.init(cf.train_random_seed), model.arch)
    return model, net, path
