"""A tiny copy of the benchmark's cells for CPU tests: the same kinds,
readers and reference at ResNet-50 widths cut to a 64 px crop, a decoder
of width 32 and a vocabulary of 60 words."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict

from benchmark.harness import HERE, load_json, with_later

TINY_KNOBS = {"encoder_backbone": "resnet50", "train_crop_size": 64, "resized_image_size": 72,
              "vocab_length": 60, "vocab_pad_multiple": 8, "decode_max_len": 6,
              "adaptive_word_embed_size": 16, "adaptive_lstm_hidden_size": 32,
              "base_word_embed_size": 16, "base_lstm_hidden_size": 32,
              "dataloader_num_workers": 1}
TINY_TRAFFIC = {
    "greedy_b1024": {"batch": 4, "pool_batches": 2, "warmup": 1, "trace_batches": 1, "sample": 4},
    "train_finetune_b256": {"batch": 4, "images": 16, "captions_per_image": 5,
                            "caption_tokens": {"min": 4, "max": 12, "mean": 6.0, "sigma": 0.8},
                            "buckets": [8, 12], "trace_steps": 1},
    "serve_b32": {"batch": 4, "rate": 40, "clients": 8, "images": 16, "warmup": 1,
                  "trace_s": 0.2, "sample": 4, "timeout_s": 5.0},
}
# At batch 4 the frozen step's median-leaf gradient gap reads up to 0.0015
# (0.00015 at the cell's batch of 256), the fp8 control's 0.0063 and more:
# the tiny copy holds that number to 0.003. The tiny trunk (ResNet-50 at
# 64 px, CPU) reads encoder_gap 0.0075-0.0124 in the program and
# 0.016-0.028 in the int8 control over six seeds (0.0056-0.0066 and
# 0.0119-0.0136 in the cell on the card): the tiny copy holds it to 0.014.
# At batch 4 the fine-tune step's top_stage_grad_gap reads 0.014-0.036 (at
# most 0.0155 in the cell on the card), half a batch 0.72-0.82: the tiny
# copy holds it to 0.1. Every other limit is the cell's.
TINY_LIMITS = {"train_frozen_b256": {"grad_median_gap": 0.003},
               "train_finetune_b256": {"top_stage_grad_gap": 0.1},
               "greedy_b1024": {"encoder_gap": 0.014},
               "serve_b32": {"encoder_gap": 0.014}}
TINY_TRAFFIC["train_frozen_b256"] = TINY_TRAFFIC["train_finetune_b256"]


def tiny_base(tmp: Path) -> Dict:
    """A benchmark folder under tmp whose configs and traffic are the tiny
    ones (limits kept), its metrics the real readers; returns the spec,
    later.json's cells with it."""
    shutil.copytree(HERE / "metrics", tmp / "metrics")
    for sub in ("configs", "traffic"):
        (tmp / sub).mkdir()
    for p in (HERE / "configs").glob("*.json"):
        (tmp / "configs" / p.name).write_text(json.dumps(dict(load_json(p), **TINY_KNOBS)))
    for p in (HERE / "traffic").glob("*.json"):
        mix = dict(load_json(p), **TINY_TRAFFIC.get(p.stem, {}))
        mix["limits"] = dict(mix["limits"], **TINY_LIMITS.get(p.stem, {}))
        (tmp / "traffic" / p.name).write_text(json.dumps(mix))
    return with_later(load_json(HERE.parent / "BENCHMARK.json"))
