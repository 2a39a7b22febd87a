"""Metric writer + misc logging helpers (counterpart of
adaptive_tpu/utils/logging.py).

Reference parity: tensorboardX SummaryWriter usage (train.py:47-49,128-138,
144,164,188,194 — scalar losses/LRs/CIDEr + weight histograms) and the HMS
wall-clock pretty printer (tools/utils.py:274-283). MetricWriter writes
newline-delimited JSON (scalars.jsonl / histograms.jsonl) and, where
tensorboardX is installed, TensorBoard event files with the same tags.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricWriter:
    """Append-only JSONL scalar/histogram writer with tensorboard-like tags."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._scalars = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._hists = open(os.path.join(logdir, "histograms.jsonl"), "a")
        try:  # real event files (train.py:47-49); JSONL still written below
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir=logdir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        self._scalars.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}) + "\n"
        )
        if self._tb is not None:
            try:
                self._tb.add_scalar(tag, float(value), int(step))
            except Exception:  # TB is best-effort; JSONL already written
                pass

    def add_scalars(self, tag: str, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.add_scalar(f"{tag}/{k}", v, step)

    def add_histogram(self, tag: str, values, step: int, bins: int = 32):
        arr = np.asarray(values).ravel().astype(np.float64)
        if arr.size == 0:
            return
        counts, edges = np.histogram(arr, bins=bins)
        self._hists.write(
            json.dumps(
                {
                    "tag": tag,
                    "step": int(step),
                    "min": float(arr.min()),
                    "max": float(arr.max()),
                    "mean": float(arr.mean()),
                    "std": float(arr.std()),
                    "counts": counts.tolist(),
                    "edges": edges.tolist(),
                }
            )
            + "\n"
        )
        if self._tb is not None:
            try:  # after JSONL: a TB failure (e.g. inf/NaN weights mid-run)
                self._tb.add_histogram(tag, arr, int(step), bins=bins)
            except Exception:  # must not kill training or lose the JSONL line
                pass

    def add_param_histograms(self, net, step: int, skip_substr: str = "resnet",
                             max_elems: int = 65536):
        """Weight histograms of the net's parameters under their JAX names
        and layouts ("decoder/lstm/w_ih"), skipping the ResNet's
        (train.py:129-131 parity). Tensors past `max_elems` are
        strided-subsampled on the device, so a dump copies a bounded amount
        to the host."""
        from adaptive_tpu_torch.models.jax_params import param_keys

        keys = param_keys(net.encoder.resnet_conv.arch)
        for pname, p in net.named_parameters():
            key, layout = keys[pname]
            name = key.replace("|", "/")
            if skip_substr and skip_substr in name:
                continue
            leaf = p.detach()
            if layout == "linear":
                leaf = leaf.T
            leaf = leaf.reshape(-1)
            n = leaf.numel()
            if n > max_elems:
                leaf = leaf[:: -(-n // max_elems)]
            self.add_histogram("Weights_" + name, leaf.float().cpu().numpy(), step)

    def flush(self):
        self._scalars.flush()
        self._hists.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._scalars.close()
        self._hists.close()
        if self._tb is not None:
            self._tb.close()


def HMS(sec: float) -> str:
    """seconds -> 'Hh:MMm:SSs' (tools/utils.py:274-283)."""
    m, s = divmod(sec, 60)
    h, m = divmod(m, 60)
    return "%dh:%02dm:%02ds" % (h, m, s)


def configurationPATH(cf):
    """Print the experiment's save path (tools/utils.py:286-295)."""
    print("\n###########################")
    print(' > Save Path = "%s"' % cf.exp_dir)
    print("###########################\n")
