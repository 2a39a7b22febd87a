"""Checkpoints, read side: restore a model from the JAX package's checkpoint
directory (counterpart of adaptive_tpu/training/checkpoint.py, numpy only).

A checkpoint is a directory holding ``model.npz``: one array per leaf of the
JAX tree ``{"params": ..., "state": ...}``, each under its path joined with
``SEP`` (a dict key as itself, a list index as ``#i``). ``restore_model``
splits the keys back into that tree, checks it against the tree the net's
own weights give, and loads it through the weight bridge
(models/jax_params.py). Directory names keep the reference's
``cider-X.XXXX_model-N`` contract (train.py:176-178), so the same
``find_best_checkpoint`` serves valid and test mode's ``"auto"``. The write
side (``save_checkpoint``, the optimiser state, the manifest) comes with the
port's training slice; ``flatten_tree`` writes the same keys.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

SEP = "|"


def _seg(key) -> str:
    return f"#{key}" if isinstance(key, int) else str(key)


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested tree of dicts and lists -> {path key: numpy leaf}, with the
    JAX package's key for every leaf."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}{SEP}{_seg(k)}" if prefix else _seg(k)))
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of flatten_tree: a ``#i`` segment is a list index."""
    root: Dict[Any, Any] = {}
    for key, leaf in flat.items():
        *parents, last = [int(s[1:]) if s.startswith("#") else s for s in key.split(SEP)]
        node = root
        for s in parents:
            node = node.setdefault(s, {})
        node[last] = leaf
    return _as_lists(root)


def _as_lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_as_lists(node[i]) for i in range(len(node))]
    return {k: _as_lists(v) for k, v in node.items()}


def restore_model(path: str, net, arch: str):
    """Load a checkpoint dir (or its model.npz) into ``net`` in place and
    return it. Every leaf of the tree the net's weights give must be in the
    file with the same shape: a missing one raises KeyError naming it, another
    shape ValueError (the JAX package's checks); the file's other keys are
    ignored."""
    from adaptive_tpu_torch.models.jax_params import from_jax, to_jax

    npz = path if path.endswith(".npz") else os.path.join(path, "model.npz")
    with np.load(npz) as data:
        flat = dict(data)
    params_t, state_t = to_jax(net.state_dict(), arch)
    want = flatten_tree({"params": params_t, "state": state_t})
    picked = {}
    for key, leaf in want.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {leaf.shape}")
        picked[key] = arr.astype(leaf.dtype)
    tree = unflatten_tree(picked)
    net.load_state_dict(from_jax(tree["params"], tree["state"], arch))
    return net


def checkpoint_name(cider: float, epoch: int) -> str:
    """'cider-%.4f_model-%d' — the reference's filename contract (train.py:178)."""
    return "cider-%.4f_model-%d" % (cider, epoch)


def find_best_checkpoint(directory: str) -> Optional[str]:
    """Path of the highest-CIDEr complete checkpoint dir under `directory`
    (the 'cider-X.XXXX' prefix of the reference's filename contract). Ties
    go to the later epoch; '.tmp' staging dirs and mid-epoch '_step-K' dirs
    never match. None when nothing matches."""
    if not directory or not os.path.isdir(directory):
        return None
    best: Tuple[float, int, str] = (-1.0, -1, "")
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            continue
        m = re.match(r"cider-([\d.]+)_model-(\d+)$", name)
        full = os.path.join(directory, name)
        if m and os.path.isdir(full):
            key = (float(m.group(1)), int(m.group(2)), full)
            if key[:2] > best[:2]:
                best = key
    return best[2] or None


def epoch_from_filename(path: str) -> int:
    """Parse epoch N from '...model-N[.*]' (model_factory.py:19)."""
    m = re.search(r"model-(\d+)", os.path.basename(path.rstrip("/")))
    if not m:
        raise ValueError(f"cannot parse epoch from checkpoint name {path!r}")
    return int(m.group(1))
