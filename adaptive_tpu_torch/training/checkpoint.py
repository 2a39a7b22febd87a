"""Checkpoints in the JAX package's format, both ways (counterpart of
adaptive_tpu/training/checkpoint.py, numpy only).

A checkpoint is a directory holding ``model.npz``: one array per leaf of the
JAX tree ``{"params": ..., "state": ...}``, each under its path joined with
``SEP`` (a dict key as itself, a list index as ``#i``); ``opt.npz``: the
optimizer state under the keys of the JAX package's optax state; and
``manifest.json``: the resume payload. ``restore_model`` splits the keys back
into that tree, checks it against the tree the net's own weights give, and
loads it through the weight bridge (models/jax_params.py).
``save_checkpoint`` writes the same keys, atomically. Directory names keep
the reference's ``cider-X.XXXX_model-N`` contract (train.py:176-178), with a
``_step-K`` suffix for mid-epoch resume points.

The optimizer codec: each group ("decoder", "encoder") is the JAX package's
``multi_transform`` state, ``<group>|inner_states|on|inner_state``, whose
``count`` and ``hyperparams|learning_rate`` are the param group's "count" and
"lr"; below it ``inner_state|#1`` holds adam's ``count`` (torch's "step"),
``mu|<param key>`` and ``nu|<param key>`` (``exp_avg``, ``exp_avg_sq``), or
sgd's ``trace|<param key>`` (``momentum_buffer``), for the group's own
parameters only, in JAX's layouts (jax_params.param_keys: HWIO convs,
[in, out] linear kernels and LSTM weights). A group never stepped writes
zeros, as optax's initial state holds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def _model_flat(net) -> Dict[str, np.ndarray]:
    from adaptive_tpu_torch.models.jax_params import to_jax

    params, state = to_jax(net.state_dict(), net.encoder.resnet_conv.arch)
    return flatten_tree({"params": params, "state": state})


def _group_prefix(group: str) -> str:
    return f"{group}{SEP}inner_states{SEP}on{SEP}inner_state"


def _opt_flat(dual, net) -> Dict[str, np.ndarray]:
    """The optimizer state under the JAX package's opt.npz keys (module
    docstring), host copies."""
    from adaptive_tpu_torch.models.jax_params import param_keys, to_layout

    keys = param_keys(net.encoder.resnet_conv.arch)
    params = dict(net.named_parameters())
    flat: Dict[str, np.ndarray] = {}
    for group in ("decoder", "encoder"):
        opt, pre = dual.group(group), _group_prefix(group)
        pg = opt.param_groups[0]
        flat[f"{pre}{SEP}count"] = np.asarray(pg["count"], np.int32)
        flat[f"{pre}{SEP}hyperparams{SEP}learning_rate"] = np.asarray(pg["lr"], np.float32)
        inner = f"{pre}{SEP}inner_state{SEP}#1"
        adam = isinstance(opt, torch.optim.Adam)
        fields = ((("mu", "exp_avg"), ("nu", "exp_avg_sq")) if adam
                  else (("trace", "momentum_buffer"),))
        steps = [int(opt.state[params[n]]["step"]) for n in dual.names(group)
                 if "step" in opt.state.get(params[n], {})]
        if adam:
            flat[f"{inner}{SEP}count"] = np.asarray(max(steps, default=0), np.int32)
        for name in dual.names(group):
            key, layout = keys[name]
            st = opt.state.get(params[name], {})
            for moment, field in fields:
                t = st.get(field)
                if t is None:
                    t = torch.zeros_like(params[name], device="cpu")
                flat[f"{inner}{SEP}{moment}{SEP}{key}"] = to_layout(t, layout)
    return flat


def restore_opt_state(path: str, dual, net):
    """Load a checkpoint's opt.npz into the dual optimizer in place and
    return it. Every key the groups' own parameters give must be in the
    file with the same shape (KeyError / ValueError naming it, as the JAX
    package's restore); the file's other keys are ignored."""
    from adaptive_tpu_torch.models.jax_params import from_layout, param_keys

    with np.load(os.path.join(path, "opt.npz")) as data:
        flat = dict(data)
    want = _opt_flat(dual, net)  # the template: every key, its shape
    for key, leaf in want.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(flat[key].shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {flat[key].shape} vs model {leaf.shape}")
    keys = param_keys(net.encoder.resnet_conv.arch)
    params = dict(net.named_parameters())
    for group in ("decoder", "encoder"):
        opt, pre = dual.group(group), _group_prefix(group)
        pg = opt.param_groups[0]
        pg["count"] = int(flat[f"{pre}{SEP}count"])
        pg["lr"] = float(flat[f"{pre}{SEP}hyperparams{SEP}learning_rate"])
        inner = f"{pre}{SEP}inner_state{SEP}#1"
        adam = isinstance(opt, torch.optim.Adam)
        count = int(flat[f"{inner}{SEP}count"]) if adam else pg["count"]
        for name in dual.names(group):
            p = params[name]
            opt.state.pop(p, None)
            if not count:  # never stepped: torch's empty state is optax's zeros
                continue
            key, layout = keys[name]

            def moment(m):
                return from_layout(flat[f"{inner}{SEP}{m}{SEP}{key}"], layout).to(p)

            if adam:
                opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                "exp_avg": moment("mu"), "exp_avg_sq": moment("nu")}
            else:
                opt.state[p] = {"momentum_buffer": moment("trace")}
    return dual


def save_checkpoint(path: str, net, dual=None, metadata: Optional[Dict] = None,
                    prune_before: Optional[Tuple[int, int]] = None):
    """Write checkpoint dir: model.npz (+opt.npz) + manifest.json.

    Atomic: everything lands in '<path>.tmp' which is renamed into place, so
    a crash mid-write never leaves a half-readable checkpoint. An existing
    checkpoint is swapped out through '<path>.old'; a destination that is
    not a checkpoint is refused. `prune_before`: a resume point (epoch,
    step) — mid-epoch '_step-K' checkpoints strictly before it are deleted
    after this one is durable."""
    flat_opt = _opt_flat(dual, net) if dual is not None else None
    _write_checkpoint_files(path, _model_flat(net), flat_opt, metadata, prune_before)


def _write_checkpoint_files(path, flat_model, flat_opt, metadata, prune_before=None):
    path = path.rstrip("/")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "model.npz"), **flat_model)
    if flat_opt is not None:
        np.savez(os.path.join(tmp, "opt.npz"), **flat_opt)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(metadata or {}, f, indent=2, default=str)
    if os.path.exists(path):
        # a regular file or a directory without model.npz is not a
        # checkpoint: never swap it out and delete it
        if not os.path.isdir(path) or not os.path.exists(os.path.join(path, "model.npz")):
            raise ValueError(
                f"{path} exists and is not a checkpoint dir; refusing to replace"
            )
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
    if prune_before is not None:
        for stale in stale_step_checkpoints(os.path.dirname(path), *prune_before):
            shutil.rmtree(stale, ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint file writes with training.

    save() copies the weights, BN statistics and moments to host memory on
    the caller's thread (the next step changes them in place) and hands the
    npz/manifest writes to a background thread. At most one write is in
    flight: a second save() waits for the first. wait() joins the pending
    write and raises its error; call it before reading checkpoints back or
    exiting."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path, net, dual=None, metadata=None, prune_before=None):
        self.wait()
        flat_model = _model_flat(net)
        flat_opt = _opt_flat(dual, net) if dual is not None else None

        def work():
            try:
                _write_checkpoint_files(path, flat_model, flat_opt, metadata, prune_before)
            except BaseException as e:  # surfaced on the next save()/wait()
                self._error = e

        # non-daemon: the interpreter joins it at exit, so an in-flight
        # checkpoint lands even when the main thread dies
        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_metadata(path: str) -> Dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def checkpoint_name(cider: float, epoch: int) -> str:
    """'cider-%.4f_model-%d' — the reference's filename contract (train.py:178)."""
    return "cider-%.4f_model-%d" % (cider, epoch)


def step_checkpoint_name(epoch: int, step: int) -> str:
    """Mid-epoch checkpoint name: the epoch-name contract plus a '_step-K'
    suffix (K = steps already completed in epoch E), invisible to
    find_best_checkpoint."""
    return "cider-0.0000_model-%d_step-%d" % (epoch, step)


def _resume_point(name: str) -> Optional[Tuple[int, int]]:
    """(epoch_to_run, step_to_start_at) a checkpoint dir name resumes into,
    or None if the name is not a checkpoint. Epoch-complete 'model-N' resumes
    at (N+1, 0); mid-epoch 'model-N_step-K' at (N, K)."""
    m = re.search(r"model-(\d+)(?:_step-(\d+))?$", name)
    if not m:
        return None
    if m.group(2) is None:
        return (int(m.group(1)) + 1, 0)
    return (int(m.group(1)), int(m.group(2)))


def find_latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the complete checkpoint dir under `directory` whose resume
    point is furthest along ('.tmp' staging dirs never match); None when
    there is none (auto-resume's fresh start)."""
    if not directory or not os.path.isdir(directory):
        return None
    best: Tuple[Tuple[int, int], str] = ((-1, -1), "")
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            continue
        point = _resume_point(name)
        full = os.path.join(directory, name)
        if point is not None and os.path.isdir(full) and point > best[0]:
            best = (point, full)
    return best[1] or None


def stale_step_checkpoints(directory: str, epoch: int, step: int) -> list:
    """Mid-epoch checkpoint dirs whose resume point is strictly before
    (epoch, step); epoch-complete checkpoints are never returned."""
    out = []
    if not directory or not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if "_step-" not in name or name.endswith(".tmp"):
            continue
        point = _resume_point(name)
        if point is not None and point < (epoch, step):
            out.append(os.path.join(directory, name))
    return out


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
