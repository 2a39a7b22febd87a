"""Weight bridge between the JAX package's parameter trees and the port's
modules (the inverse of adaptive_tpu/models/torch_import.py).

``from_jax`` maps a JAX (params, state) tree of numpy arrays to a state_dict
with the reference Encoder2Decoder's keys, which ``Encoder2Decoder`` loads
with ``load_state_dict``; ``to_jax`` maps it back. Layout changes, all exact:
linear kernel [in, out] -> weight [out, in]; conv HWIO -> OIHW; LSTM
[in, 4H] -> [4H, in] with the same gate order i,f,g,o; BN scale/bias ->
weight/bias and mean/var -> running_mean/running_var. Numpy and torch only.
``param_keys`` names each parameter's leaf in the JAX tree and its layout,
for trees that follow the parameters (the optimiser's moments).

Every decoder variant maps: the rnn variant's aggregator ``adaptive.atten.
lstm`` is JAX's ``lstm_fwd`` and its ``*_l0_reverse`` tensors JAX's
``lstm_bwd`` (adaptive_tpu/models/torch_import.py:138-150). ``from_jax``
reads the variant from the tree, ``to_jax`` from the state_dict's keys
unless it is named.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from adaptive_tpu_torch.models.decoders import ATTEN_AFFINES, SENTINEL_AFFINES
from adaptive_tpu_torch.models.resnet import RESNET_SPECS

_LAYER0 = 4  # resnet_conv index of layer1: [conv1, bn1, relu, maxpool, layer1..4]
_LSTM = (("w_ih", "weight_ih_l0", "linear"), ("w_hh", "weight_hh_l0", "linear"),
         ("b_ih", "bias_ih_l0", "vector"), ("b_hh", "bias_hh_l0", "vector"))
_HEADS = ("affine_a", "affine_b", "affine_h0", "affine_c0")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _n(t: torch.Tensor) -> np.ndarray:
    """A host copy: never a view of a CPU tensor that may change in place."""
    return t.detach().to("cpu", copy=True).numpy()


def _resnet_entries(arch: str):
    """(state_dict prefix, JAX param path, JAX state path) for every
    conv/BN pair of the backbone; a path is a tuple of keys and indices."""
    block_type, stages = RESNET_SPECS[arch]
    n_convs = 3 if block_type == "bottleneck" else 2
    yield "0", ("conv1",), None
    yield "1", ("bn1",), ("bn1",)
    for li, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            base = f"{_LAYER0 + li}.{bi}"
            lp = (f"layer{li + 1}", bi)
            for ci in range(1, n_convs + 1):
                yield f"{base}.conv{ci}", lp + (f"conv{ci}",), None
                yield f"{base}.bn{ci}", lp + (f"bn{ci}",), lp + (f"bn{ci}",)
            yield f"{base}.downsample.0", lp + ("downsample", "conv"), None
            yield f"{base}.downsample.1", lp + ("downsample", "bn"), lp + ("downsample_bn",)


def _get(tree, path):
    for p in path:
        if isinstance(p, int):
            if p >= len(tree):
                return None
        elif p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for i, p in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(p, int):
            while len(tree) <= p:
                tree.append({})
            tree = tree[p]
        else:
            tree = tree.setdefault(p, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


def _key(path) -> str:
    return "|".join(f"#{p}" if isinstance(p, int) else str(p) for p in path)


def _decoder_entries(variant: str, bidirectional: bool = True):
    """(state_dict name, JAX path under params, layout) of every decoder
    parameter of the variant."""
    yield "decoder.embed.weight", ("decoder", "embed"), "vector"
    for jk, tk, layout in _LSTM:
        yield f"decoder.LSTM.{tk}", ("decoder", "lstm", jk), layout
    blk = ("decoder", "adaptive")
    for name in ATTEN_AFFINES[variant]:
        yield f"decoder.adaptive.atten.{name}.weight", blk + ("atten", name, "kernel"), "linear"
    if variant == "adaptive_attention":
        for name in SENTINEL_AFFINES:
            yield (f"decoder.adaptive.sentinel.{name}.weight",
                   blk + ("sentinel", name, "kernel"), "linear")
    if variant == "rnn_attention":
        for direction, suffix in (("lstm_fwd", ""), ("lstm_bwd", "_reverse"))[:1 + bidirectional]:
            for jk, tk, layout in _LSTM:
                yield (f"decoder.adaptive.atten.lstm.{tk}{suffix}",
                       blk + ("atten", direction, jk), layout)
    yield "decoder.adaptive.mlp.weight", blk + ("mlp", "kernel"), "linear"
    yield "decoder.adaptive.mlp.bias", blk + ("mlp", "bias"), "vector"


def _variant_of_state_dict(sd) -> Tuple[str, bool]:
    """(variant, bidirectional) of a decoder's state_dict keys: a sentinel
    is the adaptive variant, an aggregator LSTM rnn (bidirectional where it
    has *_reverse tensors), neither the baseline."""
    if "decoder.adaptive.sentinel.affine_x.weight" in sd:
        return "adaptive_attention", True
    if "decoder.adaptive.atten.lstm.weight_ih_l0" in sd:
        return "rnn_attention", "decoder.adaptive.atten.lstm.weight_ih_l0_reverse" in sd
    return "baseline_attention", True


def param_keys(arch: str) -> Dict[str, Tuple[str, str]]:
    """{state_dict name of every parameter of an Encoder2Decoder (blocks
    without a downsample and every decoder variant's parameters included;
    callers look names up): (its JAX key under "params", in the
    checkpoint's ``|`` codec, its layout)}. Layouts:
    "conv" (OIHW <-> HWIO), "linear" ([out, in] <-> [in, out], LSTM
    weights too) and "vector" (as is); to_layout and from_layout apply
    them."""
    out: Dict[str, Tuple[str, str]] = {}
    for prefix, ppath, spath in _resnet_entries(arch):
        key = f"encoder.resnet_conv.{prefix}"
        jp = ("encoder", "resnet") + ppath
        if spath is None:
            out[f"{key}.weight"] = (_key(jp + ("kernel",)), "conv")
        else:
            out[f"{key}.weight"] = (_key(jp + ("scale",)), "vector")
            out[f"{key}.bias"] = (_key(jp + ("bias",)), "vector")
    for name in _HEADS:
        out[f"encoder.{name}.weight"] = (f"encoder|{name}|kernel", "linear")
        out[f"encoder.{name}.bias"] = (f"encoder|{name}|bias", "vector")
    for variant in ATTEN_AFFINES:
        for name, path, layout in _decoder_entries(variant):
            out[name] = (_key(path), layout)
    return out


def to_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    """A tensor in torch's layout -> a numpy host copy in JAX's (a view of
    the copy, transposed)."""
    return np_to_layout(_n(t), layout)


def np_to_layout(a: np.ndarray, layout: str) -> np.ndarray:
    """to_layout on a numpy array (a transposed view)."""
    if layout == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    return a.T if layout == "linear" else a


def np_from_layout(a, layout: str) -> np.ndarray:
    """Inverse of np_to_layout (a transposed view)."""
    a = np.asarray(a)
    if layout == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    return a.T if layout == "linear" else a


def from_layout(a, layout: str) -> torch.Tensor:
    """Inverse of to_layout (a CPU tensor)."""
    return _t(np_from_layout(a, layout))


def from_jax(params: Dict, state: Dict, arch: str) -> Dict[str, torch.Tensor]:
    """JAX (params, state) of a model of any variant -> state_dict with the
    reference Encoder2Decoder's keys (CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    enc, rs = params["encoder"], state["resnet"]
    for prefix, ppath, spath in _resnet_entries(arch):
        p = _get(enc["resnet"], ppath)
        if p is None:  # block without downsample
            continue
        key = f"encoder.resnet_conv.{prefix}"
        if spath is None:
            sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        else:
            s = _get(rs, spath)
            sd[f"{key}.weight"] = _t(p["scale"])
            sd[f"{key}.bias"] = _t(p["bias"])
            sd[f"{key}.running_mean"] = _t(s["mean"])
            sd[f"{key}.running_var"] = _t(s["var"])
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for name in _HEADS:
        sd[f"encoder.{name}.weight"] = _t(np.asarray(enc[name]["kernel"]).T)
        sd[f"encoder.{name}.bias"] = _t(enc[name]["bias"])

    atten = params["decoder"]["adaptive"]["atten"]
    variant = ("adaptive_attention" if "sentinel" in params["decoder"]["adaptive"] else
               "rnn_attention" if "lstm_fwd" in atten else "baseline_attention")
    for name, path, layout in _decoder_entries(variant, "lstm_bwd" in atten):
        sd[name] = from_layout(_get(params, path), layout)
    return sd


def resnet_to_jax(sd: Dict[str, torch.Tensor], arch: str,
                  prefix: str = "encoder.resnet_conv.") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The backbone's part of to_jax: the (params, BN state) trees of the
    ResNet whose state_dict keys start with prefix."""
    rn_p: Dict[str, Any] = {}
    rn_s: Dict[str, Any] = {}
    for name, ppath, spath in _resnet_entries(arch):
        key = f"{prefix}{name}"
        if f"{key}.weight" not in sd:
            continue
        w = _n(sd[f"{key}.weight"])
        if spath is None:
            _set(rn_p, ppath, {"kernel": np.transpose(w, (2, 3, 1, 0))})
        else:
            _set(rn_p, ppath, {"scale": w, "bias": _n(sd[f"{key}.bias"])})
            _set(rn_s, spath, {"mean": _n(sd[f"{key}.running_mean"]),
                               "var": _n(sd[f"{key}.running_var"])})
    return rn_p, rn_s


def to_jax(sd: Dict[str, torch.Tensor], arch: str,
           variant: Optional[str] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of from_jax: state_dict -> JAX (params, state), numpy leaves.
    The decoder's tree is its variant's (_variant_of_state_dict unless
    variant is named); a missing weight raises KeyError naming it."""
    rn_p, rn_s = resnet_to_jax(sd, arch)
    enc: Dict[str, Any] = {"resnet": rn_p}
    for name in _HEADS:
        enc[name] = {"kernel": _n(sd[f"encoder.{name}.weight"]).T,
                     "bias": _n(sd[f"encoder.{name}.bias"])}
    params: Dict[str, Any] = {"encoder": enc}
    found, bidirectional = _variant_of_state_dict(sd)
    for name, path, layout in _decoder_entries(variant or found, bidirectional):
        _set(params, path, np_to_layout(_n(sd[name]), layout))
    return params, {"resnet": rn_s}
