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
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from adaptive_tpu_torch.models.resnet import RESNET_SPECS

_LAYER0 = 4  # resnet_conv index of layer1: [conv1, bn1, relu, maxpool, layer1..4]
_ATTEN = ("affine_v", "affine_g", "affine_s", "affine_h")
_SENTINEL = ("affine_x", "affine_h")
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


def param_keys(arch: str) -> Dict[str, Tuple[str, str]]:
    """{state_dict name of every parameter of an Encoder2Decoder (blocks
    without a downsample included; callers look names up): (its JAX key
    under "params", in the checkpoint's ``|`` codec, its layout)}. Layouts:
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
    out["decoder.embed.weight"] = ("decoder|embed", "vector")
    for jk, tk in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
        out[f"decoder.LSTM.{tk}"] = (f"decoder|lstm|{jk}", "linear")
    for jk, tk in (("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        out[f"decoder.LSTM.{tk}"] = (f"decoder|lstm|{jk}", "vector")
    for name in _ATTEN:
        out[f"decoder.adaptive.atten.{name}.weight"] = (
            f"decoder|adaptive|atten|{name}|kernel", "linear")
    for name in _SENTINEL:
        out[f"decoder.adaptive.sentinel.{name}.weight"] = (
            f"decoder|adaptive|sentinel|{name}|kernel", "linear")
    out["decoder.adaptive.mlp.weight"] = ("decoder|adaptive|mlp|kernel", "linear")
    out["decoder.adaptive.mlp.bias"] = ("decoder|adaptive|mlp|bias", "vector")
    return out


def to_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    """A tensor in torch's layout -> a numpy host copy in JAX's (a view of
    the copy, transposed)."""
    a = _n(t)
    if layout == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    return a.T if layout == "linear" else a


def from_layout(a, layout: str) -> torch.Tensor:
    """Inverse of to_layout (a CPU tensor)."""
    a = np.asarray(a)
    if layout == "conv":
        a = np.transpose(a, (3, 2, 0, 1))
    elif layout == "linear":
        a = a.T
    return _t(a)


def from_jax(params: Dict, state: Dict, arch: str) -> Dict[str, torch.Tensor]:
    """JAX (params, state) of an adaptive_attention model -> state_dict with
    the reference Encoder2Decoder's keys (CPU tensors)."""
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

    dec = params["decoder"]
    sd["decoder.embed.weight"] = _t(dec["embed"])
    for jk, tk in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
        sd[f"decoder.LSTM.{tk}"] = _t(np.asarray(dec["lstm"][jk]).T)
    sd["decoder.LSTM.bias_ih_l0"] = _t(dec["lstm"]["b_ih"])
    sd["decoder.LSTM.bias_hh_l0"] = _t(dec["lstm"]["b_hh"])
    blk = dec["adaptive"]
    for name in _ATTEN:
        sd[f"decoder.adaptive.atten.{name}.weight"] = _t(np.asarray(blk["atten"][name]["kernel"]).T)
    for name in _SENTINEL:
        sd[f"decoder.adaptive.sentinel.{name}.weight"] = _t(
            np.asarray(blk["sentinel"][name]["kernel"]).T)
    sd["decoder.adaptive.mlp.weight"] = _t(np.asarray(blk["mlp"]["kernel"]).T)
    sd["decoder.adaptive.mlp.bias"] = _t(blk["mlp"]["bias"])
    return sd


def to_jax(sd: Dict[str, torch.Tensor], arch: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of from_jax: state_dict -> JAX (params, state), numpy leaves."""
    rn_p: Dict[str, Any] = {}
    rn_s: Dict[str, Any] = {}
    for prefix, ppath, spath in _resnet_entries(arch):
        key = f"encoder.resnet_conv.{prefix}"
        if f"{key}.weight" not in sd:
            continue
        w = _n(sd[f"{key}.weight"])
        if spath is None:
            _set(rn_p, ppath, {"kernel": np.transpose(w, (2, 3, 1, 0))})
        else:
            _set(rn_p, ppath, {"scale": w, "bias": _n(sd[f"{key}.bias"])})
            _set(rn_s, spath, {"mean": _n(sd[f"{key}.running_mean"]),
                               "var": _n(sd[f"{key}.running_var"])})
    enc: Dict[str, Any] = {"resnet": rn_p}
    for name in _HEADS:
        enc[name] = {"kernel": _n(sd[f"encoder.{name}.weight"]).T,
                     "bias": _n(sd[f"encoder.{name}.bias"])}
    dec = {
        "embed": _n(sd["decoder.embed.weight"]),
        "lstm": {"w_ih": _n(sd["decoder.LSTM.weight_ih_l0"]).T,
                 "w_hh": _n(sd["decoder.LSTM.weight_hh_l0"]).T,
                 "b_ih": _n(sd["decoder.LSTM.bias_ih_l0"]),
                 "b_hh": _n(sd["decoder.LSTM.bias_hh_l0"])},
        "adaptive": {
            "atten": {n: {"kernel": _n(sd[f"decoder.adaptive.atten.{n}.weight"]).T}
                      for n in _ATTEN},
            "sentinel": {n: {"kernel": _n(sd[f"decoder.adaptive.sentinel.{n}.weight"]).T}
                         for n in _SENTINEL},
            "mlp": {"kernel": _n(sd["decoder.adaptive.mlp.weight"]).T,
                    "bias": _n(sd["decoder.adaptive.mlp.bias"])},
        },
    }
    return {"encoder": enc, "decoder": dec}, {"resnet": rn_s}
