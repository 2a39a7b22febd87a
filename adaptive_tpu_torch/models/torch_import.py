"""Offline ingestion of PyTorch weights: torchvision ResNets, reference
checkpoints and pretrained trunk files (counterpart of
adaptive_tpu/models/torch_import.py).

The port's modules keep the reference's layouts and names, so for the port
the converters are renames and checks, not layout changes:

1. ``convert_torchvision_resnet``: a torchvision ResNet state_dict
   (``conv1``, ``bn1``, ``layer1.0.conv1``, ...) -> the state_dict of the
   port's ``ResNet`` (the reference's ``nn.Sequential`` of the trunk:
   ``0`` = conv1, ``1`` = bn1, ``4``..``7`` = layer1..4).
2. ``convert_reference_checkpoint``: a reference Encoder2Decoder
   state_dict of any of the three variants -> the port's Encoder2Decoder
   state_dict (the same names, checked and as float32 tensors).
3. ``save_resnet_npz`` and ``save_reference_checkpoint_npz`` write the JAX
   package's files (a trunk ``.npz`` for ``encoder_pretrained_npz``; a
   checkpoint dir), which both packages' ``load_pretrained_resnet`` and
   ``restore_model`` read. ``load_pretrained_resnet`` installs a trunk file.

Numpy and torch only; a path argument is read with ``torch.load``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# the reference's nn.Sequential children of the trunk (baseline_attention.py:
# 17-18, list(resnet.children())[:-2]) by their torchvision names
_SEQ_OF = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}
_TV_OF = {v: k for k, v in _SEQ_OF.items()}


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).detach()


def _load(state_dict_or_path) -> Dict[str, Any]:
    if isinstance(state_dict_or_path, str):
        return torch.load(state_dict_or_path, map_location="cpu")
    return state_dict_or_path


def convert_torchvision_resnet(sd: Dict[str, Any], arch: str) -> Dict[str, torch.Tensor]:
    """torchvision resnet state_dict (tensors or numpy arrays) -> the state_dict
    of the port's ResNet(arch): every key the arch has, renamed, as CPU
    tensors (float32; the BN counters int64, 0 where the file has none).
    A missing weight raises KeyError naming its torchvision key; fc.* and
    other extra keys are ignored."""
    from adaptive_tpu_torch.models.resnet import ResNet

    with torch.device("meta"):
        want = ResNet(arch).state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in want.items():
        head, _, tail = key.partition(".")
        tv = f"{_TV_OF[head]}.{tail}"
        if key.endswith("num_batches_tracked"):
            out[key] = _tensor(sd[tv]).long() if tv in sd else torch.tensor(0)
            continue
        if tv not in sd:
            raise KeyError(f"state_dict missing {tv!r} (the {arch} trunk's {key!r})")
        t = _tensor(sd[tv]).float()
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {tv}: {tuple(t.shape)} vs {tuple(ref.shape)}")
        out[key] = t
    return out


def convert_reference_checkpoint(sd: Dict[str, Any], variant: str,
                                 arch: str = "resnet152") -> Dict[str, torch.Tensor]:
    """Reference Encoder2Decoder.state_dict() of the variant -> the port's
    Encoder2Decoder state_dict (the names of adaptive_attention.py:89-108,
    baseline_attention.py:100-128 and rnn_attention.py:13-29, which the port
    keeps), through the JAX layouts and back (models/jax_params.py), which
    checks that every head and decoder weight of the variant is there
    (KeyError naming it) and drops what the model does not read. An rnn
    aggregator without *_reverse tensors is unidirectional, as in the JAX
    package. The trunk's keys are checked when the state_dict is loaded."""
    from adaptive_tpu_torch.models.jax_params import from_jax, to_jax

    return from_jax(*to_jax({k: _tensor(v) for k, v in sd.items()}, arch, variant), arch)


def pad_vocab_params(sd: Dict[str, torch.Tensor], padded_vocab: int) -> Dict[str, torch.Tensor]:
    """Zero-pad the embedding rows and the head's output rows and bias of an
    Encoder2Decoder state_dict to padded_vocab (an unpadded checkpoint into
    a vocab-padded model; padded logits are masked at apply time, so the
    outputs are the same). Other entries are passed through."""
    out = dict(sd)
    V = sd["decoder.embed.weight"].shape[0]
    if V < padded_vocab:
        for key in ("decoder.embed.weight", "decoder.adaptive.mlp.weight",
                    "decoder.adaptive.mlp.bias"):
            if key in sd:
                t = _tensor(sd[key])
                pad = t.new_zeros((padded_vocab - V, *t.shape[1:]))
                out[key] = torch.cat([t, pad])
    return out


def load_pretrained_resnet(npz_path: str, net):
    """Install a converted trunk .npz into ``net``'s ResNet in place and
    return net. Every leaf of the trunk the net's arch gives must be in the
    file with the same shape (KeyError / ValueError naming it, as the JAX
    package's checks); the heads and the decoder keep their weights."""
    from adaptive_tpu_torch.models.jax_params import from_jax, to_jax
    from adaptive_tpu_torch.training.checkpoint import flatten_tree, unflatten_tree

    arch = net.encoder.resnet_conv.arch
    sd = net.state_dict()
    params, state = to_jax(sd, arch)
    want = flatten_tree({"resnet": params["encoder"]["resnet"], "state": state["resnet"]})
    with np.load(npz_path) as data:
        flat = dict(data)
    picked = {}
    for key, leaf in want.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(flat[key].shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {flat[key].shape} vs model {leaf.shape}")
        picked[key] = flat[key].astype(leaf.dtype)
    tree = unflatten_tree(picked)
    params["encoder"]["resnet"] = tree["resnet"]
    trunk = {k: v for k, v in from_jax(params, {"resnet": tree["state"]}, arch).items()
             if k.startswith("encoder.resnet_conv.")}
    net.load_state_dict({**sd, **trunk})
    return net


def save_resnet_npz(state_dict_or_path, arch: str, out_path: str):
    """Offline converter: a torchvision resnet state_dict (or its .pth) ->
    the trunk .npz that encoder_pretrained_npz names, in the JAX package's
    keys and layouts (``resnet|...``, ``state|...``)."""
    from adaptive_tpu_torch.models.jax_params import resnet_to_jax
    from adaptive_tpu_torch.training.checkpoint import flatten_tree

    rn = convert_torchvision_resnet(_load(state_dict_or_path), arch)
    params, state = resnet_to_jax(rn, arch, prefix="")
    np.savez(out_path, **flatten_tree({"resnet": params, "state": state}))


def save_reference_checkpoint_npz(state_dict_or_path, variant: str, arch: str, out_dir: str):
    """Offline converter: a reference model .pkl (or its state_dict) -> a
    checkpoint dir in the JAX package's format (model.npz, manifest.json),
    which both packages' restore_model read."""
    from adaptive_tpu_torch.models.jax_params import to_jax
    from adaptive_tpu_torch.training.checkpoint import _write_checkpoint_files, flatten_tree

    sd = convert_reference_checkpoint(_load(state_dict_or_path), variant, arch)
    params, state = to_jax(sd, arch)
    _write_checkpoint_files(out_dir, flatten_tree({"params": params, "state": state}), None,
                            {"source": "reference", "variant": variant})
