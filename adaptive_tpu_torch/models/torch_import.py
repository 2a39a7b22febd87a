"""Pretrained ResNet trunks (counterpart of adaptive_tpu/models/torch_import.py,
``load_pretrained_resnet`` only; the rest of that module is ROADMAP.md,
queue 1, item 5).

A trunk file is the JAX package's ``save_resnet_npz`` output: torchvision
ImageNet weights converted offline into the JAX layouts, one array per leaf
of ``{"resnet": params, "state": BN statistics}`` under the checkpoint's key
codec (``resnet|layer1|#0|conv1|kernel``, ``state|bn1|mean``). It is
installed through the weight bridge (models/jax_params.py), numpy only.
"""

from __future__ import annotations

import numpy as np


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
