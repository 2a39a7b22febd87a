"""Dual optimizers (decoder / encoder fine-tune) as two torch optimizers over
disjoint parameter lists (counterpart of adaptive_tpu/training/optim.py).

Reference parity: model_factory.py:27-93 —
* decoder group = encoder.affine_a + encoder.affine_b + all decoder params
  (model_factory.py:63-66); encoder.affine_h0/affine_c0 are in NEITHER
  group in the reference (never optimized; their inputs keep their
  gradient path) — replicated intentionally.
* encoder group = ResNet children [opt_fine_tune_cnn_start_layer:]
  (model_factory.py:35-39), stepped only from epoch
  opt_fine_tune_cnn_start_epoch+1 (train.py:89-91,111-115).
* per-group adam (betas (alpha, beta), eps 1e-8) or sgd (Nesterov,
  dampening 0), weight decay as L2 added to the gradient: torch's own
  semantics, which the JAX package's optax chains reproduce; or lbfgs:
  torch.optim.LBFGS(lr, max_iter, history_size) with torch's defaults for
  the rest (model_factory.py:54-56,74-76), stepped with a closure by
  training/lbfgs.py.

Each group's first param_group also counts its updates under "count"
(optax's inject_hyperparams count; torch's SGD keeps no step), so that
checkpoints carry it both ways (training/checkpoint.py). Learning rates are
held at fp32 values, as optax's injected hyperparameters are: a resumed run
reads back from opt.npz the rate it ran with. get_lr/set_lr reach an L-BFGS
group's lr the same way, so the plateau scheduler rescales it
(train.py:57-60,184-194).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from adaptive_tpu_torch.models.resnet import CHILD_NAMES, finetune_mask

GROUPS = ("decoder", "encoder")
_KIND = {"decoder": "rnn", "encoder": "cnn"}


def _f32(x: float) -> float:
    return float(np.float32(x))


class DualOptimizer(NamedTuple):
    """The two groups' optimizers and their parameters by state_dict name."""

    decoder: torch.optim.Optimizer
    encoder: torch.optim.Optimizer
    decoder_names: List[str]
    encoder_names: List[str]

    def group(self, name: str) -> torch.optim.Optimizer:
        return getattr(self, name)

    def names(self, name: str) -> List[str]:
        return getattr(self, f"{name}_names")

    @property
    def decoder_is_lbfgs(self) -> bool:
        return isinstance(self.decoder, torch.optim.LBFGS)

    @property
    def encoder_is_lbfgs(self) -> bool:
        return isinstance(self.encoder, torch.optim.LBFGS)

    def step(self, name: str, closure: Optional[Callable[[], torch.Tensor]] = None):
        """One update of a group: from the gradients in .grad, or for an
        L-BFGS group one step(closure) (up to max_iter evaluations); returns
        what the optimizer's step returns (L-BFGS: the first loss)."""
        opt = self.group(name)
        loss = opt.step() if closure is None else opt.step(closure)
        opt.param_groups[0]["count"] += 1
        return loss


def param_group_names(net, cf) -> Dict[str, List[str]]:
    """{group: state_dict names of its parameters}, in the net's order.

    decoder: encoder.affine_a/affine_b + decoder.* (model_factory.py:63-66)
    encoder: resnet children [start_layer:]        (model_factory.py:35-39)"""
    trainable = finetune_mask(cf.opt_fine_tune_cnn_start_layer)
    groups: Dict[str, List[str]] = {"decoder": [], "encoder": []}
    for name, _ in net.named_parameters():
        if name.startswith(("decoder.", "encoder.affine_a.", "encoder.affine_b.")):
            groups["decoder"].append(name)
        elif name.startswith("encoder.resnet_conv."):
            if trainable[CHILD_NAMES[int(name.split(".")[2])]]:
                groups["encoder"].append(name)
    return groups


def make_group_optimizer(kind: str, params, cf) -> torch.optim.Optimizer:
    """kind: 'rnn' (decoder group) or 'cnn' (encoder group)."""
    opt_name = getattr(cf, f"opt_{kind}_optimization")

    def knob(name):
        return getattr(cf, f"opt_{kind}_{name}")

    group = [{"params": params, "count": 0}]
    if opt_name == "adam":
        return torch.optim.Adam(
            group, lr=_f32(knob("adam_learning_rate")),
            betas=(knob("adam_alpha"), knob("adam_beta")), eps=1e-8,
            weight_decay=knob("adam_weight_decay"))
    if opt_name == "sgd":
        return torch.optim.SGD(
            group, lr=_f32(knob("sgd_learning_rate")), momentum=knob("sgd_momentum"),
            dampening=0, weight_decay=knob("sgd_weight_decay"), nesterov=True)
    if opt_name == "lbfgs":
        # no line_search_fn, default max_eval and tolerances, as the
        # reference builds it (model_factory.py:54-56,74-76)
        return torch.optim.LBFGS(
            group, lr=_f32(knob("lbfgs_lr")), max_iter=knob("lbfgs_max_iter"),
            history_size=knob("lbfgs_history"))
    raise ValueError(f"unknown optimizer {opt_name!r}")


def make_dual_optimizer(net, cf) -> DualOptimizer:
    params = dict(net.named_parameters())
    names = param_group_names(net, cf)
    opts = {g: make_group_optimizer(_KIND[g], [params[n] for n in names[g]], cf)
            for g in GROUPS}
    return DualOptimizer(opts["decoder"], opts["encoder"], names["decoder"], names["encoder"])


def get_lr(dual: DualOptimizer, group: str) -> float:
    return float(dual.group(group).param_groups[0]["lr"])


def set_lr(dual: DualOptimizer, group: str, lr: float) -> DualOptimizer:
    """Set a group's learning rate in place (the host-side scheduler hook);
    returns dual, as the JAX package's set_lr returns the new state."""
    dual.group(group).param_groups[0]["lr"] = _f32(lr)
    return dual
