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

ZeRO-1 (``opt_state_sharding="data"``, ``shard_opt_state``): for each Adam
or SGD parameter that JAX's rule picks (parallel/mesh.py::
opt_state_sharding_rules), a data rank owns the slice [r*n/D, (r+1)*n/D) of
its dim and the group's optimizer steps a leaf holding that slice, so the
moments live for the slice only; each step hands the leaf its slice of the
gradient and all-gathers the updated slices back into the parameter over the
data group. The updates are the replicated ones: the rules are elementwise.
An L-BFGS group's memory stays whole on every rank (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from adaptive_tpu_torch.models.resnet import CHILD_NAMES, finetune_mask
from adaptive_tpu_torch.parallel.mesh import gather

GROUPS = ("decoder", "encoder")
_KIND = {"decoder": "rnn", "encoder": "cnn"}


def _f32(x: float) -> float:
    return float(np.float32(x))


class ZeroShard(NamedTuple):
    """A parameter's ZeRO-1 slice: `shard` (a leaf the group's optimizer
    steps) holds param.narrow(dim, start, length)."""

    param: torch.Tensor
    shard: torch.Tensor
    dim: int
    start: int
    length: int

    def scatter_grad(self) -> None:
        """The leaf takes the parameter's values and its gradient's slice."""
        with torch.no_grad():
            self.shard.copy_(self.param.narrow(self.dim, self.start, self.length))
        g = self.param.grad
        self.shard.grad = None if g is None else g.narrow(
            self.dim, self.start, self.length).contiguous()

    def full(self, t: torch.Tensor, group) -> torch.Tensor:
        """The data group's slices of a tensor shaped as the shard, whole
        (an all-gather every rank of the group enters)."""
        return gather(t, group, self.dim)


class Zero1(NamedTuple):
    """ZeRO-1's state: the data group and each sharded parameter's slice."""

    group: Any
    shards: Dict[str, ZeroShard]

    def gather(self, names) -> None:
        """The updated slices of the named parameters into every rank's
        parameter."""
        for n in names:
            z = self.shards.get(n)
            if z is not None:
                with torch.no_grad():
                    z.param.copy_(z.full(z.shard.detach(), self.group))


class DualOptimizer(NamedTuple):
    """The two groups' optimizers and their parameters by state_dict name;
    zero: ZeRO-1's slices (shard_opt_state), or None."""

    decoder: torch.optim.Optimizer
    encoder: torch.optim.Optimizer
    decoder_names: List[str]
    encoder_names: List[str]
    zero: Optional[Zero1] = None

    def state_key(self, name: str, param: torch.Tensor) -> torch.Tensor:
        """The tensor its group's optimizer keys the parameter's state by:
        its ZeRO-1 leaf where it is sharded, else itself."""
        z = self.zero.shards.get(name) if self.zero is not None else None
        return param if z is None else z.shard

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
        sharded = [] if self.zero is None else [
            n for n in self.names(name) if n in self.zero.shards]
        for n in sharded:
            self.zero.shards[n].scatter_grad()
        loss = opt.step() if closure is None else opt.step(closure)
        opt.param_groups[0]["count"] += 1
        if sharded:
            self.zero.gather(sharded)
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


def shard_opt_state(dual: DualOptimizer, net, mesh) -> DualOptimizer:
    """ZeRO-1 over the mesh's data axis (module docstring): each Adam or SGD
    group is rebuilt over its parameters with the picked ones replaced by
    this rank's slice leaves, its hyperparameters, count and state carried
    over (a moment sliced). L-BFGS groups stay as they are. Returns dual
    unchanged at data size 1."""
    from adaptive_tpu_torch.parallel.mesh import opt_state_sharding_rules

    if mesh.data_size == 1:
        return dual
    params = dict(net.named_parameters())
    rules = opt_state_sharding_rules(params, mesh, net.encoder.resnet_conv.arch)
    shards: Dict[str, ZeroShard] = {}
    opts = {}
    for g in GROUPS:
        opt = dual.group(g)
        if isinstance(opt, torch.optim.LBFGS):
            opts[g] = opt
            continue
        plist, states = [], []
        for name in dual.names(g):
            p, dim = params[name], rules[name]
            st = opt.state.get(p, {})
            if dim is None:
                plist.append(p)
                states.append((p, st))
                continue
            length = p.shape[dim] // mesh.data_size
            start = mesh.data_rank * length
            leaf = p.detach().narrow(dim, start, length).clone().requires_grad_(True)
            shards[name] = ZeroShard(p, leaf, dim, start, length)
            plist.append(leaf)
            states.append((leaf, {k: v.narrow(dim, start, length).clone()
                                  if torch.is_tensor(v) and v.shape == p.shape else v
                                  for k, v in st.items()}))
        pg = {k: v for k, v in opt.param_groups[0].items() if k != "params"}
        new = type(opt)([{**pg, "params": plist}], **opt.defaults)
        for key, st in states:
            if st:
                new.state[key] = st
        opts[g] = new
    return dual._replace(decoder=opts["decoder"], encoder=opts["encoder"],
                         zero=Zero1(mesh.data_group, shards))
