"""The train step when an optimizer group is L-BFGS, and the L-BFGS curvature
memory in the JAX package's checkpoint format (counterpart of
adaptive_tpu/training/lbfgs.py).

Reference semantics (train.py:108-115 + model_optimize:197-219): the decoder
group steps first; with CNN fine-tuning on, the encoder group steps after.
An L-BFGS group is torch.optim.LBFGS(lr, max_iter, history_size) without a
line search (training/optim.py), stepped once a batch with a closure that
re-evaluates the loss and its gradients up to max_iter times; its curvature
memory persists across batches, including the first pair of a new batch,
formed against the previous batch's last gradient. The JAX package wrote its
L-BFGS to these semantics; the rules it keeps, and this step with it:

* the decoder group's closure re-runs only the affine heads and the
  teacher-forced decoder: the trunk runs once a batch, without autograd
  (its weights and BN statistics are fixed during the decoder's step);
* every evaluation of the decoder's closure clips the LSTM gradients
  before L-BFGS reads them; the step reports the norm of the last one;
* BN running statistics update once a batch, from the first forward; every
  later train-mode forward (an encoder closure, the extra backward below)
  normalises with the batch statistics and leaves the running ones as they
  are (ResNet.forward(update_stats=False));
* every evaluation of one batch sees the same crop, flip and dropout masks:
  the batch is preprocessed once, and the generator is rewound to the same
  state before each forward;
* an Adam or SGD encoder group after an L-BFGS decoder group steps on the
  gradients at the decoder's last evaluation point (where torch's .grad
  points when step(closure) returns: torch skips the re-evaluation on the
  max_iter-th iteration, so the final weights may differ from it), obtained
  with one backward there with autograd from opt_fine_tune_cnn_start_layer;
* an Adam or SGD decoder group before an L-BFGS encoder group takes one
  forward and backward with the trunk frozen; the encoder group's closure
  then re-runs the whole model.

Each backward computes the gradients of the stepped group only: the other
parameters stop requiring gradients for its duration, as JAX differentiates
the group's subset alone. torch.optim.LBFGS reads on the host each
evaluation's loss, its convergence tests, and in the two-loop recursion
each pair's coefficient (passed to add_ as a Python number): the step syncs
with the host twice a pair an iteration (ROADMAP.md §3).

On a mesh every evaluation's loss and gradients are the data group's sums
over the global valid count (training/step.py's rules: draws at the global
batch's shape, BN moments over the group), so torch's LBFGS sees the global
function on every rank, as GSPMD gives JAX's step; its curvature memory
stays whole on every rank (ROADMAP.md §3).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, NamedTuple

import numpy as np
import torch

from adaptive_tpu_torch.models import decoders as D
from adaptive_tpu_torch.models import encoder as E
from adaptive_tpu_torch.models.factory import require_lstm
from adaptive_tpu_torch.models.resnet import CHILD_NAMES
from adaptive_tpu_torch.ops import preprocess
from adaptive_tpu_torch.ops.dropout import make_dropout
from adaptive_tpu_torch.parallel.mesh import all_reduce_sum_
from adaptive_tpu_torch.training.optim import DualOptimizer
from adaptive_tpu_torch.training.step import (
    LSTM_NAMES, StepOutput, all_reduce_grads, clip_lstm_grads, masked_ce_sum,
)


@contextlib.contextmanager
def _grads_only(net, names: Iterable[str]):
    """Only the named parameters require gradients inside the block."""
    keep = set(names)
    off = [p for n, p in net.named_parameters() if n not in keep and p.requires_grad]
    for p in off:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in off:
            p.requires_grad_(True)


def make_lbfgs_train_step(model, dual: DualOptimizer, cf, mesh=None):
    """Returns train_step(net, batch, gen, encoder_on=False) -> StepOutput,
    the interface of training/step.py::make_train_step; the loss is the
    first evaluation's (what torch's LBFGS.step returns)."""
    require_lstm(model, "L-BFGS training")
    crop = cf.train_crop_size
    max_norm = cf.train_lstm_maxnormal
    start_layer = cf.opt_fine_tune_cnn_start_layer
    frozen_trunk = len(CHILD_NAMES)
    dec_names, enc_names = dual.names("decoder"), dual.names("encoder")
    group = mesh.data_group if mesh is not None else None
    rows = mesh.rows if mesh is not None else None

    def train_step(net, batch, gen: torch.Generator, encoder_on: bool = False) -> StepOutput:
        batch = {k: torch.as_tensor(batch[k], device=model.device)
                 for k in ("images", "captions", "lengths")}
        caps, lens = batch["captions"], batch["lengths"]
        params = dict(net.named_parameters())
        lstm = [params[k] for k in LSTM_NAMES]
        images = preprocess.train_preprocess(gen, batch["images"], crop, model.compute_dtype,
                                             rows)
        drawn = gen.get_state()  # the dropout masks start here, every evaluation
        # the batch's valid count (masked_ce_sum's mask), over the data group
        steps = torch.arange(caps.shape[1] - 1, device=caps.device)
        count = (steps[None, :] < (lens[:, None] - 1)).sum().float().reshape(1)
        all_reduce_sum_([count], group)
        count = torch.clamp(count[0], min=1)

        def zero_grads():
            for p in params.values():
                p.grad = None

        def mean_loss(scores):
            """This rank's NLL over the global count (what its backward
            takes) and the global loss (what LBFGS reads)."""
            local = masked_ce_sum(scores, caps, lens)[0] / count
            total = local.detach().clone().reshape(1)
            all_reduce_sum_([total], group)
            return local, total[0]

        def backward(local):
            local.backward()
            all_reduce_grads(params.values(), group)

        def full_loss(grad_from, update_stats):
            gen.set_state(drawn)
            scores, _ = model.forward(net, images, caps, train=True, gen=gen,
                                      grad_from=grad_from, update_stats=update_stats, mesh=mesh)
            return mean_loss(scores)

        norm = [None]
        eval_point: List[torch.Tensor] = []
        if dual.decoder_is_lbfgs:
            with torch.no_grad():  # the trunk once a batch; its BN statistics update here
                A_flat, a_g = E.encoder_features(net.encoder, images, True, frozen_trunk,
                                                 bn_group=group)
            record = encoder_on and not dual.encoder_is_lbfgs
            dec_params = [params[n] for n in dec_names]

            def dec_closure():
                zero_grads()
                gen.set_state(drawn)
                drop = make_dropout(gen, model.dropout_rate, rows)
                V, v_g, h0, c0 = E.encoder_heads(
                    E.head_params(net.encoder, detach=False), A_flat, a_g, drop)
                scores, _, _ = D.decoder_forward(
                    D.decoder_params(net.decoder, detach=False), model.spec, V, v_g,
                    caps.long(), h0, c0, drop=drop)
                local, loss = mean_loss(scores)
                backward(local)
                norm[0] = clip_lstm_grads([p.grad for p in lstm], max_norm)
                if record:
                    eval_point[:] = [p.detach().clone() for p in dec_params]
                return loss

            with _grads_only(net, dec_names):
                loss = dual.step("decoder", dec_closure)
        else:
            # one evaluation: loss, gradients and LSTM norm; the trunk's
            # weight gradients would feed nothing (the encoder group, if on,
            # re-runs its own closure)
            zero_grads()
            with _grads_only(net, dec_names):
                local, loss = full_loss(frozen_trunk, True)
                backward(local)
            norm[0] = clip_lstm_grads([p.grad for p in lstm], max_norm)
            dual.step("decoder")

        if encoder_on:
            with _grads_only(net, enc_names):
                if dual.encoder_is_lbfgs:
                    def enc_closure():
                        zero_grads()
                        local, loss = full_loss(start_layer, False)
                        backward(local)
                        return loss

                    dual.step("encoder", enc_closure)
                else:
                    # the encoder's gradients at the decoder's last evaluation
                    # point (its weights are untouched by the decoder's step)
                    with torch.no_grad():
                        final = [p.detach().clone() for p in dec_params]
                        for p, v in zip(dec_params, eval_point):
                            p.copy_(v)
                    zero_grads()
                    backward(full_loss(start_layer, False)[0])
                    with torch.no_grad():
                        for p, v in zip(dec_params, final):
                            p.copy_(v)
                    dual.step("encoder")
        return StepOutput(loss.detach(), norm[0])

    return train_step


# ------------------------------------------------------------------ the codec
class Segment(NamedTuple):
    """One parameter's place in the group's flat vectors: torch's (the
    group's parameters in dual.names order, each view(-1)) and JAX's (the
    trainable subset in the JAX tree's leaf order, each raveled in JAX's
    layout, as ravel_pytree flattens it)."""

    offset: int  # in torch's vector
    jax_offset: int
    shape: tuple  # torch's
    layout: str


def _tree_order(key: str):
    """The JAX tree's leaf order: dict keys sorted, list indices in order."""
    return tuple((0, int(s[1:]), "") if s.startswith("#") else (1, 0, s)
                 for s in key.split("|"))


def group_segments(net, names: List[str]) -> List[Segment]:
    """The segments of a group's parameters (names in dual.names order), in
    JAX's order."""
    from adaptive_tpu_torch.models.jax_params import param_keys

    keys = param_keys(net.encoder.resnet_conv.arch)
    params = dict(net.named_parameters())
    offsets, off = {}, 0
    for n in names:
        offsets[n] = off
        off += params[n].numel()
    segs, joff = [], 0
    for n in sorted(names, key=lambda n: _tree_order(keys[n][0])):
        segs.append(Segment(offsets[n], joff, tuple(params[n].shape), keys[n][1]))
        joff += params[n].numel()
    return segs


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def to_jax_vector(vec: torch.Tensor, segs: List[Segment]) -> np.ndarray:
    """A flat vector in torch's order -> a numpy host copy in JAX's."""
    from adaptive_tpu_torch.models.jax_params import np_to_layout

    a = vec.detach().to("cpu", copy=True).numpy()
    out = np.empty(a.shape, np.float32)
    for s in segs:
        k = _numel(s.shape)
        out[s.jax_offset:s.jax_offset + k] = np_to_layout(
            a[s.offset:s.offset + k].reshape(s.shape), s.layout).reshape(-1)
    return out


def from_jax_vector(arr: np.ndarray, segs: List[Segment], device) -> torch.Tensor:
    """Inverse of to_jax_vector, on device."""
    from adaptive_tpu_torch.models.jax_params import np_from_layout, np_to_layout

    out = np.empty(arr.shape, np.float32)
    for s in segs:
        k = _numel(s.shape)
        jshape = np_to_layout(np.empty(s.shape, np.float32), s.layout).shape
        out[s.offset:s.offset + k] = np_from_layout(
            arr[s.jax_offset:s.jax_offset + k].reshape(jshape), s.layout).reshape(-1)
    return torch.from_numpy(out).to(device)


MEMORY_FIELDS = ("s", "y", "rho", "head", "count", "d", "t", "prev_grad", "prev_loss", "n_iter")


def memory_to_jax(opt: torch.optim.LBFGS, segs: List[Segment]) -> Dict[str, np.ndarray]:
    """torch's LBFGS state -> the JAX package's LBFGSMemory fields (numpy
    host copies). torch's lists hold the pairs oldest first; they go to the
    ring's rows 0..count-1 with head = count % h, so that list index j is
    row (head - count + j) % h, as JAX's ring reads. A group never stepped
    writes JAX's zeros."""
    n = sum(_numel(s.shape) for s in segs)
    h = opt.defaults["history_size"]
    st = opt.state.get(opt._params[0], {})
    out = {"s": np.zeros((h, n), np.float32), "y": np.zeros((h, n), np.float32),
           "rho": np.zeros((h,), np.float32)}
    pairs = list(zip(st.get("old_stps", []), st.get("old_dirs", []), st.get("ro", [])))
    for j, (s, y, ro) in enumerate(pairs):
        out["s"][j] = to_jax_vector(s, segs)
        out["y"][j] = to_jax_vector(y, segs)
        out["rho"][j] = float(ro)
    zeros = np.zeros((n,), np.float32)
    out["head"] = np.asarray(len(pairs) % h, np.int32)
    out["count"] = np.asarray(len(pairs), np.int32)
    out["d"] = to_jax_vector(st["d"], segs) if "d" in st else zeros
    out["t"] = np.asarray(float(st.get("t", 0.0)), np.float32)
    prev = st.get("prev_flat_grad")
    out["prev_grad"] = to_jax_vector(prev, segs) if prev is not None else zeros
    out["prev_loss"] = np.asarray(float(st.get("prev_loss") or 0.0), np.float32)
    out["n_iter"] = np.asarray(st.get("n_iter", 0), np.int32)
    return out


def memory_from_jax(opt: torch.optim.LBFGS, mem: Dict[str, np.ndarray],
                    segs: List[Segment]) -> None:
    """Inverse of memory_to_jax, in place: JAX's ring rows oldest first
    into torch's lists, H_diag recomputed from the newest pair as torch
    computes it ((y.s) / (y.y)); n_iter 0 is torch's empty state."""
    p0 = opt._params[0]
    opt.state.pop(p0, None)
    n_iter = int(mem["n_iter"])
    if not n_iter:
        return
    dev = p0.device
    h, count, head = mem["s"].shape[0], int(mem["count"]), int(mem["head"])
    rows = [(head - count + j) % h for j in range(count)]
    old_stps = [from_jax_vector(mem["s"][r], segs, dev) for r in rows]
    old_dirs = [from_jax_vector(mem["y"][r], segs, dev) for r in rows]
    ro = [torch.tensor(mem["rho"][r], dtype=torch.float32, device=dev) for r in rows]
    h_diag = 1
    if count:
        y, s = old_dirs[-1], old_stps[-1]
        h_diag = y.dot(s) / y.dot(y)
    opt.state[p0] = {
        "n_iter": n_iter, "d": from_jax_vector(mem["d"], segs, dev),
        "t": float(mem["t"]), "old_dirs": old_dirs, "old_stps": old_stps, "ro": ro,
        "H_diag": h_diag, "prev_flat_grad": from_jax_vector(mem["prev_grad"], segs, dev),
        "prev_loss": float(mem["prev_loss"]),
    }
