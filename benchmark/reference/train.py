"""Plain PyTorch reference of the teacher-forced train step: augmentation,
train-mode BN with running statistics, the masked cross-entropy, autograd,
the clip of the decoder LSTM's gradients and Adam on two parameter groups,
as the reference code's train.py and model_factory.py define them.

Groups: the decoder group is the decoder and the encoder's affine_a and
affine_b heads (affine_h0 and affine_c0 are in neither group, so they never
move, while their inputs carry gradient); the encoder group is the ResNet's
children from ``opt_fine_tune_cnn_start_layer`` on, stepped only when the
encoder is fine-tuned. Every BN's running statistics update once a step,
from the batch's moments (momentum 0.1, unbiased variance).

Memory: the trained ResNet blocks are recomputed in the backward
(torch.utils.checkpoint), so a batch of 256 fits beside nothing else.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.model import (
    BN_MOMENTUM, TRUNK, Reference, identity, preprocess_train, tf32_off,
)

LSTM_NAMES = ("decoder.LSTM.weight_ih_l0", "decoder.LSTM.weight_hh_l0",
              "decoder.LSTM.bias_ih_l0", "decoder.LSTM.bias_hh_l0")
CHILDREN = ("conv1", "bn1", "relu", "maxpool", "layer1", "layer2", "layer3", "layer4")


def groups(names, cfg: Dict, encoder_on: bool) -> Dict[str, List[str]]:
    """{"decoder": [...], "encoder": [...]} of trainable state_dict names."""
    start = cfg["opt_fine_tune_cnn_start_layer"]
    out = {"decoder": [], "encoder": []}
    for n in names:
        if n.startswith(("decoder.", "encoder.affine_a.", "encoder.affine_b.")):
            out["decoder"].append(n)
        elif (encoder_on and n.startswith(TRUNK + ".") and not n.endswith(
                ("running_mean", "running_var", "num_batches_tracked"))
                and int(n.split(".")[2]) >= start):
            out["encoder"].append(n)
    return out


def bn_buffers(names) -> List[str]:
    return [n for n in names if n.endswith(("running_mean", "running_var"))]


def masked_ce(logits: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor):
    """Mean NLL of captions[:, t+1] under logits[:, t] over t < length - 1."""
    T = captions.shape[1]
    logp = torch.log_softmax(logits[:, : T - 1], dim=-1)
    nll = -logp.gather(-1, captions[:, 1:].long()[..., None])[..., 0]
    mask = torch.arange(T - 1, device=logits.device)[None, :] < (lengths[:, None] - 1)
    return (nll * mask).sum() / mask.sum().clamp(min=1)


class Adam:
    """torch.optim.Adam's update (no weight decay), one group."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas, eps: float = 1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, betas[0], betas[1], eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.p.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


def _forward_loss(ref: Reference, cfg: Dict, batch: Dict, start: int, moments: List):
    """Loss of one batch; BN moments appended to `moments` in forward order
    (the recomputation in the backward appends none)."""
    x = preprocess_train(batch["images"], batch["tops"], batch["lefts"], batch["flips"],
                         cfg["train_crop_size"])
    blocks = ref.blocks()
    with torch.set_grad_enabled(torch.is_grad_enabled() and start <= 0):
        y = ref.stem(x, True, moments)
    for li, p, stride, down in blocks:
        trained = torch.is_grad_enabled() and start <= 4 + li
        if not trained:
            with torch.no_grad():
                y = ref.block(y, p, stride, down, True, moments)
            continue
        ran = []

        def run(inp, p=p, stride=stride, down=down, ran=ran):
            out = ref.block(inp, p, stride, down, True, None if ran else moments)
            ran.append(True)
            return out

        y = checkpoint(run, y, use_reentrant=False)
    V, v_g, h0, c0 = ref.heads(y)
    logits = ref.run_decoder(V, v_g, h0, c0, batch["captions"], sampler=False)[0]
    return masked_ce(logits, batch["captions"], batch["lengths"])


def follow(weights0: Dict[str, torch.Tensor], cfg: Dict, batches: List[Dict],
           encoder_on: bool, operand=identity, rows: Optional[int] = None) -> Dict:
    """Run the train step over `batches` (dicts of uint8 NHWC images,
    captions, lengths and the crop/flip draws tops, lefts, flips, all on one
    device) from a copy of weights0, in float32 with TF32 off. rows: only
    each batch's first `rows` rows (a fault that drops the rest).

    Returns {"losses": [float], "grad1": {name: the first step's gradient
    as the optimizer gets it}, "weights": {name: after the last step}}, the
    weights including every BN's running statistics."""
    w = {n: t.detach().clone() for n, t in weights0.items()}
    g = groups(w, cfg, encoder_on)
    trainable = g["decoder"] + g["encoder"]
    for n in trainable:
        w[n].requires_grad_(True)
    start = cfg["opt_fine_tune_cnn_start_layer"] if encoder_on else len(CHILDREN)
    opts = {"decoder": Adam({n: w[n] for n in g["decoder"]}, cfg["opt_rnn_adam_learning_rate"],
                            (cfg["opt_rnn_adam_alpha"], cfg["opt_rnn_adam_beta"])),
            "encoder": Adam({n: w[n] for n in g["encoder"]}, cfg["opt_cnn_adam_learning_rate"],
                            (cfg["opt_cnn_adam_alpha"], cfg["opt_cnn_adam_beta"]))}
    ref = Reference(w, cfg, operand)
    losses, grad1 = [], None
    with tf32_off():
        for batch in batches:
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            moments: List = []
            loss = _forward_loss(ref, cfg, batch, start, moments)
            grads = dict(zip(trainable, torch.autograd.grad(loss, [w[n] for n in trainable])))
            with torch.no_grad():
                total = torch.sqrt(sum((grads[n] ** 2).sum() for n in LSTM_NAMES))
                coef = torch.clamp(cfg["train_lstm_maxnormal"] / (total + 1e-6), max=1.0)
                for n in LSTM_NAMES:
                    grads[n] = grads[n] * coef
                if grad1 is None:
                    grad1 = {n: t.detach().clone() for n, t in grads.items()}
                opts["decoder"].step(grads)
                if encoder_on:
                    opts["encoder"].step(grads)
                for name, mean, var in moments:
                    rm, rv = w[f"{TRUNK}.{name}.running_mean"], w[f"{TRUNK}.{name}.running_var"]
                    rm.mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                    rv.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            losses.append(float(loss.detach()))
            del loss, grads, moments
    return {"losses": losses, "grad1": grad1,
            "weights": {n: t.detach() for n, t in w.items()}}
