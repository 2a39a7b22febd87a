"""The training step: loss, gradients, clipping, dual-optimizer updates
(counterpart of adaptive_tpu/training/step.py).

Reference parity:
* loss: CrossEntropyLoss over pack_padded_sequence'd scores vs. shifted
  targets (train.py:101-102,208) == masked mean CE over positions
  t < length-1 with target captions[:, t+1];
* grad clip: clip_grad_norm_(decoder.LSTM params, max_norm=5) — global norm
  over the 4 LSTM tensors only, scale max/(norm+1e-6) (train.py:213-214);
* update order: decoder step, then the encoder step reusing the SAME
  gradients when fine-tuning is on (train.py:108-115);
* augmentation (random crop + flip + normalize) runs on the device inside
  the step (train.py:29-34).

The weights, BN statistics and optimizer state change in place. The step
makes no host sync: the loss stays a device tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from adaptive_tpu_torch.models.resnet import CHILD_NAMES
from adaptive_tpu_torch.ops import preprocess
from adaptive_tpu_torch.training.optim import DualOptimizer

LSTM_NAMES = ("decoder.LSTM.weight_ih_l0", "decoder.LSTM.weight_hh_l0",
              "decoder.LSTM.bias_ih_l0", "decoder.LSTM.bias_hh_l0")


def masked_ce_sum(scores: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor):
    """(sum of NLL over valid positions, number of valid positions).

    scores [B,T,V] from teacher forcing over captions [B,T]; target at step t
    is captions[:, t+1]; positions t < length-1 are valid (train.py:101-102).
    Split from the mean so that gradient accumulation combines microbatches
    exactly."""
    T = scores.shape[1]
    logp = torch.log_softmax(scores[:, : T - 1].float(), dim=-1)
    targets = captions[:, 1:].long()
    mask = torch.arange(T - 1, device=scores.device)[None, :] < (lengths[:, None] - 1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def masked_ce_loss(scores: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor):
    """Mean cross-entropy over valid next-token positions (see masked_ce_sum)."""
    s, n = masked_ce_sum(scores, captions, lengths)
    return s / torch.clamp(n, min=1)


def clip_lstm_grads(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """torch clip_grad_norm_ over the decoder LSTM's gradients only
    (train.py:213-214): scales them in place, returns their global norm."""
    total = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total


class StepOutput(NamedTuple):
    """What the step returns; the weights changed in place."""

    loss: torch.Tensor
    lstm_grad_norm: torch.Tensor


def make_train_step(model, dual: DualOptimizer, cf):
    """Returns train_step(net, batch, gen, encoder_on=False) -> StepOutput.

    batch: images uint8 NHWC [B,S,S,3], captions int [B,T], lengths int [B]
    (numpy or tensors; moved to model.device). gen: the torch.Generator of
    the crop/flip draws and the dropout masks. encoder_on: the encoder group
    is stepped too; otherwise the trunk runs without autograd (no conv
    backward; its BN statistics still update, as JAX's forward(train=True)
    updates them), as JAX's stop_gradient at the ResNet params has it.
    With encoder_on, the children before opt_fine_tune_cnn_start_layer run
    without autograd too: their gradients feed no update."""
    crop = cf.train_crop_size
    max_norm = cf.train_lstm_maxnormal
    accum = cf.train_grad_accum_steps
    start_layer = cf.opt_fine_tune_cnn_start_layer

    def sum_loss(net, batch, gen, encoder_on):
        images = preprocess.train_preprocess(gen, batch["images"], crop, model.compute_dtype)
        scores, _ = model.forward(net, images, batch["captions"], train=True, gen=gen,
                                  grad_from=start_layer if encoder_on else len(CHILD_NAMES))
        return masked_ce_sum(scores, batch["captions"], batch["lengths"])

    def train_step(net, batch, gen: torch.Generator, encoder_on: bool = False) -> StepOutput:
        batch = {k: torch.as_tensor(batch[k], device=model.device)
                 for k in ("images", "captions", "lengths")}
        params = dict(net.named_parameters())
        for p in params.values():
            p.grad = None
        # sum-of-NLL gradients accumulate in .grad over the microbatches and
        # are divided once by the valid count: the full batch's gradient
        # (BN statistics update once a microbatch, as in JAX)
        B = batch["images"].shape[0]
        m = B // accum
        s_nll, s_n = 0.0, 0
        for k in range(accum):
            mb = {key: v[k * m:(k + 1) * m] for key, v in batch.items()}
            sum_nll, n = sum_loss(net, mb, gen, encoder_on)
            sum_nll.backward()
            s_nll, s_n = s_nll + sum_nll.detach(), s_n + n
        n = torch.clamp(s_n, min=1).float()
        for p in params.values():
            if p.grad is not None:
                p.grad.div_(n)
        lstm_norm = clip_lstm_grads([params[k].grad for k in LSTM_NAMES], max_norm)
        dual.step("decoder")
        if encoder_on:
            dual.step("encoder")
        return StepOutput(s_nll / n, lstm_norm)

    return train_step


def make_eval_loss_step(model, cf):
    """Masked-CE eval loss on a batch of preprocessed images, eval-mode BN."""

    @torch.no_grad()
    def eval_loss(net, images, captions, lengths):
        scores, _ = model.forward(net, images, captions, train=False)
        return masked_ce_loss(scores, captions, lengths)

    return eval_loss
