"""ResNet backbone (v1.5, torchvision-compatible) without torchvision
(counterpart of adaptive_tpu/models/resnet.py).

Parameter names follow the reference's ``resnet_conv`` Sequential of
torchvision's children (0=conv1, 1=bn1, 4..7=layer1..4; inside a block
conv{1..3}, bn{1..3}, downsample.{0,1}), so a reference state_dict loads with
``load_state_dict``. Public tensors are NHWC as in the JAX package; inside,
the convolutions run on NCHW views in the channels_last memory format, which
is what a permuted NHWC tensor already is.

Train and eval mode are an explicit ``train`` argument, as in the JAX
package (``net.training`` is never read: the train step and the eval decoder
share one net). Convolutions run in the input's dtype (the fp32 kernels cast
to it). Train-mode BN is ``F.batch_norm(training=True)``: batch statistics in
fp32, the output in the input's dtype, the running statistics updated in
place with momentum 0.1 and the unbiased variance, as the JAX package's
``_bn`` does; torch's backward has the two-reduction form of JAX's
``_bn_train`` custom_vjp.

With ``bn_group`` (the data-parallel train step's data group) train-mode
BN takes its moments over the group's ranks, as JAX's over a data-sharded
batch: the shifted sums of ``adaptive_tpu/models/resnet.py::
_bn_batch_moments`` and the count are all-reduced, the running statistics
update from the global moments, and the backward all-reduces its two sums
(``_SyncBatchNorm``; ``nn.SyncBatchNorm`` refuses CPU tensors).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptive_tpu_torch.ops import quant_conv

# torchvision resnet depth -> (block type, stage sizes)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}

BN_MOMENTUM = 0.1  # torch BatchNorm2d default
# torchvision child order of the truncated backbone (model_factory.py:35
# slices children()[start_layer:])
CHILD_NAMES = ["conv1", "bn1", "relu", "maxpool", "layer1", "layer2", "layer3", "layer4"]


def feature_channels(arch: str) -> int:
    return 2048 if RESNET_SPECS[arch][0] == "bottleneck" else 512


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


def _conv_apply(conv: nn.Conv2d, x, group=None):
    """conv's forward in x's dtype. Where autograd records and the
    conv-backward experiment is on (ops/quant_conv.py, JAX's
    adaptive_tpu/models/resnet.py:118-126), through quant_conv.conv_nchw
    with the data group that shares its int8 scales; in mode 'none', and
    without autograd (calibrate_bn_'s forward hooks), the module call."""
    if quant_conv.get_conv_bwd_quant() != "none" and torch.is_grad_enabled():
        return quant_conv.conv_nchw(x, conv.weight, conv.stride[0], group)
    if conv.weight.dtype == x.dtype:
        return conv(x)  # the module call runs its forward hooks (calibrate_bn_)
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


_DIMS = (0, 2, 3)


class _SyncBatchNorm(torch.autograd.Function):
    """JAX's _bn_train (shifted two-moment forward, two-reduction backward)
    with its sums all-reduced over a process group. Returns (y, mean, biased
    var, count); the weight and bias gradients are this rank's share, which
    the step's gradient all-reduce sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, shift, eps, group):
        import torch.distributed as dist

        C = x.shape[1]
        xs = x.float() - shift[None, :, None, None]
        count = torch.full((1,), x.numel() // C, dtype=torch.float32, device=x.device)
        sums = torch.cat([xs.sum(_DIMS), (xs * xs).sum(_DIMS), count])
        dist.all_reduce(sums, group=group)
        n = sums[2 * C]
        dmean = sums[:C] / n
        mean = dmean + shift
        var = torch.clamp(sums[C:2 * C] / n - dmean * dmean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = ((x.float() - mean[None, :, None, None]) * (inv * weight)[None, :, None, None]
             + bias[None, :, None, None])
        ctx.save_for_backward(x, mean, inv, weight, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        import torch.distributed as dist

        x, mean, inv, weight, n = ctx.saved_tensors
        C = x.shape[1]
        dy = dy.float()
        xhat = (x.float() - mean[None, :, None, None]) * inv[None, :, None, None]
        sum_dy = dy.sum(_DIMS)
        sum_dy_xhat = (dy * xhat).sum(_DIMS)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        dx = (weight * inv)[None, :, None, None] * (
            dy - (sums[:C] / n)[None, :, None, None]
            - xhat * (sums[C:] / n)[None, :, None, None])
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None, None


def _sync_bn(x, bn: nn.BatchNorm2d, update_stats: bool, group):
    y, mean, var, n = _SyncBatchNorm.apply(
        x, bn.weight, bn.bias, bn.running_mean.detach().float(), bn.eps, group)
    if update_stats:
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1, min=1.0)
            bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
    return y


def _bn(x, bn: nn.BatchNorm2d, train: bool, update_stats: bool = True, group=None):
    """update_stats=False in train mode normalises with the batch statistics
    and leaves the running ones as they are. group: train mode's moments
    over a process group's ranks (_SyncBatchNorm)."""
    if train and group is not None:
        return _sync_bn(x, bn, update_stats, group)
    keep = train and not update_stats
    return F.batch_norm(x, None if keep else bn.running_mean, None if keep else bn.running_var,
                        bn.weight, bn.bias, train, BN_MOMENTUM, bn.eps)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, cout, stride, has_down):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, width, 1), nn.BatchNorm2d(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride), nn.BatchNorm2d(width)
        self.conv3, self.bn3 = _conv(width, cout, 1), nn.BatchNorm2d(cout)
        self.downsample = (
            nn.Sequential(_conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))
            if has_down else None
        )

    def forward(self, x, train: bool = False, update_stats: bool = True, bn_group=None):
        u, g = update_stats, bn_group
        y = F.relu(_bn(_conv_apply(self.conv1, x, g), self.bn1, train, u, g))
        y = F.relu(_bn(_conv_apply(self.conv2, y, g), self.bn2, train, u, g))
        y = _bn(_conv_apply(self.conv3, y, g), self.bn3, train, u, g)
        sc = x if self.downsample is None else _bn(
            _conv_apply(self.downsample[0], x, g), self.downsample[1], train, u, g)
        return F.relu(y + sc)


class BasicBlock(nn.Module):
    def __init__(self, cin, width, cout, stride, has_down):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, width, 3, stride), nn.BatchNorm2d(width)
        self.conv2, self.bn2 = _conv(width, width, 3), nn.BatchNorm2d(width)
        self.downsample = (
            nn.Sequential(_conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))
            if has_down else None
        )

    def forward(self, x, train: bool = False, update_stats: bool = True, bn_group=None):
        u, g = update_stats, bn_group
        y = F.relu(_bn(_conv_apply(self.conv1, x, g), self.bn1, train, u, g))
        y = _bn(_conv_apply(self.conv2, y, g), self.bn2, train, u, g)
        sc = x if self.downsample is None else _bn(
            _conv_apply(self.downsample[0], x, g), self.downsample[1], train, u, g)
        return F.relu(y + sc)


class ResNet(nn.Sequential):
    """torchvision ResNet minus avgpool/fc, as the reference wraps it:
    nn.Sequential([conv1, bn1, relu, maxpool, layer1..4]), so its state_dict
    keys are the reference's ``encoder.resnet_conv.<i>...`` below the encoder.
    forward: NHWC float -> NHWC [B, H/32, W/32, C]."""

    def __init__(self, arch: str = "resnet152"):
        block_type, stages = RESNET_SPECS[arch]
        block = Bottleneck if block_type == "bottleneck" else BasicBlock
        expansion = 4 if block_type == "bottleneck" else 1
        layers = []
        cin = 64
        for li, n_blocks in enumerate(stages):
            width = 64 * 2 ** li
            cout = width * expansion
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                has_down = bi == 0 and (stride != 1 or cin != cout)
                blocks.append(block(cin, width, cout, stride, has_down))
                cin = cout
            layers.append(nn.Sequential(*blocks))
        super().__init__(_conv(3, 64, 7, 2), nn.BatchNorm2d(64), nn.ReLU(),
                         nn.MaxPool2d(3, 2, 1), *layers)
        self.arch = arch

    def layers(self):
        """(layer1, ..., layer4)."""
        return tuple(self[i] for i in range(4, len(self)))

    def forward(self, x, train: bool = False, grad_from: int = 0, update_stats: bool = True,
                bn_group=None):
        """grad_from: children before CHILD_NAMES[grad_from] run without
        autograd (a frozen prefix keeps no activations and runs no backward;
        len(CHILD_NAMES) freezes the whole trunk). Their BN statistics still
        update in train mode. update_stats=False: train-mode BN on the batch
        statistics without updating the running ones (the L-BFGS step's
        re-evaluations of a batch, training/lbfgs.py). bn_group: train-mode
        BN's moments over the process group's ranks (the data group)."""
        y = x.permute(0, 3, 1, 2)
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and grad_from <= 0):
            y = _conv_apply(self[0], y, bn_group)
        with torch.set_grad_enabled(grad and grad_from <= 1):
            y = _bn(y, self[1], train, update_stats, bn_group)
        with torch.set_grad_enabled(grad and grad_from <= 2):  # relu, maxpool: no params
            y = self[3](F.relu(y))
        for i, layer in enumerate(self.layers(), start=4):
            with torch.set_grad_enabled(grad and grad_from <= i):
                for blk in layer:
                    y = blk(y, train, update_stats, bn_group)
        return y.permute(0, 2, 3, 1)

    def bn_buffers(self):
        """Every BN's running mean and variance."""
        return [b for m in self.modules() if isinstance(m, nn.BatchNorm2d)
                for b in (m.running_mean, m.running_var)]


def _conv_bn_pairs(net: ResNet):
    yield net[0], net[1]
    for layer in net.layers():
        for blk in layer:
            for i in (1, 2, 3):
                if hasattr(blk, f"conv{i}"):
                    yield getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}")
            if blk.downsample is not None:
                yield blk.downsample[0], blk.downsample[1]


def _residual_bns(net: ResNet):
    """The last BN of every block's residual branch (bn3 of a bottleneck,
    bn2 of a basic block)."""
    for layer in net.layers():
        for blk in layer:
            yield blk.bn3 if isinstance(blk, Bottleneck) else blk.bn2


@torch.no_grad()
def calibrate_bn_(net: ResNet, x: torch.Tensor, residual_gain: float = 0.2) -> None:
    """Set every BN's running statistics to those of its input on the batch
    x (NHWC float), in one forward pass: each conv's output sets its BN's
    mean and variance before the BN reads them. With random conv weights the
    identity statistics of a fresh init let activations grow by orders of
    magnitude with depth; calibrated statistics keep them at the scale a
    trained network's BN gives.

    Then the last BN of each residual branch gets scale residual_gain, as
    the small final scales of trained ResNets have it. With every branch at
    unit scale the calibrated random ResNet-152 is chaotic: it grows
    rounding-level differences at its input (as between two devices) into
    visibly different features, so fp32 captions computed on two devices
    part ways. With branches at 0.2 it shrinks such differences instead."""
    def hook(bn):
        def set_stats(_conv, _inp, out):
            o = out.float()
            bn.running_mean.copy_(o.mean(dim=(0, 2, 3)))
            bn.running_var.copy_(o.var(dim=(0, 2, 3), unbiased=False))
        return set_stats

    handles = [conv.register_forward_hook(hook(bn)) for conv, bn in _conv_bn_pairs(net)]
    try:
        net(x)
    finally:
        for h in handles:
            h.remove()
    for bn in _residual_bns(net):
        bn.weight.fill_(residual_gain)


def finetune_mask(start_layer: int):
    """{child name: trainable} over CHILD_NAMES: True for the children
    [start_layer:] that hold parameters (model_factory.py:27-39); relu and
    maxpool have none."""
    return {name: i >= start_layer and name not in ("relu", "maxpool")
            for i, name in enumerate(CHILD_NAMES)}


@torch.no_grad()
def init_resnet_(net: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's init in place: convs kaiming normal (fan_out, relu),
    BN scale 1, bias 0, running mean 0, running var 1."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            cout, _, kh, kw = m.weight.shape
            m.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)), generator=gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
