"""The bf16 encoder's stride-1 1x1 convolution with its epilogue
(ops/conv1x1.py) on the CPU: its twin against F.conv2d followed by the conv
epilogue's twin in each of its three modes, the float traversal's routing
(which convs take it, in which dtype), the fp32 traversal and calibration
left as they were, and the operator an export records. The kernel against
the twin on the card is in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaptive_tpu_torch import Config
from adaptive_tpu_torch.models import build_model
from adaptive_tpu_torch.models import infer
from adaptive_tpu_torch.ops import conv1x1 as cx
from adaptive_tpu_torch.ops import conv_epilogue as ce
from tests.torch_port_util import port_threads  # noqa: F401

MODES = ("mid", "identity", "downsample")


def _operands(mode, dtype, M, K, N, seed=0):
    """x [2, M / 2, K] (NHWC rows of two images), w [N, K, 1, 1] N(0, 1/K),
    bias, residual, residual_bias of one mode."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dtype)  # noqa: E731
    x, w, bias = r(2, M // 2, K), r(N, K, 1, 1, scale=K ** -0.5), r(N)
    residual = None if mode == "mid" else r(2, M // 2, N)
    return x, w, bias, residual, r(N) if mode == "downsample" else None


def _conv_then_epilogue(x, w, bias, residual, residual_bias):
    """The path the op replaces: F.conv2d (1x1, no bias) in x's dtype on the
    NHWC rows as one image row, then folded_epilogue_plain."""
    z = F.conv2d(x.permute(0, 2, 1)[..., None], w).squeeze(-1).permute(0, 2, 1)
    return ce.folded_epilogue_plain(z, bias, residual, residual_bias)


def _bf16_ulp(v):
    """The spacing of bf16 values (8 significant bits) at |v|."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N", [(2 * 67, 64, 64), (2 * 129, 256, 1024), (2 * 33, 1024, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_conv_then_epilogue(mode, M, K, N, dtype):
    """In fp32 the twin is F.conv2d + the epilogue's twin up to the order of
    the fp32 sums (atol 1e-5). In bf16 the path it replaces rounds the
    conv's output to bf16 before the epilogue; the twin does not, so the
    two stay within one bf16 rounding of that output and one of the result:
    |d| <= ulp(z) + ulp(y), z the conv's output, at ragged row counts."""
    x, w, bias, res, rb = _operands(mode, dtype, M, K, N, seed=M + K)
    got = cx.conv1x1_epilogue_plain(x, w, bias, res, rb)
    want = _conv_then_epilogue(x, w, bias, res, rb)
    assert got.dtype == dtype and got.shape == (2, M // 2, N)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        return
    z = (x.float().reshape(-1, K) @ w.float().reshape(N, K).T).reshape(got.shape)
    d = (got.float() - want.float()).abs()
    assert (d <= _bf16_ulp(z) + _bf16_ulp(want.float()) + 1e-30).all()
    assert (d > 0).any()  # the intermediate rounding that goes is seen


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_on_the_cpu_runs_the_twin_and_the_operator_agrees(mode):
    """On CPU tensors the wrapper is the twin, w given as [N, K, 1, 1] or
    [N, K]; the operator adaptive_tpu_torch::conv1x1_epilogue (what an
    export records) gives the same bits."""
    x, w, bias, res, rb = _operands(mode, torch.bfloat16, 2 * 40, 128, 256, seed=7)
    want = cx.conv1x1_epilogue_plain(x, w, bias, res, rb)
    assert torch.equal(cx.conv1x1_epilogue(x, w, bias, res, rb), want)
    assert torch.equal(cx.conv1x1_epilogue(x, w[:, :, 0, 0], bias, res, rb), want)
    assert torch.equal(cx._conv1x1_op.op(x, w, bias, res, rb), want)


def test_wrapper_refuses_mismatched_operands():
    x, w, bias, res, rb = _operands("downsample", torch.bfloat16, 2 * 8, 64, 128)
    with pytest.raises(ValueError, match="bias has shape"):
        cx.conv1x1_epilogue(x, w, bias[:64], res, rb)
    with pytest.raises(ValueError, match="residual has shape"):
        cx.conv1x1_epilogue(x, w, bias, res[:1], rb)
    with pytest.raises(ValueError, match="needs a residual"):
        cx.conv1x1_epilogue(x, w, bias, None, rb)
    with pytest.raises(ValueError, match="w has shape"):
        cx.conv1x1_epilogue(x, w.reshape(128, 16, 2, 2), bias)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        cx.conv1x1_epilogue(x.to("meta"), w.to("meta"), bias.to("meta"))


def _tiny(arch, dtype="float32"):
    cf = Config(encoder_backbone=arch, train_crop_size=32, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16,
                adaptive_lstm_hidden_size=32, decode_max_len=4, compute_dtype=dtype)
    model = build_model(cf, device="cpu")
    net = model.init(0)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32))
    return model, net, x


def _counting(monkeypatch):
    """Counts the calls of both ops by the convs' shapes, and records
    whether each conv1x1_epilogue call had contiguous operands."""
    seen = {"conv1x1": [], "epilogue": 0}
    op9, op7 = cx.conv1x1_epilogue, ce.folded_epilogue

    def conv1x1(x, w, bias, residual=None, residual_bias=None):
        mode = MODES[(residual is not None) + (residual_bias is not None)]
        ops = [t for t in (x, w, bias, residual, residual_bias) if t is not None]
        seen["conv1x1"].append((x.shape[-1], w.shape[0], mode, all(t.is_contiguous() for t in ops)))
        return op9(x, w, bias, residual, residual_bias)

    def epilogue(*args):
        seen["epilogue"] += 1
        return op7(*args)

    monkeypatch.setattr(cx, "conv1x1_epilogue", conv1x1)
    monkeypatch.setattr(ce, "folded_epilogue", epilogue)
    return seen


def test_bf16_traversal_routes_each_conv1_and_conv3(monkeypatch):
    """A bf16 encode of resnet50 calls the op once for each bottleneck's
    conv1 (bias + relu) and conv3 (+ the block input, or + the downsample's
    raw output and its bias): 16 + 16, never for a downsample, a conv2 or
    the stem, which keep the epilogue pass (1 + 16), all on contiguous
    operands. The features are those of the same traversal with the conv
    and the epilogue apart, up to the conv outputs' rounding to bf16."""
    model, net, x = _tiny("resnet50", "bfloat16")
    seen = _counting(monkeypatch)
    prepared = model.prepare_inference(net)
    folded = prepared["encoder"]["resnet"]
    xb = x.bfloat16()

    def separate(name, xx, p, stride, pad, residual=None, residual_p=None):
        return infer._fused_epilogue(infer._bias_free_conv(name, xx, p, stride, pad), p,
                                     residual, residual_p)

    with torch.no_grad():
        got = infer.resnet_apply_folded(folded, xb, "resnet50")
        calls = list(seen["conv1x1"])
        want = infer._folded_forward(folded, xb, "resnet50", infer._bias_free_conv, separate)
    modes = [m for _, _, m, _ in calls]
    assert (modes.count("mid"), modes.count("identity"), modes.count("downsample")) == (16, 12, 4)
    assert all(contiguous for *_, contiguous in calls)
    assert seen["epilogue"] == 17 + 49  # the encode's 17, then the separate traversal's 49
    # conv1 of each layer's first block reads the previous width; conv3 widens by 4
    assert [(k, n) for k, n, m, _ in calls[:2]] == [(64, 64), (64, 256)]
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert 0 < rel < 2e-2


def _walk(folded, x, arch, conv, epilogue):
    """The float traversal as it was written before the op: torchvision's
    order, each block's last conv before its downsample, then epilogue(z,
    params, residual, residual_params)."""
    block_type, stages = infer.RESNET_SPECS[arch]
    y = infer._max_pool(epilogue(conv("conv1", x, folded["conv1"], 2, ((3, 3), (3, 3))),
                                 folded["conv1"], None, None))
    for li, n in enumerate(stages):
        for bi in range(n):
            p, nm = folded[f"layer{li + 1}"][bi], f"layer{li + 1}.{bi}"
            stride = 2 if (li > 0 and bi == 0) else 1
            if block_type == "bottleneck":
                z = epilogue(conv(f"{nm}.conv1", y, p["conv1"], 1, None), p["conv1"], None, None)
                z = epilogue(conv(f"{nm}.conv2", z, p["conv2"], stride, None), p["conv2"], None,
                             None)
                z, last = conv(f"{nm}.conv3", z, p["conv3"], 1, None), p["conv3"]
            else:
                z = epilogue(conv(f"{nm}.conv1", y, p["conv1"], stride, None), p["conv1"], None,
                             None)
                z, last = conv(f"{nm}.conv2", z, p["conv2"], 1, None), p["conv2"]
            if "downsample" in p:
                y = epilogue(z, last, conv(f"{nm}.downsample", y, p["downsample"], stride, None),
                             p["downsample"])
            else:
                y = epilogue(z, last, y, None)
    return y


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_fp32_traversal_is_unchanged(monkeypatch, arch):
    """An fp32 encode never calls the op: every conv is the bias-free conv
    then the epilogue pass (17 / 49 calls), bit for bit the traversal as it
    was written before (the conv, cuDNN's route on the card, then
    folded_epilogue). resnet18 (basic blocks) has no 1x1 conv with an
    epilogue, so its bf16 encode does not call the op either."""
    model, net, x = _tiny(arch)
    seen = _counting(monkeypatch)
    folded = infer.fold_resnet(net.encoder.resnet_conv)

    def epilogue(z, p, residual, residual_p):
        rb = None if residual_p is None else residual_p["bias"]
        return ce.folded_epilogue(z, p["bias"], residual, rb)

    with torch.no_grad():
        got = infer.resnet_apply_folded(folded, x, arch)
        assert seen["conv1x1"] == [] and seen["epilogue"] == {"resnet18": 17, "resnet50": 49}[arch]
        want = _walk(folded, x, arch, infer._bias_free_conv, epilogue)
        if arch == "resnet18":
            infer.resnet_apply_folded(infer.cast_floating(folded, torch.bfloat16), x.bfloat16(),
                                      arch)
            assert seen["conv1x1"] == []
    assert torch.equal(got, want)


def test_calibration_scales_and_dynamic_int8_are_unchanged():
    """calibrate_int8 gives the scales of the traversal as it was written
    before (the downsample after the block's last conv; the float path now
    runs it first), and the dynamic int8 forward equals that traversal's."""
    model, net, x = _tiny("resnet50")
    enc = net.encoder
    scales = infer.calibrate_int8(enc, x, "resnet50")
    folded = infer.fold_resnet(enc.resnet_conv)
    amax = {}

    def conv(name, xx, p, stride, pad):
        amax[name] = float(xx.float().abs().max())
        y = infer._plain_conv(name, xx, p, stride, pad)
        if name.endswith("downsample"):
            amax[name + "_out"] = float(y.float().abs().max())
        return y

    def relu_epilogue(z, p, residual, residual_p):
        return F.relu(z if residual is None else z + residual)

    def conv_i8(name, xx, p, stride, pad):
        return infer._conv_i8(xx, p, stride, x.dtype, None, pad)

    with torch.no_grad():
        _walk(folded, x, "resnet50", conv, relu_epilogue)
        dyn = infer.resnet_apply_folded_int8(folded, x, "resnet50")
        again = _walk(folded, x, "resnet50", conv_i8, relu_epilogue)
    assert scales == {k: max(v, 1e-8) / 127.0 for k, v in amax.items()}
    assert torch.equal(dyn, again)


def test_export_records_the_operator():
    """torch.export of the bf16 resnet50 trunk holds 32 calls of the
    operator and 17 of the epilogue's, and the exported program gives the
    eager trunk's features."""
    _, net, x = _tiny("resnet50")
    folded = infer.cast_floating(infer.fold_resnet(net.encoder.resnet_conv), torch.bfloat16)
    xb = x.bfloat16()

    class Trunk(torch.nn.Module):
        def forward(self, images):
            return infer.resnet_apply_folded(folded, images, "resnet50")

    with torch.no_grad():
        exported = torch.export.export(Trunk(), (xb,), strict=False)
        got = exported.module()(xb)
        want = Trunk()(xb)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("conv1x1_epilogue" in t for t in targets) == 32
    assert sum("folded_epilogue" in t for t in targets) == 17
    assert torch.equal(got, want)
