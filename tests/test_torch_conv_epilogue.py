"""The folded encoder's conv epilogue (ops/conv_epilogue.py) on the CPU:
its twin against the separate passes it replaces (the conv's bias add_,
the downsample's, z + sc, relu) in each of its three modes, the operator
the export records, and the float encoder's traversal calling it once a
conv but the downsamples. The kernel against the twin on the card is in
tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

from adaptive_tpu_torch import Config
from adaptive_tpu_torch.models import build_model
from adaptive_tpu_torch.models import infer
from adaptive_tpu_torch.ops import conv_epilogue as ce
from tests.torch_port_util import port_threads  # noqa: F401

MODES = ("mid", "identity", "downsample")


def _operands(mode, dtype, rows=300, C=64, seed=0):
    """acc, bias, residual, residual_bias of one mode: N(0, 1) values, so
    that the sums cancel in places and relu clips about half."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    acc, bias = r(2, rows // 2, C), r(C)
    residual = None if mode == "mid" else r(2, rows // 2, C)
    return acc, bias, residual, r(C) if mode == "downsample" else None


def _separate_passes(acc, bias, residual, residual_bias):
    """The float encoder's epilogue before the kernel, in acc's dtype."""
    z = acc.clone().add_(bias)
    if residual is not None:
        sc = residual if residual_bias is None else residual.clone().add_(residual_bias)
        z = z + sc
    return torch.relu(z)


def _bf16_ulp(v):
    """The spacing of bf16 values (8 significant bits) at |v|."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_the_separate_passes(mode, dtype):
    """fp32: equal to the separate passes (the same adds in the same
    association). bf16: the twin rounds once where they round after each
    add: bias + relu is equal, a residual sum within one bf16 ulp of the
    larger of its two summands, or of the result where that is larger."""
    acc, bias, residual, rb = _operands(mode, dtype)
    got = ce.folded_epilogue_plain(acc, bias, residual, rb)
    want = _separate_passes(acc, bias, residual, rb)
    assert got.dtype == dtype and got.shape == acc.shape
    if dtype == torch.float32 or mode == "mid":
        assert torch.equal(got, want)
        return
    t1 = acc.float() + bias.float()
    sc = residual.float() + (0 if rb is None else rb.float())
    top = torch.maximum(torch.maximum(t1.abs(), sc.abs()), want.float().abs())
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_ulp(top)).all()), float((err / _bf16_ulp(top)).max())
    assert not torch.equal(got, want)  # the intermediate roundings did go


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_writes_into_acc_and_the_operator_agrees(mode):
    """On a CPU tensor the wrapper writes the twin's result into acc and
    returns it; the operator adaptive_tpu_torch::folded_epilogue (what an
    export records) gives the same."""
    acc, bias, residual, rb = _operands(mode, torch.bfloat16, seed=1)
    want = ce.folded_epilogue_plain(acc, bias, residual, rb)
    via_op = ce._epilogue_op.op(acc.clone(), bias, residual, rb)
    got = ce.folded_epilogue(acc, bias, residual, rb)
    assert got is acc and torch.equal(acc, want) and torch.equal(via_op, want)


def test_wrapper_refuses_mismatched_operands():
    acc, bias, residual, rb = _operands("downsample", torch.float32)
    with pytest.raises(ValueError, match="bias has shape"):
        ce.folded_epilogue(acc, bias[:8], residual, rb)
    with pytest.raises(ValueError, match="residual has shape"):
        ce.folded_epilogue(acc, bias, residual[:1], rb)
    with pytest.raises(ValueError, match="needs a residual"):
        ce.folded_epilogue(acc, bias, None, rb)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ce.folded_epilogue(acc.to("meta"), bias.to("meta"))


def _tiny(arch):
    cf = Config(encoder_backbone=arch, train_crop_size=32, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16,
                adaptive_lstm_hidden_size=32, decode_max_len=4)
    model = build_model(cf, device="cpu")
    net = model.init(0)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32))
    return model, net, x


@pytest.mark.parametrize("arch,calls", [("resnet18", {"mid": 9, "identity": 5, "downsample": 3}),
                                        ("resnet50", {"mid": 33, "identity": 12, "downsample": 4})])
def test_encode_calls_the_epilogue_once_a_conv_but_the_downsamples(monkeypatch, arch, calls):
    """An fp32 encode on the CPU calls the wrapper 1 + 2 x 8 = 17 times in
    resnet18 and 1 + 3 x 16 = 49 in resnet50: the stem and every conv of a
    block but its last with no residual, the last with the block input or
    the downsample's raw output and bias. Its features equal the traversal
    with biased convs and the separate passes within fp32's rounding (a conv
    that adds its bias inside sums in another order)."""
    model, net, x = _tiny(arch)
    seen = {m: 0 for m in MODES}
    wrapper = ce.folded_epilogue

    def counting(acc, bias, residual=None, residual_bias=None):
        seen[MODES[(residual is not None) + (residual_bias is not None)]] += 1
        return wrapper(acc, bias, residual, residual_bias)

    monkeypatch.setattr(ce, "folded_epilogue", counting)
    prepared = model.prepare_inference(net)
    with torch.no_grad():
        V = model.encode_inference(prepared, x)[0]
        assert seen == calls
        got = infer.resnet_apply_folded(prepared["encoder"]["resnet"], x, arch)
        want = infer._folded_forward(prepared["encoder"]["resnet"], x, arch, infer._plain_conv)
    assert sum(seen.values()) == 2 * sum(calls.values())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(V).all()


def test_export_records_the_operator():
    """torch.export of the float trunk holds 17 calls of the operator
    (resnet18), and the exported program, which writes each into the conv's
    output through the dispatcher, gives the eager trunk's features."""
    _, net, x = _tiny("resnet18")
    folded = infer.fold_resnet(net.encoder.resnet_conv)

    class Trunk(torch.nn.Module):
        def forward(self, images):
            return infer.resnet_apply_folded(folded, images, "resnet18")

    with torch.no_grad():
        exported = torch.export.export(Trunk(), (x,), strict=False)
        got = exported.module()(x)
        want = Trunk()(x)
    calls = [n for n in exported.graph.nodes
             if n.op == "call_function" and "folded_epilogue" in str(n.target)]
    assert len(calls) == 17
    assert torch.equal(got, want)
