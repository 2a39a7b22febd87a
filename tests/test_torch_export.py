"""The PyTorch port's decoder export (adaptive_tpu_torch/export.py) on the
CPU: a torch.export artifact of the greedy and beam pipelines, saved and
loaded, decodes as the in-process decoder does and as the JAX package's
exported decoder on the same weights; the kernels are operators in the
program; a wrong batch raises; the exported early-exit decoder gives the
eager early-exit decoder's outputs."""

import numpy as np
import pytest
import torch

from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
from adaptive_tpu_torch.export import export_decoder, load_decoder
from adaptive_tpu_torch.models.factory import build_model
from tests.torch_port_util import port_cf


@pytest.fixture(scope="module")
def setup(tiny_cf):
    """A tiny fp32 model (the port's init, BN calibrated on the images so
    that captions differ from image to image) and 4 images."""
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    jcf = tiny_cf.replace(vocab_length=32, eval_batch_size=4, decode_max_len=5)
    cf = port_cf(jcf)
    imgs = np.random.default_rng(1).integers(0, 255, (4, 72, 72, 3), dtype=np.uint8)
    model = build_model(cf, device="cpu")
    net = model.init(0)
    calibrate_bn_(net.encoder.resnet_conv, eval_preprocess(torch.as_tensor(imgs), 64))
    return jcf, cf, model, net, imgs


def _ops(decode):
    return {str(n.target) for n in decode.program.graph.nodes
            if n.op == "call_function" and "adaptive_tpu_torch" in str(n.target)}


@pytest.mark.parametrize("beam", [1, 3])
def test_export_roundtrip(setup, tmp_path, beam):
    """ids equal (==) to the in-process decoder's, beta and attention within
    1e-6; the program calls the kernels' operators."""
    _, cf, model, net, imgs = setup
    cf = cf.replace(beam_size=beam)
    decode = load_decoder(export_decoder(model, cf, net, str(tmp_path / "dec.pt2")))
    out = decode(imgs)
    assert set(out) == {"ids", "attention", "beta"}
    assert tuple(out["ids"].shape) == (4, 5)
    direct = (make_beam_decoder if beam > 1 else make_greedy_decoder)(model, cf)(net, imgs)
    assert torch.equal(out["ids"], direct.ids)
    np.testing.assert_allclose(out["beta"].numpy(), direct.beta.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["attention"].numpy(), direct.attention.numpy(), rtol=0,
                               atol=1e-6)
    head = "beam_head_topk" if beam > 1 else "greedy_head_argmax"
    assert {"adaptive_tpu_torch.decode_cell.default",
            f"adaptive_tpu_torch.{head}.default"} <= _ops(decode)


@pytest.mark.parametrize("beam", [1, 3])
def test_export_matches_jax_export(setup, tmp_path, beam):
    """The port's artifact and the JAX package's exported StableHLO decoder,
    on the same weights, give the same ids."""
    from adaptive_tpu.export import export_decoder as jax_export
    from adaptive_tpu.export import load_decoder as jax_load
    from adaptive_tpu.models.factory import build_model as jax_build
    from adaptive_tpu_torch.models.jax_params import to_jax

    jcf, cf, model, net, imgs = setup
    jcf, cf = jcf.replace(beam_size=beam), cf.replace(beam_size=beam)
    params, state = to_jax(net.state_dict(), model.arch)
    jdecode = jax_load(jax_export(jax_build(jcf), jcf, params, state, str(tmp_path / "j.bin")))
    decode = load_decoder(export_decoder(model, cf, net, str(tmp_path / "t.pt2")))
    want = np.asarray(jdecode(imgs)["ids"])
    np.testing.assert_array_equal(decode(imgs)["ids"].numpy(), want)
    assert len({tuple(r) for r in want.tolist()}) > 1  # the images caption apart


def test_export_rejects_wrong_batch(setup, tmp_path):
    _, cf, model, net, _ = setup
    decode = load_decoder(export_decoder(model, cf, net, str(tmp_path / "d.pt2"),
                                         batch_size=2))
    assert tuple(decode(np.zeros((2, 72, 72, 3), np.uint8))["ids"].shape) == (2, 5)
    with pytest.raises(Exception, match="size"):
        decode(np.zeros((3, 72, 72, 3), np.uint8))  # batch 3 != exported 2


@pytest.mark.parametrize("beam", [1, 3])
def test_exported_early_exit_equals_eager(setup, tmp_path, beam):
    """decode_early_exit: the exported program runs every step and zeroes
    the maps after the exit, which equals the eager decoder's break (ids,
    attention and beta ==). With <end> boosted, every greedy row ends at
    step 0 and every beam by step 1, so the zeroed tail is most of the
    output."""
    _, cf, model, net, imgs = setup
    cf = cf.replace(beam_size=beam, decode_early_exit=True)
    net2 = build_model(cf, device="cpu").init(0)
    net2.load_state_dict(net.state_dict())
    with torch.no_grad():
        net2.decoder.adaptive.mlp.bias[cf.decode_eos_token] += 1e4
    decode = load_decoder(export_decoder(model, cf, net2, str(tmp_path / "e.pt2")))
    out = decode(imgs)
    eager = (make_beam_decoder if beam > 1 else make_greedy_decoder)(model, cf)(net2, imgs)
    assert torch.equal(out["ids"], eager.ids)
    assert torch.equal(out["attention"], eager.attention)
    assert torch.equal(out["beta"], eager.beta)
    assert (out["ids"] == cf.decode_eos_token).all()
    tail = 1 if beam == 1 else 2  # beams 1.. hold other tokens at step 0
    assert not out["attention"][:, tail:].any() and not out["beta"][:, tail:].any()
    assert out["attention"][:, tail - 1].any()


def test_wrappers_reach_the_operators_only_under_a_tracer():
    """On real tensors a wrapper runs its kernel or twin without the
    dispatcher; the operator (which the export records) gives the same
    result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from adaptive_tpu_torch.ops import fused_step as fs

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(16, 128, generator=g), torch.randn(128, generator=g)
    chat, h = torch.randn(3, 16, generator=g), torch.randn(3, 16, generator=g)
    with Log() as eager:
        ids = fs.greedy_head_argmax(w, b, chat, h, 100)
    with Log() as traced:
        via_op = fs._greedy_head_argmax_op.op(w, b, chat, h, 100, None)
    assert not any("adaptive_tpu_torch" in o for o in eager.ops)
    assert "adaptive_tpu_torch.greedy_head_argmax.default" in traced.ops
    assert torch.equal(ids, via_op)
