"""The PyTorch port's encoder inference path against the JAX package's:
BN fold, folded ResNet forward and (V, v_g, h0, c0), fp32 at 64 px, atol 2e-4
(the bound of tests/test_infer.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.models import infer as jinfer
from adaptive_tpu.models import resnet as jresnet
from adaptive_tpu_torch.models import infer as tinfer
from adaptive_tpu_torch.models.factory import build_model
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net
from tests.torch_port_util import port_threads  # noqa: F401

ATOL = 2e-4


def _setup(tiny_cf, arch):
    """JAX weights with non-trivial BN statistics, and the port holding them."""
    cf = tiny_cf.replace(encoder_backbone=arch)
    _, params, state = jax_weights(cf, seed=1)
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), state)
    model, net = port_model_and_net(port_cf(cf), params, state)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    return cf, params, state, model, net, images


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_fold_resnet_matches(tiny_cf, arch):
    _, params, state, _, net, _ = _setup(tiny_cf, arch)
    want = jinfer.fold_resnet(params["encoder"]["resnet"], state["resnet"], arch)
    got = tinfer.fold_resnet(net.encoder.resnet_conv)
    # port kernels are OIHW, the JAX package's HWIO
    to_hwio = lambda t: t.permute(2, 3, 1, 0).numpy()  # noqa: E731
    np.testing.assert_allclose(to_hwio(got["conv1"]["kernel"]), want["conv1"]["kernel"], atol=1e-6)
    blk_w, blk_g = want["layer2"][0], got["layer2"][0]
    assert set(blk_w) == set(blk_g)
    for name in blk_w:
        np.testing.assert_allclose(to_hwio(blk_g[name]["kernel"]), blk_w[name]["kernel"], atol=1e-6)
        np.testing.assert_allclose(blk_g[name]["bias"].numpy(), blk_w[name]["bias"], atol=1e-6)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_apply_folded_and_eval_forward(tiny_cf, arch):
    _, params, state, _, net, images = _setup(tiny_cf, arch)
    want, _ = jresnet.resnet_apply(params["encoder"]["resnet"], state["resnet"],
                                   jnp.asarray(images), arch, train=False)
    with torch.no_grad():
        folded = tinfer.resnet_apply_folded(
            tinfer.fold_resnet(net.encoder.resnet_conv), torch.from_numpy(images), arch)
        unfolded = net.encoder.resnet_conv(torch.from_numpy(images))
    assert tuple(folded.shape) == want.shape
    np.testing.assert_allclose(folded.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(unfolded.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_encoder_apply_inference_matches(tiny_cf, arch):
    _, params, state, model, net, images = _setup(tiny_cf, arch)
    want = jinfer.encoder_apply_inference(
        params["encoder"], state, jnp.asarray(images), arch, jnp.float32, quant="none")
    prepared = model.prepare_inference(net)
    got = model.encode_inference(prepared, torch.from_numpy(images))
    for name, a, b in zip(("V", "v_g", "h0", "c0"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


def test_calibrate_bn_sets_batch_statistics(tiny_cf):
    """calibrate_bn_ (the random model's BN statistics): each BN holds the
    statistics of its conv's output on the batch, and each residual
    branch's last BN the scale residual_gain."""
    from adaptive_tpu_torch.models.resnet import _residual_bns, calibrate_bn_

    model = build_model(port_cf(tiny_cf), device="cpu")
    rn = model.init(0).encoder.resnet_conv
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32))
    calibrate_bn_(rn, x, residual_gain=0.2)
    with torch.no_grad():
        stem = rn[0](x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(rn[1].running_mean.numpy(), stem.mean((0, 2, 3)).numpy(), atol=1e-5)
    np.testing.assert_allclose(rn[1].running_var.numpy(),
                               stem.var((0, 2, 3), unbiased=False).numpy(), rtol=1e-4)
    gains = [bn.weight for bn in _residual_bns(rn)]
    assert len(gains) == 8 and all(bool((g == 0.2).all()) for g in gains)  # resnet18: 8 blocks
    assert torch.isfinite(rn(x)).all()
