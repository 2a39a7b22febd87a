"""Weight bridge of the PyTorch port (adaptive_tpu_torch/models/jax_params.py):
JAX parameter trees <-> the reference Encoder2Decoder's state_dict."""

import jax
import numpy as np
import pytest
import torch

from adaptive_tpu_torch.models.factory import Encoder2Decoder, build_model
from adaptive_tpu_torch.models.jax_params import from_jax, to_jax
from tests.torch_port_util import jax_weights, port_cf, random_weights
from tests.torch_port_util import port_threads  # noqa: F401


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_round_trip_exact_and_loads(tiny_cf, arch):
    cf = tiny_cf.replace(encoder_backbone=arch)
    params, state = random_weights(cf, seed=1)
    sd = from_jax(params, state, arch)
    p2, s2 = to_jax(sd, arch)
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, state)

    model = build_model(port_cf(cf), device="cpu")
    net = Encoder2Decoder(model.spec, arch)
    net.load_state_dict(sd, strict=True)  # every key and shape matches


def test_round_trip_resnet152_structure(tiny_cf):
    """The full backbone's tree (random leaves of the real shapes) survives
    the round trip exactly and matches the module's keys and shapes."""
    cf = tiny_cf.replace(encoder_backbone="resnet152", train_crop_size=224)
    params, state = random_weights(cf)
    sd = from_jax(params, state, "resnet152")
    p2, s2 = to_jax(sd, "resnet152")
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, state)

    model = build_model(port_cf(cf), device="cpu")
    with torch.device("meta"):
        net = Encoder2Decoder(model.spec, "resnet152")
    net.load_state_dict(sd, strict=True, assign=True)
    assert len(net.encoder.resnet_conv[6]) == 36  # layer3 of ResNet-152


def test_keys_are_the_reference_names(tiny_cf):
    """The bridge's state_dict is a reference Encoder2Decoder checkpoint: the
    JAX package's own converter reads it back to the same tree."""
    from adaptive_tpu.models.torch_import import convert_reference_checkpoint

    for arch in ("resnet18", "resnet50"):
        cf = tiny_cf.replace(encoder_backbone=arch)
        params, state = random_weights(cf, seed=2)
        sd = from_jax(params, state, arch)
        p2, s2 = convert_reference_checkpoint(sd, "adaptive_attention", arch)
        _assert_trees_equal(p2, params)
        _assert_trees_equal(s2, state)


def test_jax_init_loads_into_port(tiny_cf):
    """The JAX package's own init carries across unchanged."""
    _, params, state = jax_weights(tiny_cf, seed=1)
    sd = from_jax(params, state, tiny_cf.encoder_backbone)
    p2, s2 = to_jax(sd, tiny_cf.encoder_backbone)
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, state)


def test_port_init_matches_module_structure(tiny_cf):
    """Seeded random init on the CPU fills every parameter and buffer and is
    reproducible from its seed."""
    model = build_model(port_cf(tiny_cf), device="cpu")
    a, b = model.init(3).state_dict(), model.init(3).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.isfinite(a[k].float()).all(), k
    p, s = to_jax(a, tiny_cf.encoder_backbone)
    assert np.allclose(s["resnet"]["bn1"]["var"], 1.0)
    lstm = p["decoder"]["lstm"]
    H = tiny_cf.adaptive_lstm_hidden_size
    np.testing.assert_array_equal(lstm["b_ih"][H:2 * H], 0.5)
    # orthogonal recurrent weight: w_hh [H, 4H] has orthonormal rows
    np.testing.assert_allclose(lstm["w_hh"] @ lstm["w_hh"].T, np.eye(H), atol=1e-5)
