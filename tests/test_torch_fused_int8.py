"""The plain twins of the fused int8 kernels (ops/fused_block.py,
ops/fused_tail.py) and the int8 encoder with fused layers or tails, against
the JAX package's Pallas kernels in interpret mode, on the CPU.

The bounds are the JAX package's own (tests/test_pallas.py): the Pallas
kernels match the XLA carry up to +/-1 quantum at requant ties (FMA
contraction), on under 0.2% of elements; the port's twins are the carry's
operations exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.models import infer as J
from adaptive_tpu_torch.models import infer as T
from adaptive_tpu_torch.ops import fused_block as FB
from adaptive_tpu_torch.ops import fused_tail as FT
from adaptive_tpu_torch.ops.int8 import wmat
from tests.test_torch_int8 import images, setup, to_port_folded
from tests.torch_port_util import port_threads  # noqa: F401


def _conv_params(rng, shapes):
    """{name: {kernel HWIO, bias}} in JAX's layout and the port's (OIHW)."""
    jp = {name: {"kernel": rng.normal(0, 0.4, shp).astype(np.float32),
                 "bias": rng.normal(0, 0.2, shp[-1]).astype(np.float32)}
          for name, shp in shapes.items()}
    return jp, to_port_folded(jp)


def _within_one_quantum(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() < 2e-3, (d != 0).mean()
    return int((d != 0).sum())


@pytest.mark.parametrize("B,W,C,M", [(2, 8, 16, 8), (4, 4, 24, 8), (8, 4, 64, 32)])
def test_fused_block_twin_matches_jax(B, W, C, M):
    """_fused_identity_block (the twin on the CPU) against JAX's Pallas
    kernel in interpret mode (bound above) and against JAX's unfused carry
    segment (the same operations: equal)."""
    rng = np.random.default_rng(0)
    jp, tp = _conv_params(rng, {"conv1": (1, 1, C, M), "conv2": (3, 3, M, M),
                                "conv3": (1, 1, M, C)})
    y = rng.integers(-127, 128, (B, W, W, C)).astype(np.int8)
    s_in, s2, s3, s_out = 0.021, 0.034, 0.057, 0.026
    got = T._fused_identity_block(tp, torch.from_numpy(y), s_in, s2, s3, s_out).numpy()
    want = J._fused_identity_block(jp, jnp.asarray(y), s_in, s2, s3, s_out, interpret=True)
    _within_one_quantum(got, want)

    from tests.test_pallas import _ref_identity_block
    ref = _ref_identity_block(jp, jnp.asarray(y), s_in, s2, s3, s_out)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("B,W,C,M,M2", [(2, 4, 16, 8, 8), (4, 4, 32, 16, 24)])
def test_fused_tail_twin_matches_jax(B, W, C, M, M2):
    """_fused_tail_pair against JAX's Pallas kernel in interpret mode, stage
    by stage as tests/test_pallas.py compares it: the carry against the
    kernel's, then conv1 on the port's own carry against JAX's XLA ops."""
    rng = np.random.default_rng(2)
    jp3, tp3 = _conv_params(rng, {"conv3": (1, 1, M, C)})
    jp1, tp1 = _conv_params(rng, {"conv1": (1, 1, C, M2)})
    y = rng.integers(-127, 128, (B, W, W, C)).astype(np.int8)
    z2f = np.abs(rng.normal(0, 1.5, (B, W, W, M))).astype(np.float32)
    s3, s_in, s_out, s_next = 0.031, 0.024, 0.027, 0.042
    out, z1 = T._fused_tail_pair(tp3, tp1, torch.from_numpy(y), torch.from_numpy(z2f),
                                 s3, s_in, s_out, s_next)
    want_out, _ = J._fused_tail_pair(jp3, jp1, jnp.asarray(y), jnp.asarray(z2f),
                                     s3, s_in, s_out, s_next, interpret=True)
    _within_one_quantum(out.numpy(), want_out)

    acc, csc = J._acc_i8(jnp.asarray(out.numpy()), jp1["conv1"]["kernel"], s_out, 1)
    z1_ref = J._requant(jnp.maximum(acc.astype(jnp.float32) * csc + jp1["conv1"]["bias"], 0),
                        s_next)
    np.testing.assert_array_equal(z1.numpy(), np.asarray(z1_ref))


def _encoder_case(tiny_cf, B):
    arch = "resnet50"
    _, params, state, _, net = setup(tiny_cf, arch)
    x = images(B, 64, seed=5)
    scales = J.calibrate_int8(params["encoder"], state, jnp.asarray(x), arch, granularity="tensor")
    folded = J.fold_resnet(params["encoder"]["resnet"], state["resnet"], arch)
    return arch, net, x, scales, folded


def _close_to(f, b):
    """tests/test_pallas.py:522-526: max |d| < 0.05 max |b|, cosine > 0.9999."""
    f, b = np.asarray(f, np.float64), np.asarray(b, np.float64)
    assert np.abs(f - b).max() < 0.05 * np.abs(b).max()
    cos = (b * f).sum() / (np.linalg.norm(b) * np.linalg.norm(f))
    assert cos > 0.9999, cos


@pytest.mark.parametrize("scheme", ["fused_layers", "fused_tails"])
def test_fused_encoder_matches_jax(tiny_cf, scheme):
    """ResNet-50 at 64 px, batch 2, layer3 fused: JAX's tiling rules fuse
    there too (4x4 images in groups of 2; 32 rows), so both route the same
    blocks, and the tail pair hands off layer3.5 -> layer4.0, a downsample
    block. Port against JAX's Pallas run, within the bound above; and the
    port's fused run equals its own unfused one to the bit."""
    from adaptive_tpu.ops.pallas.fused_block import pick_group

    arch, _, x, scales, folded = _encoder_case(tiny_cf, 2)
    assert pick_group(2, 16) > 0 and (2 * 16) % 32 == 0
    kw = {scheme: ("layer3",)}
    want = J.resnet_apply_folded_int8(folded, jnp.asarray(x), arch, scales, interpret=True, **kw)
    FB.bottleneck_identity_int8.launches = FT.tail_conv1_int8.launches = 0
    tfold = to_port_folded(folded)
    got = T.resnet_apply_folded_int8(tfold, torch.from_numpy(x), arch, scales, **kw)
    assert FB.bottleneck_identity_int8.launches == FT.tail_conv1_int8.launches == 0  # CPU: twins
    _close_to(got.numpy(), want)
    base = T.resnet_apply_folded_int8(tfold, torch.from_numpy(x), arch, scales)
    assert torch.equal(got, base)


@pytest.mark.parametrize("scheme", ["fused_layers", "fused_tails"])
def test_fused_routing_where_jax_does_not_fuse(tiny_cf, scheme, monkeypatch):
    """Batch 1: JAX's tiling rules leave layer3 unfused (16 rows fit no
    32-row tile); the port fuses it all the same (ROADMAP §4), and stays
    within the bound above of JAX's unfused forward. Each of layer3's 5
    identity blocks goes through the kernel (the tail's 5 boundaries
    include layer3.5 -> layer4.0)."""
    arch, _, x, scales, folded = _encoder_case(tiny_cf, 1)
    calls = []
    target = (T, "_fused_identity_block") if scheme == "fused_layers" else (T, "_fused_tail_pair")
    real = getattr(*target)
    monkeypatch.setattr(*target, lambda *a, **k: calls.append(1) or real(*a, **k))
    want = J.resnet_apply_folded_int8(folded, jnp.asarray(x), arch, scales)
    got = T.resnet_apply_folded_int8(to_port_folded(folded), torch.from_numpy(x), arch, scales,
                                     **{scheme: ("layer3",)})
    assert len(calls) == 5
    _close_to(got.numpy(), want)


def test_prepared_once_equals_per_batch_quantised(tiny_cf):
    """The port quantises the fused layers' weights once (prepare), where
    JAX re-quantises them in every decode program: _quant_conv_weight(k, s)
    with a scalar s is (_quant_w(k)[0], sw * s), the fused path's s * sw.
    The prepared tree through both fused schemes equals the raw one."""
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.normal(0, 0.4, (16, 24, 3, 3)).astype(np.float32))
    for s in (0.021, 0.0337):
        wq, sc = T._quant_conv_weight(k, s)
        wq0, sw = T._quant_w(k)
        assert torch.equal(wq, wq0) and torch.equal(sc, torch.full((), s) * sw)
    arch, net, x, scales, _ = _encoder_case(tiny_cf, 2)
    prepared = T.prepare_encoder_inference(net.encoder, torch.float32, "int8", scales)
    raw = T.prepare_encoder_inference(net.encoder, torch.float32, "int8")
    assert "wq" in prepared["resnet"]["layer3"][1]["conv2"]
    xt = torch.from_numpy(x)
    for kw in ({"fused_layers": ("layer1", "layer3")}, {"fused_tails": ("layer2", "layer4")}):
        a = T.resnet_apply_folded_int8(prepared["resnet"], xt, arch, scales, **kw)
        b = T.resnet_apply_folded_int8(raw["resnet"], xt, arch, scales, **kw)
        assert torch.equal(a, b)


def test_wrappers_check_shapes_on_cpu():
    x = torch.zeros(2 * 4 * 4, 16, dtype=torch.int8)
    w1, w2, w3 = (torch.zeros(s, dtype=torch.int8) for s in ((8, 16), (8, 72), (16, 8)))
    rows = [torch.zeros(n) for n in (8, 8, 8, 8, 16, 16)]
    FB.bottleneck_identity_int8(x, 4, 4, w1, w2, w3, *rows, 0.1, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="whole 4x5 images"):
        FB.bottleneck_identity_int8(x, 4, 5, w1, w2, w3, *rows, 0.1, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="w2 has shape"):
        FB.bottleneck_identity_int8(x, 4, 4, w1, w2[:, :64], w3, *rows, 0.1, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="multiples of 8"):
        FB.bottleneck_identity_int8(x[:, :12], 4, 4, w1[:, :12], w2, w3[:12], *rows[:4],
                                    rows[4][:12], rows[5][:12], 0.1, 0.1, 0.1, 0.1)
    z2 = torch.zeros(32, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="sc1 has shape"):
        FT.tail_conv1_int8(x, z2, w3, rows[4], rows[5], w1, rows[0][:4], rows[1], 0.1, 0.1, 0.1)
    out, z1 = FT.tail_conv1_int8(x, z2, w3, rows[4], rows[5], w1, rows[0], rows[1], 0.1, 0.1, 0.1)
    assert out.shape == (32, 16) and z1.shape == (32, 8) and z1.dtype == torch.int8
    assert wmat(w1.reshape(8, 16, 1, 1)).shape == (8, 16)
    with pytest.raises(ValueError, match="b3 is on meta"):
        FT.tail_conv1_int8(x, z2, w3, rows[4], rows[5].to("meta"), w1, rows[0], rows[1],
                           0.1, 0.1, 0.1)
