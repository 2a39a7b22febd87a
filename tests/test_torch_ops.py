"""The PyTorch port's ops against the JAX package's on the same inputs
(fp32, atol 1e-5 as tests/test_ops_parity.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.ops import attention as jatt
from adaptive_tpu.ops import lstm as jlstm
from adaptive_tpu.ops import preprocess as jpre
from adaptive_tpu_torch.ops import attention as tatt
from adaptive_tpu_torch.ops import inits as tinits
from adaptive_tpu_torch.ops import lstm as tlstm
from adaptive_tpu_torch.ops import preprocess as tpre
from tests.torch_port_util import port_threads  # noqa: F401

ATOL = 1e-5
B, T, K, H, D, E2 = 3, 2, 49, 16, 49, 12


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _both(tree):
    """The same numpy tree as (jax arrays, torch tensors)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


@pytest.fixture()
def data():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return _both({
        "atten": {"affine_v": {"kernel": f(H, D)}, "affine_g": {"kernel": f(H, D)},
                  "affine_s": {"kernel": f(H, D)}, "affine_h": {"kernel": f(D, 1)}},
        "sentinel": {"affine_x": {"kernel": f(E2, H)}, "affine_h": {"kernel": f(H, H)}},
        "lstm": {"w_ih": f(E2, 4 * H), "w_hh": f(H, 4 * H) * 0.2,
                 "b_ih": f(4 * H) * 0.1, "b_hh": f(4 * H) * 0.1},
        "V": f(B, K, H), "h": f(B, T, H), "s": f(B, T, H), "x": f(B, T, E2),
        "h0": f(B, H), "c0": f(B, H),
    })


def test_lstm_cell(data):
    j, t = data
    (jh, (_, jc)) = jlstm.lstm_cell(j["lstm"], j["x"][:, 0], (j["h0"], j["c0"]))
    (th, (_, tc)) = tlstm.lstm_cell(t["lstm"], t["x"][:, 0], (t["h0"], t["c0"]))
    _close(th, jh)
    _close(tc, jc)


def test_precompute_slots(data):
    j, t = data
    _close(tatt.precompute_slots(t["atten"], t["V"]), jatt.precompute_slots(j["atten"], j["V"]))


@pytest.mark.parametrize("with_pv", [False, True])
def test_attention_logits(data, with_pv):
    j, t = data
    jpv = jatt.precompute_slots(j["atten"], j["V"]) if with_pv else None
    tpv = tatt.precompute_slots(t["atten"], t["V"]) if with_pv else None
    _close(tatt.attention_logits(t["atten"], t["V"], t["h"], tpv),
           jatt.attention_logits(j["atten"], j["V"], j["h"], jpv))


def test_sentinel_gate(data):
    j, t = data
    _close(tatt.sentinel_gate(t["sentinel"], t["x"], t["h"], t["s"]),
           jatt.sentinel_gate(j["sentinel"], j["x"], j["h"], j["s"]))


def test_adaptive_attention(data):
    j, t = data
    got = tatt.adaptive_attention(t["atten"], t["V"], t["h"], t["s"])
    want = jatt.adaptive_attention(j["atten"], j["V"], j["h"], j["s"])
    for name, a, b in zip(("c_hat", "alpha", "beta"), got, want):
        assert a.shape == b.shape, name
        _close(a, b)


@pytest.mark.parametrize("src,size", [(256, 224), (72, 64), (64, 64)])
def test_eval_preprocess_fp32(src, size):
    imgs = np.random.default_rng(src).integers(0, 256, (2, src, src, 3), dtype=np.uint8)
    got = tpre.eval_preprocess(torch.from_numpy(imgs), size)
    want = jpre.eval_preprocess(jnp.asarray(imgs), size)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


def test_eval_preprocess_bf16():
    """bf16 mode: JAX resizes in bf16; PyTorch's CPU antialias kernel refuses
    bf16, so the port resizes in fp32 on the CPU and rounds once. Stated
    tolerance: 0.05, the deviation the JAX package documents for its bf16
    resize against the exact path (preprocess.py:82-83)."""
    imgs = np.random.default_rng(3).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    got = tpre.eval_preprocess(torch.from_numpy(imgs), 224, torch.bfloat16)
    want = jpre.eval_preprocess(jnp.asarray(imgs), 224, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), atol=0.05)


def test_normalize():
    imgs = np.random.default_rng(4).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    _close(tpre.normalize(torch.from_numpy(imgs)), jpre.normalize(jnp.asarray(imgs)))


@pytest.mark.parametrize("scheme,nl,moment", [
    ("xavier_uniform", "tanh", (5 / 3) ** 2 * 2 / (600 + 400)),
    ("xavier_normal", "tanh", (5 / 3) ** 2 * 2 / (600 + 400)),
    ("kaiming_uniform", "relu", 2 / 600),
    ("kaiming_normal", "relu", 2 / 600),
])
def test_init_schemes_variance(scheme, nl, moment):
    """Each scheme's sample variance is the formula's (torch's semantics, as
    in the JAX package's ops/inits.py), within 5% at 240k draws."""
    gen = torch.Generator().manual_seed(0)
    w = tinits.linear_weight(gen, 600, 400, scheme, nl)
    assert w.shape == (400, 600)
    assert abs(w.var().item() / moment - 1) < 0.05
