"""The PyTorch port's conv-backward quantisation experiment
(adaptive_tpu_torch/ops/quant_conv.py) against the JAX package's
(adaptive_tpu/ops/quant_conv.py): each test of tests/test_quant_conv.py on
the port; the port's backward against JAX's VJP in each mode on the same
inputs and cotangent (NHWC/HWIO there, NCHW/OIHW here), with the int8
operands and int32 counts equal; dw's chunked int64 sum past 133,144 rows;
a train step in each mode against JAX's make_train_step; and a two-rank
"int8" step against one process, which holds the amax all-reduce. Each test
states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaptive_tpu.ops import quant_conv as jqc
from adaptive_tpu_torch.ops import quant_conv as tqc
from tests.test_torch_multiprocess import run_ranks
from tests.test_torch_train_step import _jax_copy, _patch_draws
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net
from tests.torch_port_util import port_threads  # noqa: F401

MODES = ("none", "manual", "int8")
# port vs JAX, fp32 "none" and "manual": the train-step gradient bound of
# tests/test_torch_train_step.py, its rtol taken of the tensor's largest
# value (a conv gradient sums B*H*W or kh*kw*Co products)
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# bf16 activations and cotangent (the bf16 train path: fp32 weights): dx is
# bf16, so one bf16 rounding step of the tensor's largest value, 2^-8, and
# as much again for sums in another order before it
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    tqc.set_conv_bwd_quant("none")
    jqc.set_conv_bwd_quant("none")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))


def _to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _to_hwio(t):
    return t.detach().float().permute(2, 3, 1, 0).numpy()


def _port_grads(mode, x, w, stride=1, loss=None, g=None):
    """The port's (dx, dw) in mode: through a loss of y, or the cotangent g."""
    tqc.set_conv_bwd_quant(mode)
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    y = tqc.conv_nchw(x, w, stride)
    if g is None:
        g = torch.autograd.grad(loss(y), y, retain_graph=True)[0] if loss else None
    return torch.autograd.grad(y, (x, w), g)


def _cos_loss(y):
    return torch.sum(y * torch.cos(y))  # a nontrivial cotangent, as JAX's test


# --------------------------------------------- tests/test_quant_conv.py on the port
@pytest.mark.parametrize("k,cin,cout,hw", [(3, 8, 16, 10), (1, 16, 8, 7), (5, 4, 4, 12)])
def test_manual_backward_matches_autograd(k, cin, cout, hw):
    """'manual' (F.conv2d on the flipped and transposed operands) equals
    autograd's own conv backward within JAX's atol = rtol = 1e-4
    (tests/test_quant_conv.py:40-41)."""
    x, w = _nchw(_rand((2, hw, hw, cin), 0)), _oihw(_rand((k, k, cin, cout), 1, 0.2))
    ref = _port_grads("none", x, w, loss=_cos_loss)
    got = _port_grads("manual", x, w, loss=_cos_loss)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_int8_backward_close_to_exact():
    """int8 gradients correlate with the exact ones: cosine > 0.99 and
    relative error < 0.1 (tests/test_quant_conv.py:54-56)."""
    x, w = _nchw(_rand((2, 10, 10, 8), 2)), _oihw(_rand((3, 3, 8, 16), 3, 0.2))
    ref = _port_grads("none", x, w, loss=_cos_loss)
    got = _port_grads("int8", x, w, loss=_cos_loss)
    for a, b in zip(got, ref):
        a, b = a.numpy().ravel(), b.numpy().ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.1


def test_forward_exact_in_all_modes():
    """The forward is bit-identical in every mode, and equals F.conv2d."""
    x, w = _nchw(_rand((2, 9, 9, 4), 4)), _oihw(_rand((3, 3, 4, 8), 5))
    outs = []
    for mode in MODES:
        tqc.set_conv_bwd_quant(mode)
        outs.append(tqc.conv_nchw(x.requires_grad_(True), w, 1).detach())
    for o in outs:
        assert torch.equal(o, outs[0])
    assert torch.equal(outs[0], F.conv2d(x.detach(), w, None, 1, 1))


@pytest.mark.parametrize("mode", ["manual", "int8"])
def test_strided_conv_keeps_exact_backward(mode):
    """Stride-2 convs bypass the experiment: gradients equal mode 'none''s."""
    x, w = _nchw(_rand((2, 8, 8, 4), 6)), _oihw(_rand((3, 3, 4, 8), 7))
    loss = lambda y: torch.sum(y ** 2)  # noqa: E731
    ref = _port_grads("none", x, w, 2, loss=loss)
    got = _port_grads(mode, x, w, 2, loss=loss)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_resnet_conv_unchanged_by_default(mode):
    """models/resnet.py::_conv_apply: the module call in mode 'none' and
    without autograd (forward hooks fire: calibrate_bn_), quant_conv's
    custom Function where autograd records in the other modes; the output
    equals the plain conv in every mode."""
    from adaptive_tpu_torch.models.resnet import _conv, _conv_apply

    conv = _conv(3, 4, 3)
    x = _nchw(_rand((1, 8, 8, 3), 8))
    with torch.no_grad():
        conv.weight.copy_(_oihw(_rand((3, 3, 3, 4), 9)))
    want = F.conv2d(x, conv.weight.detach(), None, 1, 1)
    tqc.set_conv_bwd_quant(mode)
    fired = []
    h = conv.register_forward_hook(lambda *a: fired.append(1))
    try:
        with torch.no_grad():
            assert torch.equal(_conv_apply(conv, x), want)
        y = _conv_apply(conv, x.clone().requires_grad_(True))
    finally:
        h.remove()
    assert torch.equal(y.detach(), want)
    custom = "ConvCustomBwd" in type(y.grad_fn).__name__
    assert custom == (mode != "none") and len(fired) == (1 if custom else 2)


# ------------------------------------------------- port vs JAX, cotangent fed in
def _jax_vjp(mode, x, w, g):
    jqc.set_conv_bwd_quant(mode)
    _, vjp = jax.vjp(lambda a, b: jqc.conv_nhwc(a, b, 1), jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(v, np.float32) for v in vjp(jnp.asarray(g))]


def _jax_counts(x, w, g):
    """JAX's int8 operands and int32 counts, as its _bwd forms them."""
    gq, sg = jqc._q8(jnp.asarray(g))
    wq, sw = jqc._q8(jnp.asarray(w))
    xq, sx = jqc._q8(jnp.asarray(x))
    p = (w.shape[0] - 1) // 2
    pads = [(p, p)] * 2
    w_t = jnp.flip(wq, (0, 1)).transpose(0, 1, 3, 2)
    dx = jax.lax.conv_general_dilated(gq, w_t, (1, 1), pads, dimension_numbers=(
        "NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    dw = jax.lax.conv_general_dilated(xq, gq, (1, 1), pads, dimension_numbers=(
        "CHWN", "IHWO", "HWNC"), preferred_element_type=jnp.int32)
    return {"gq": gq, "wq": wq, "xq": xq, "sg": sg, "sw": sw, "sx": sx, "dx": dx, "dw": dw}


def _port_counts(x, w, g):
    gq, sg = tqc._q8(g)
    wq, sw = tqc._q8(w)
    xq, sx = tqc._q8(x)
    return {"gq": _to_nhwc(gq), "wq": _to_hwio(wq), "xq": _to_nhwc(xq), "sg": sg, "sw": sw,
            "sx": sx, "dx": tqc.dx_counts(gq, wq), "dw": tqc.dw_counts(xq, gq, w.shape[2])}


def _hold_counts(got, want):
    for k in ("gq", "wq", "xq"):
        assert np.array_equal(got[k], np.asarray(want[k], np.float32)), k
    for k in ("sg", "sw", "sx"):
        assert got[k].dtype == torch.float32 and got[k].item() == float(want[k]), k
    assert got["dx"].dtype == torch.int32
    assert np.array_equal(got["dx"].permute(0, 2, 3, 1).numpy(), np.asarray(want["dx"]))
    assert np.array_equal(got["dw"].permute(2, 3, 1, 0).numpy(), np.asarray(want["dw"]))


CASES = {  # (B, H, Ci, Co, k)
    "3x3": (2, 10, 8, 16, 3),
    "1x1": (3, 7, 16, 8, 1),
    "3x3_wide": (2, 6, 24, 40, 3),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_equals_jax_fp32(case, mode):
    """The same NHWC/HWIO inputs and cotangent g through JAX's
    jax.vjp(conv_nhwc) and the port's autograd.grad(y, (x, w), g) in fp32:
    'none' and 'manual' within atol 1e-5 + rtol 1e-4 of the tensor's largest
    value; 'int8' with the quantised operands, their scales and the int32
    counts equal, dx and dw within 1 fp32 ulp."""
    B, H, Ci, Co, k = CASES[case]
    x, w = _rand((B, H, H, Ci), 10), _rand((k, k, Ci, Co), 11, 0.2)
    g = _rand((B, H, H, Co), 12)
    want = _jax_vjp(mode, x, w, g)
    dx, dw = _port_grads(mode, _nchw(x), _oihw(w), g=_nchw(g))
    got = [_to_nhwc(dx), _to_hwio(dw)]
    for a, b in zip(got, want):
        if mode == "int8":
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
        else:
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL + GRAD_RTOL * np.abs(b).max(), rtol=0)
    if mode == "int8":
        _hold_counts(_port_counts(_nchw(x), _oihw(w), _nchw(g)), _jax_counts(x, w, g))


@pytest.mark.parametrize("mode", MODES)
def test_backward_equals_jax_bf16(mode):
    """bf16 x and g with an fp32 kernel (the bf16 train path): dx (bf16)
    within 2^-7 of its largest value, dw (fp32) within 1e-5 + 2^-7 of its
    largest value in 'none' and 'manual' (bf16 and fp32 sums in another
    order); in 'int8' the operands and counts equal and dw within 1 fp32
    ulp, dx within one bf16 rounding of the same fp32 values (1 bf16 ulp)."""
    x, w = _rand((2, 8, 8, 16), 13), _rand((3, 3, 16, 8), 14, 0.2)
    g = _rand((2, 8, 8, 8), 15)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16))
    want = _jax_vjp(mode, xb, w, gb)
    tx, tg = _nchw(x).bfloat16(), _nchw(g).bfloat16()
    dx, dw = _port_grads(mode, tx, _oihw(w), g=tg)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    got = [_to_nhwc(dx), _to_hwio(dw)]
    if mode == "int8":
        _hold_counts(_port_counts(tx, _oihw(w), tg), _jax_counts(xb, w, gb))
        np.testing.assert_array_max_ulp(got[1], want[1], maxulp=1)
        ulp = np.spacing(np.abs(want[0]).astype(np.float32)) * 2 ** 16  # bf16's ulp
        assert (np.abs(got[0] - want[0]) <= ulp).all()
    else:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-5 + BF16_REL * np.abs(b).max(), rtol=0)


def test_dw_chunks_past_int32():
    """dw's K = B*H*W = 140,000 rows passes DW_CHUNK (133,144): the chunks'
    int32 counts summed in int64 equal JAX's single int32 contraction on
    seeded data (no wrap there), and an int64 evaluation on constant data
    whose centre tap sums 127^2 * 140,000 > 2^31 - 1 (where JAX's int32
    contraction would wrap)."""
    assert tqc.DW_CHUNK == 133144 and 127 ** 2 * tqc.DW_CHUNK <= 2 ** 31 - 1 < 127 ** 2 * 133145
    B, H, C = 14, 100, 8
    x, g, w = _rand((B, H, H, C), 16), _rand((B, H, H, C), 17), _rand((3, 3, C, C), 18)
    got = _port_counts(_nchw(x), _oihw(w), _nchw(g))
    assert got["dw"].dtype == torch.int64
    _hold_counts(got, _jax_counts(x, w, g))
    ones = torch.ones(B, C, H, H, dtype=torch.int8) * 127
    got = tqc.dw_counts(ones, ones, 3)
    cols = torch.nn.functional.unfold(ones.double(), 3, padding=1)  # [B, C*9, H*W]
    want = torch.einsum("bkn,bon->ok", cols, ones.double().reshape(B, C, -1))
    assert torch.equal(got.reshape(C, -1).double(), want)  # (ci, ky, kx) order, as unfold
    assert int(got.max()) == 127 ** 2 * B * H * H > 2 ** 31 - 1


# ------------------------------------------------------- train step vs JAX's
SGD_LR = 2.0 ** 20


@pytest.fixture(scope="module")
def step_setup(tiny_cf):
    """tests/test_torch_train_step.py's weights and batch of 4, with SGD at
    lr 2^20 in both groups: a first Nesterov step moves a weight by lr (1 +
    momentum) times its gradient (the divided and clipped one), so the move
    gives the gradient to fp32 rounding of the gradient, read on the JAX side
    from JAX's own step."""
    jcf = tiny_cf.replace(train_batch_size=4, opt_rnn_optimization="sgd",
                          opt_cnn_optimization="sgd", opt_rnn_sgd_learning_rate=SGD_LR,
                          opt_cnn_sgd_learning_rate=SGD_LR)
    _, params, state = jax_weights(jcf)
    rng = np.random.default_rng(7)
    batch = {"images": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
             "captions": rng.integers(1, jcf.vocab_length, (4, 6)).astype(np.int32),
             "lengths": np.array([6, 3, 5, 4], np.int32)}
    return jcf, params, state, batch


@pytest.fixture(scope="module")
def step_runs(step_setup):
    """Each mode's step in both packages on the same weights, batch and
    draws: (loss, LSTM norm, {JAX key: gradient}) for JAX and the port."""
    from adaptive_tpu.models.factory import build_model as jbuild
    from adaptive_tpu.training import checkpoint as JC
    from adaptive_tpu.training import optim as JO
    from adaptive_tpu.training import step as JST
    from adaptive_tpu_torch.models.jax_params import param_keys, to_layout
    from adaptive_tpu_torch.ops import preprocess as tpre
    from adaptive_tpu_torch.training import optim as TO
    from adaptive_tpu_torch.training import step as TST

    jcf, params, state, batch = step_setup
    key = jax.random.PRNGKey(21)
    before = {k[len("params|"):]: np.asarray(v) for k, v in
              JC._flatten({"params": params}).items()}
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for mode in MODES:
            jqc.set_conv_bwd_quant(mode)
            jp = _jax_copy(params)
            jdual, jopt = JO.make_dual_optimizer(jp, jcf)
            out = JST.make_train_step(jbuild(jcf), jdual, jcf)(
                jp, _jax_copy(state), jopt, dict(batch), key, True)
            after = {k[len("params|"):]: np.asarray(v) for k, v in
                     JC._flatten({"params": out.params}).items()}
            m = {True: jcf.opt_cnn_sgd_momentum, False: jcf.opt_rnn_sgd_momentum}
            jgrads = {k: (before[k] - after[k]) / np.float32(SGD_LR * (1 + m["resnet" in k]))
                      for k in before}
            tqc.set_conv_bwd_quant(mode)
            pcf = port_cf(jcf)
            model, net = port_model_and_net(pcf, params, state)
            dual = TO.make_dual_optimizer(net, pcf)
            step = TST.make_train_step(model, dual, pcf)
            _patch_draws(mp, [key], jcf.train_crop_size)
            got = step(net, batch, torch.Generator(), True)
            keys = param_keys(net.encoder.resnet_conv.arch)
            ps = dict(net.named_parameters())
            tgrads = {keys[n][0]: to_layout(ps[n].grad, keys[n][1])
                      for g in ("decoder", "encoder") for n in dual.names(g)}
            runs[mode] = {"jax": (float(out.loss), float(out.lstm_grad_norm), jgrads),
                          "port": (float(got.loss), float(got.lstm_grad_norm), tgrads)}
    finally:
        mp.undo()
    return runs


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# The int8 step's trunk gradients. JAX's cotangents and the port's differ
# by fp32 rounding (train-mode BN's backward sums in another order), which
# moves an int8 quantum here and there; each int8 dx is then requantised in
# the conv before it, so the moved quanta compound through the backward, up
# to the size of the quantisation error itself (tiny_cf, batch 4, measured
# on the CPU). Gaps are relative to each tensor's norm, and "exact gap" is
# JAX's int8 gradient's gap to its exact one. Bounds, each about twice the
# measured value:
# - the first int8 conv the backward meets (the last block's conv2): 0.1 of
#   its exact gap (measured 0.052; 1.3e-3 against 2.4e-2);
# - every trunk tensor: 1.0 of its exact gap (measured at most 0.77, in
#   layer2, the far end of the backward);
# - the port's own int8-vs-exact gap over JAX's: within [0.5, 2] (measured
#   0.88-1.04): the port's quantisation error has JAX's size.
# The tensors the backward reaches before any int8 conv (the last block's
# bn2) and the decoder's are held to the exact modes' bound.
FIRST_INT8 = "encoder|resnet|layer4|#1|conv2|kernel"
INT8_FIRST_RATIO, INT8_TRUNK_RATIO, INT8_NOISE_RATIO = 0.1, 1.0, (0.5, 2.0)


def _int8_trunk(got, want, got_exact, want_exact, first, before_int8):
    """The rules above over the trunk's {key: gradient}."""
    for k in want:
        if k in before_int8:
            continue
        exact = _rel(want[k], want_exact[k])
        assert exact > 1e-3, k  # the quantisation error shows
        ratio = INT8_FIRST_RATIO if k == first else INT8_TRUNK_RATIO
        assert _rel(got[k], want[k]) <= ratio * exact, (k, _rel(got[k], want[k]), exact)
        lo, hi = INT8_NOISE_RATIO
        assert lo * exact <= _rel(got[k], got_exact[k]) <= hi * exact, k


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(step_runs, mode):
    """One train step (encoder on, layers 2-4 fine-tuned) against JAX's
    make_train_step after set_conv_bwd_quant(mode), on the same weights,
    batch and draws: loss and LSTM grad norm within 1e-5 (relative); the
    gradients of every updated tensor within atol 1e-5 + rtol 1e-4 (the
    bound of tests/test_torch_train_step.py) in 'none' and 'manual', and
    in 'int8' the decoder's and the last block's bn2; the trunk's other
    int8 gradients by the rules above."""
    (jl, jn, jg), (tl, tn, tg) = step_runs[mode]["jax"], step_runs[mode]["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)
    moved = {k for k, v in jg.items() if np.any(v)}
    assert moved == {k for k, v in tg.items() if np.any(v)}
    assert FIRST_INT8 in moved
    trunk = {k for k in moved if "resnet" in k} if mode == "int8" else set()
    before_int8 = {k for k in trunk if k.startswith("encoder|resnet|layer4|#1|bn2")}
    for k in moved - trunk | before_int8:
        np.testing.assert_allclose(tg[k], jg[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    if mode == "int8":
        _int8_trunk({k: tg[k] for k in trunk}, {k: jg[k] for k in trunk},
                    step_runs["none"]["port"][2], step_runs["none"]["jax"][2], FIRST_INT8,
                    before_int8)


# --------------------------------------------------- data parallel, two ranks
# tests/test_torch_multiprocess.py's DP bounds: loss rtol 1e-5, weights and
# BN statistics atol 1e-5, Adam's first update taking the sign of a gradient
# within 1e-5 of 0 (up to 2 lr there); gradients atol 1e-5 + rtol 1e-4 of
# each tensor's largest value. The trunk's int8 gradients: the rules of
# test_train_step_matches_jax (the two ranks' sums run in another order than
# one process's, which moves quanta as JAX's rounding does), and so their
# weights within Adam's 2 lr of the one-process step's.
DP_LOSS_RTOL, DP_PARAM_ATOL, DP_GRAD_FLOOR = 1e-5, 1e-5, 1e-5


def _one_process_step(jcf, params, state, batch, draws, mode, monkeypatch):
    from adaptive_tpu_torch.ops import preprocess as tpre
    from adaptive_tpu_torch.training import optim as TO
    from adaptive_tpu_torch.training import step as TST

    tqc.set_conv_bwd_quant(mode)
    pcf = port_cf(jcf)
    model, net = port_model_and_net(pcf, params, state)
    monkeypatch.setattr(tpre, "draw_crop_flip", lambda *a: tuple(map(torch.from_numpy, draws)))
    out = TST.make_train_step(model, TO.make_dual_optimizer(net, pcf), pcf)(
        net, batch, torch.Generator(), True)
    grads = {k: p.grad.numpy() for k, p in net.named_parameters() if p.grad is not None}
    return pcf, float(out.loss), grads, {k: v.numpy() for k, v in net.state_dict().items()}


def test_dp_int8_step_two_ranks_equals_one(tiny_cf, tmp_path, monkeypatch):
    """One "int8" step at mesh (2, 1) over gloo, two child processes on a
    global batch of 8, against the port's one-process "int8" step on the
    same batch, weights and draws: every rank's loss, gradients, BN
    statistics and weights by the bounds above. Each rank holds half the
    rows, so only the MAX all-reduce of x's and g's amax over the data
    group gives it the one-process scales; without it the first int8 conv's
    gradient is a whole quantisation error away."""
    from tests.test_torch_train_step import _jax_draws

    jcf = tiny_cf.replace(train_batch_size=8)
    _, params, state = jax_weights(jcf)
    rng = np.random.default_rng(17)
    batch = {"images": rng.integers(0, 256, (8, 72, 72, 3), dtype=np.uint8),
             "captions": rng.integers(1, jcf.vocab_length, (8, 6)).astype(np.int32),
             "lengths": np.array([6, 3, 5, 4, 6, 2, 5, 3], np.int32)}
    draws = tuple(t.numpy() for t in _jax_draws(jax.random.PRNGKey(3), 8, 72,
                                                jcf.train_crop_size))
    payload = {"cf": port_cf(jcf, mesh_shape=(2, 1)).to_dict(), "params": (params, state),
               "batch": batch, "draws": draws, "tasks": [("step_int8", {})]}
    ranks = [r["step_int8"] for r in run_ranks(str(tmp_path), 2, payload)]

    _, _, exact, _ = _one_process_step(jcf, params, state, batch, draws, "none", monkeypatch)
    pcf, loss, grads, sd = _one_process_step(jcf, params, state, batch, draws, "int8",
                                             monkeypatch)
    first = "encoder.resnet_conv.7.1.conv2.weight"
    trunk = {k for k in grads if "resnet_conv" in k}
    before_int8 = {k for k in trunk if k.startswith("encoder.resnet_conv.7.1.bn2.")}
    assert first in trunk and len(before_int8) == 2
    lr = {"decoder": pcf.opt_rnn_adam_learning_rate, "encoder": pcf.opt_cnn_adam_learning_rate}
    for got in ranks:
        np.testing.assert_allclose(got["loss"], loss, rtol=DP_LOSS_RTOL)
        assert got["grads"].keys() == grads.keys()
        for k in grads.keys() - trunk | before_int8:
            np.testing.assert_allclose(got["grads"][k], grads[k], rtol=0, err_msg=k,
                                       atol=1e-5 + 1e-4 * np.abs(grads[k]).max())
        _int8_trunk({k: got["grads"][k] for k in trunk}, {k: grads[k] for k in trunk},
                    exact, exact, first, before_int8)
        for k, v in sd.items():
            d = np.abs(got["sd"][k] - v)
            over = d > DP_PARAM_ATOL
            if over.any():
                assert k in grads, k
                group_lr = lr["encoder" if "resnet_conv" in k else "decoder"]
                assert k in trunk or (np.abs(grads[k][over]) <= DP_GRAD_FLOOR).all(), k
                assert (d[over] <= 2 * group_lr + DP_PARAM_ATOL).all(), (k, d.max())
