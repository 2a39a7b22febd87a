"""The PyTorch port's int8 encoder against the JAX package's, on the CPU:
quantisers, integer products, the int8 carry forward (dynamic and static
scales, tensor and channel granularity, the s2d stem), calibration,
preparation, the guards, and int8 captioning end to end.

The integer products are exact and the fp32 epilogues are the same IEEE
operations in both packages, so on the same folded weights and scales the
port's features equal JAX's to the bit. Two tests fold the weights in each
package (the weight bridge's BN fold can differ by an ulp, which can flip a
weight's rounding); they use BN variances of 4^k - eps, whose rsqrt is exact,
so both folds give the same bits too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.models import infer as J
from adaptive_tpu_torch.models import infer as T
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net
from tests.torch_port_util import port_threads  # noqa: F401


def exact_bn(tree, rng, variances=(0.25, 1.0, 4.0)):
    """BN statistics and affine parameters away from their init, with
    variances whose fold is exact in both packages (var + 1e-5 = 4^k)."""
    if isinstance(tree, list):
        return [exact_bn(v, rng, variances) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"mean", "var"}:
        var = rng.choice(np.float32(variances), tree["var"].shape) - np.float32(1e-5)
        return {"mean": rng.normal(0, 0.1, tree["mean"].shape).astype(np.float32),
                "var": var.astype(np.float32)}
    if set(tree) == {"scale", "bias"}:
        return {"scale": rng.uniform(0.5, 1.5, tree["scale"].shape).astype(np.float32),
                "bias": rng.normal(0, 0.1, tree["bias"].shape).astype(np.float32)}
    return {k: exact_bn(v, rng, variances) for k, v in tree.items()}


_SETUPS = {}


def setup(tiny_cf, arch, seed=1, variances=(0.25, 1.0, 4.0), head_gain=1.0, **kw):
    """(jcf, params, state, port model, port net) with exact-fold BN; the
    encoder's affine heads scaled by head_gain."""
    key = (arch, seed, variances, head_gain, tuple(sorted(kw.items())))
    if key not in _SETUPS:
        jcf = tiny_cf.replace(encoder_backbone=arch, **kw)
        _, params, state = jax_weights(jcf, seed=seed)
        rng = np.random.default_rng(0)
        params, state = exact_bn(params, rng, variances), exact_bn(state, rng, variances)
        # each residual branch's last BN at 0.2, as trained ResNets have it:
        # with unit branches the random deep trunk grows its features by
        # orders of magnitude and turns one requant tie into a different
        # output (the port's resnet.calibrate_bn_ does the same)
        for li in range(1, 5):
            for blk in params["encoder"]["resnet"][f"layer{li}"]:
                bn = blk["bn3"] if "bn3" in blk else blk["bn2"]
                bn["scale"] = bn["scale"] * np.float32(0.2)
        enc = dict(params["encoder"])
        for name in ("affine_a", "affine_b", "affine_h0", "affine_c0"):
            enc[name] = {**enc[name], "kernel": enc[name]["kernel"] * np.float32(head_gain)}
        params = {**params, "encoder": enc}
        model, net = port_model_and_net(port_cf(jcf), params, state)
        _SETUPS[key] = (jcf, params, state, model, net)
    return _SETUPS[key]


def to_port_folded(tree):
    """A JAX folded tree (HWIO kernels) in the port's layout (OIHW,
    channels_last)."""
    if isinstance(tree, list):
        return [to_port_folded(v) for v in tree]
    if "kernel" in tree:
        k = torch.from_numpy(np.array(tree["kernel"])).permute(3, 2, 0, 1)
        return {"kernel": k.contiguous(memory_format=torch.channels_last),
                "bias": torch.from_numpy(np.array(tree["bias"]))}
    return {k: to_port_folded(v) for k, v in tree.items()}


def hwio(t):
    return np.asarray(t.permute(2, 3, 1, 0))


def images(n, size, seed=3):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


# ------------------------------------------------------------- quantisers
def test_quantizers_match_jax():
    rng = np.random.default_rng(0)
    k = rng.normal(0, 0.3, (3, 3, 24, 16)).astype(np.float32)  # HWIO
    wj, sj = J._quant_w(jnp.asarray(k))
    wt, st = T._quant_w(torch.from_numpy(k).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(hwio(wt), np.asarray(wj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))

    x = rng.normal(0, 2, (2, 5, 5, 8)).astype(np.float32)
    for scale in (None, 0.0371):
        xj, sxj = J._quant_x(jnp.asarray(x), scale)
        xt, sxt = T._quant_x(torch.from_numpy(x), scale)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert np.float32(sxt) == np.float32(sxj)

    # requant at exact ties: y / s = n + 0.5 rounds half to even in both
    s = 0.25
    y = (np.arange(-300, 300, dtype=np.float32) + 0.5) * s
    y = np.concatenate([y, rng.normal(0, 20, 1000).astype(np.float32)])
    want = np.asarray(J._requant(jnp.asarray(y), s))
    got = T._requant(torch.from_numpy(y), s).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and {-127, 127} <= set(got.tolist())
    vec = rng.uniform(0.01, 0.1, 8).astype(np.float32)
    np.testing.assert_array_equal(T._requant(torch.from_numpy(x), vec).numpy(),
                                  np.asarray(J._requant(jnp.asarray(x), jnp.asarray(vec))))


def test_s2d_and_stem_kernel_match_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (2, 8, 6, 3)).astype(np.int8)
    np.testing.assert_array_equal(T._s2d(torch.from_numpy(x)).numpy(), np.asarray(J._s2d(jnp.asarray(x))))
    k = rng.normal(size=(7, 7, 3, 16)).astype(np.float32)
    want = np.asarray(J._stem_s2d_kernel(jnp.asarray(k)))
    got = T._stem_s2d_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert got.shape == (16, 12, 4, 4)
    np.testing.assert_array_equal(hwio(got), want)


@pytest.mark.parametrize("case", ["1x1", "3x3s2", "stem7x7", "stem_s2d", "1x1s2_channel"])
def test_acc_i8_matches_jax(case):
    """The int32 accumulator and its fp32 scale equal JAX's exactly."""
    rng = np.random.default_rng(2)
    kh, cin, cout, stride, pad, size = {
        "1x1": (1, 16, 24, 1, None, 6), "3x3s2": (3, 8, 16, 2, None, 7),
        "stem7x7": (7, 3, 16, 2, ((3, 3), (3, 3)), 12), "stem_s2d": (4, 12, 16, 1, ((2, 1), (2, 1)), 6),
        "1x1s2_channel": (1, 16, 8, 2, None, 6)}[case]
    x = rng.integers(-127, 128, (2, size, size, cin)).astype(np.int8)
    k = rng.normal(0, 0.3, (kh, kh, cin, cout)).astype(np.float32)
    s = rng.uniform(0.01, 0.1, cin).astype(np.float32) if case.endswith("channel") else 0.021
    acc_j, sc_j = J._acc_i8(jnp.asarray(x), jnp.asarray(k), s, stride,
                            None if pad is None else list(pad))
    acc_t, sc_t = T._acc_i8(torch.from_numpy(x), torch.from_numpy(k).permute(3, 2, 0, 1), s,
                            stride, pad)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))


# ------------------------------------------------------- the int8 forward
_CALIB = {}


def jax_scales(tiny_cf, arch, gran, size):
    key = (arch, gran, size)
    if key not in _CALIB:
        _, params, state, _, _ = setup(tiny_cf, arch)
        _CALIB[key] = J.calibrate_int8(params["encoder"], state, jnp.asarray(images(2, size)),
                                       arch, granularity=gran)
    return _CALIB[key]


FORWARD_CASES = [  # (scales, granularity, s2d, input size)
    ("static", "tensor", False, 64), ("static", "channel", True, 64),
    ("static", "tensor", True, 63), ("static", "channel", False, 63), ("dynamic", None, False, 64),
]


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("scales,gran,s2d,size", FORWARD_CASES)
def test_int8_forward_matches_jax(tiny_cf, arch, scales, gran, s2d, size):
    """resnet_apply_folded_int8 on JAX's folded weights and JAX's scales
    equals JAX's to the bit (63 px: the s2d stem falls back to 7x7)."""
    _, params, state, _, _ = setup(tiny_cf, arch)
    x = images(2, size)
    sc = jax_scales(tiny_cf, arch, gran, size) if scales == "static" else None
    folded = J.fold_resnet(params["encoder"]["resnet"], state["resnet"], arch)
    want = np.asarray(J.resnet_apply_folded_int8(folded, jnp.asarray(x), arch, sc, stem_s2d=s2d))
    got = T.resnet_apply_folded_int8(to_port_folded(folded), torch.from_numpy(x), arch, sc,
                                     stem_s2d=s2d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(want).max() > 1.0 and (want > 0).mean() > 0.2  # not a degenerate trunk
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("gran", ["tensor", "channel"])
def test_calibrate_int8_matches_jax(tiny_cf, gran):
    """Scales from the port's own fold and fp32 forward: within 1e-5 of the
    conv's largest scale (a channel's max-abs moves with the fp32 sums'
    order at the scale of the layer, not of the channel)."""
    arch = "resnet50"
    _, _, _, _, net = setup(tiny_cf, arch)
    want = jax_scales(tiny_cf, arch, gran, 64)
    got = T.calibrate_int8(net.encoder, torch.from_numpy(images(2, 64)), arch, granularity=gran)
    assert set(got) == set(want) and any(k.endswith("downsample_out") for k in got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert type(got[k]) is (float if gran == "tensor" else np.ndarray), k
        assert g.shape == w.shape and (g.dtype == np.float32 or gran == "tensor")
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k


def test_calibrate_int8_bias_matches_jax(tiny_cf):
    """Bias corrections on the same scales. The fp32 means are sums in
    another order, and each correction feeds every conv after it, where an
    ulp can move a requant tie and so a channel's mean: on 2 images the
    packages part by ~1e-6 at the stem and by up to ~1 at layer4. So the
    comparison is held where the chain starts (the stem and layer1, within
    1e-4), the rest by calibrate_int8_bias's defining invariant with the JAX
    package's bound (tests/test_int8.py::test_bias_correction_matches_fp_means):
    with the port's corrections folded in, a second pass finds every conv's
    mean error below 0.05 of its mean magnitude + 1e-3. And JAX's own
    corrections give JAX's features to the bit in the port's forward."""
    arch = "resnet18"
    _, params, state, _, net = setup(tiny_cf, arch)
    x = images(2, 64)
    scales = jax_scales(tiny_cf, arch, "channel", 64)
    want = J.calibrate_int8_bias(params["encoder"], state, jnp.asarray(x), arch, scales)
    got = T.calibrate_int8_bias(net.encoder, torch.from_numpy(x), arch, scales)
    assert set(got) == set(want) == {k for k in scales if not k.endswith("downsample_out")}
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        if k == "conv1" or k.startswith("layer1."):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)

    folded = T.fold_resnet(net.encoder.resnet_conv)
    xt = torch.from_numpy(x)
    means = {}

    def conv(name, xx, p, stride, pad):
        y = T._plain_conv(name, xx, p, stride, pad)
        means[name] = y.mean(dim=(0, 1, 2))
        return y

    T._folded_forward(folded, xt, arch, conv)
    residual = {}
    T._resnet_int8_carry(folded, xt, arch, scales, bias_corr=got, fp_means=means,
                         collect_into=residual)
    for k, v in residual.items():
        assert float(v.abs().max()) < 0.05 * float(means[k].abs().mean()) + 1e-3, k

    jfold = J.fold_resnet(params["encoder"]["resnet"], state["resnet"], arch)
    ref = J.resnet_apply_folded_int8(jfold, jnp.asarray(x), arch, scales, bias_corr=want)
    out = T.resnet_apply_folded_int8(to_port_folded(jfold), xt, arch, scales, bias_corr=want)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_calibrate_rejects_bad_granularity(tiny_cf):
    _, _, _, _, net = setup(tiny_cf, "resnet18")
    with pytest.raises(ValueError, match="must be tensor|channel"):
        T.calibrate_int8(net.encoder, torch.zeros(1, 64, 64, 3), "resnet18", granularity="row")


# ------------------------------------------------------------ preparation
@pytest.mark.parametrize("bias_correct", [False, True])
@pytest.mark.parametrize("s2d", [False, True])
def test_prepared_matches_inline(tiny_cf, bias_correct, s2d):
    """Weights quantised once (prepare_encoder_inference) give the inline
    path's features to the bit, bias corrections folded in or not."""
    arch = "resnet18"
    _, _, _, model, net = setup(tiny_cf, arch)
    x = torch.from_numpy(images(2, 64))
    scales = T.calibrate_int8(net.encoder, x, arch, granularity="channel")
    corr = T.calibrate_int8_bias(net.encoder, x, arch, scales) if bias_correct else None
    kw = dict(quant="int8", scales=scales, stem_s2d=s2d, bias_corr=corr)
    inline = T.encoder_apply_inference(net.encoder, x, arch, torch.float32, **kw)
    prepared = T.prepare_encoder_inference(net.encoder, torch.float32, "int8", scales=scales,
                                           stem_s2d=s2d, bias_corr=corr)
    assert prepared["resnet"]["conv1"]["wq"].shape[-1] == (4 if s2d else 7)
    hoisted = T.encoder_apply_inference(None, x, arch, torch.float32, prepared=prepared, **kw)
    for a, b in zip(inline, hoisted):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- guards
def _raises_like_jax(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("guard", ["overlap", "channel_fused", "bias_corr_fused",
                                   "dynamic_fused", "missing_scales"])
def test_guards_match_jax(tiny_cf, guard):
    arch = "resnet50"
    _, params, state, _, _ = setup(tiny_cf, arch)
    folded = J.fold_resnet(params["encoder"]["resnet"], state["resnet"], arch)
    tfolded = to_port_folded(folded)
    x = images(1, 64)
    scales = {"tensor": jax_scales(tiny_cf, arch, "tensor", 64),
              "channel": jax_scales(tiny_cf, arch, "channel", 64)}
    kw = {
        "overlap": dict(scales=scales["tensor"], fused_layers=("layer2",),
                        fused_tails=("layer2", "layer3")),
        "channel_fused": dict(scales=scales["channel"], fused_layers=("layer3",)),
        "bias_corr_fused": dict(scales=scales["tensor"], fused_tails=("layer3",),
                                bias_corr={"conv1": np.zeros(64, np.float32)}),
        "dynamic_fused": dict(scales=None, fused_layers=("layer1",)),
        "missing_scales": dict(scales={"conv1": 0.1}),
    }[guard]
    _raises_like_jax(
        lambda: J.resnet_apply_folded_int8(folded, jnp.asarray(x), arch, **kw),
        lambda: T.resnet_apply_folded_int8(tfolded, torch.from_numpy(x), arch, **kw))


def test_prepared_stem_guards_match_jax(tiny_cf):
    """A prepared stem whose s2d rewrite disagrees with the flag, or an
    s2d-prepared stem given an odd input, raises as in JAX."""
    arch = "resnet18"
    _, params, state, _, net = setup(tiny_cf, arch)
    sc = jax_scales(tiny_cf, arch, "tensor", 64)
    for prep_s2d, run_s2d, size in ((True, False, 64), (False, True, 64), (True, True, 63)):
        pj = J.prepare_encoder_inference(params["encoder"], state, arch, jnp.float32, "int8",
                                         sc, stem_s2d=prep_s2d)
        pt = T.prepare_encoder_inference(net.encoder, torch.float32, "int8", sc, stem_s2d=prep_s2d)
        x = images(1, size)
        _raises_like_jax(
            lambda: J.resnet_apply_folded_int8(pj["resnet"], jnp.asarray(x), arch, sc,
                                               stem_s2d=run_s2d),
            lambda: T.resnet_apply_folded_int8(pt["resnet"], torch.from_numpy(x), arch, sc,
                                               stem_s2d=run_s2d))


def test_config_and_model_guards_match_jax(tiny_cf):
    from adaptive_tpu.config.config import _validate
    from adaptive_tpu.models.factory import build_model as jax_build
    from adaptive_tpu_torch.models import build_model

    for kw in (dict(encoder_quant="int4"), dict(encoder_quant_granularity="row")):
        _raises_like_jax(lambda: _validate(tiny_cf.replace(**kw)), lambda: port_cf(tiny_cf, **kw))
    cf = tiny_cf.replace(encoder_quant="int8", train_crop_size=63)
    jm = jax_build(cf)._replace(int8_stem_s2d=True)
    tm = build_model(port_cf(cf), device="cpu")._replace(int8_stem_s2d=True)
    _raises_like_jax(jm._resolved_fusion, tm._resolved_fusion)
    assert tm._replace(int8_stem_s2d="auto")._resolved_fusion() == ((), (), False)
    assert build_model(port_cf(tiny_cf, encoder_quant="int8"), device="cpu")._resolved_fusion() \
        == ((), (), True)


# ------------------------------------------------------------- end to end
def decode_setup(tiny_cf, gran, variances=(4.0, 16.0, 64.0), seed=1, head_gain=0.1):
    # larger BN variances and smaller heads keep the random model's decoder
    # inputs small enough that the captions change from step to step and
    # the fp32 decoders of the two packages stay close
    return setup(tiny_cf, "resnet18", seed=seed, variances=variances, head_gain=head_gain,
                 vocab_length=37,
                 vocab_pad_multiple=8, decode_max_len=6, encoder_quant="int8",
                 encoder_quant_granularity=gran, use_pallas="always")


DECODE_IMAGES = np.random.default_rng(11).integers(0, 255, (3, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("decoder", ["greedy", "beam3"])
@pytest.mark.parametrize("gran", ["tensor", "channel"])
def test_int8_decode_matches_jax(tiny_cf, monkeypatch, decoder, gran):
    """build_model(encoder_quant='int8') -> calibrate_model -> greedy or
    beam-3 decode against the JAX package's. calibrate_model's scales are
    within 1e-5 of each conv's largest JAX scale; the decode then runs on
    JAX's scales (an ulp of a scale can move a requant tie) with images at
    the crop size (no resize, whose filter rounds differently), so the
    features are the same bits: equal ids; attention and beam scores within
    2e-4, the bound of tests/test_torch_beam.py (the fp32 decoder's sums in
    another order)."""
    from jax.experimental.pallas import tpu as pltpu

    from adaptive_tpu.decoding import beam as jbeam
    from adaptive_tpu.decoding import greedy as jgreedy
    from adaptive_tpu.decoding import spmd
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    jcf, params, state, model, net = decode_setup(tiny_cf, gran)
    imgs = DECODE_IMAGES
    jm = J.calibrate_model(jax_weights(jcf, seed=1)[0], jcf, params, state, imgs)
    pcf = port_cf(jcf)
    assert model.encoder_quant == "int8" and model.int8_scales is None
    calibrated = T.calibrate_model(model, pcf, net, imgs)
    assert set(calibrated.int8_scales) == set(jm.int8_scales)
    assert calibrated.int8_bias_corr is None
    for k, w in jm.int8_scales.items():
        w, g = np.asarray(w), np.asarray(calibrated.int8_scales[k])
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
    model = calibrated._replace(int8_scales=jm.int8_scales)
    with monkeypatch.context() as m:
        m.setattr(spmd, "decode_mesh", lambda *_: None)  # single-device program
        with pltpu.force_tpu_interpret_mode():
            if decoder == "greedy":
                want = jgreedy.make_greedy_decoder(jm, jcf)(params, state, jnp.asarray(imgs))
            else:
                want = jbeam.make_beam_decoder(jm, jcf, beam_size=3)(params, state, jnp.asarray(imgs))
    if decoder == "greedy":
        got = make_greedy_decoder(model, pcf)(net, imgs)
    else:
        got = make_beam_decoder(model, pcf, beam_size=3)(net, imgs)
        np.testing.assert_array_equal(got.all_ids.numpy(), np.asarray(want.all_ids))
        np.testing.assert_allclose(got.all_scores.numpy(), np.asarray(want.all_scores), atol=2e-4)
    assert len(np.unique(np.asarray(want.ids))) > 2  # not a degenerate caption
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention), atol=2e-4)
