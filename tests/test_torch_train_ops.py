"""The PyTorch port's training ops against the JAX package's on the same
seeded numpy inputs: the masked cross-entropy, the LSTM-only clip,
lstm_scan, train-mode BN (output, running statistics, gradient against
JAX's custom_vjp), the augmentation fed JAX's own draws, dropout's
semantics, the schedulers, the config checks and the metric writer. Each
test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.models import resnet as JR
from adaptive_tpu.ops import lstm as jlstm
from adaptive_tpu.ops import preprocess as jpre
from adaptive_tpu.training import schedule as JS
from adaptive_tpu.training import step as JST
from adaptive_tpu_torch.config import Config
from adaptive_tpu_torch.models import resnet as TR
from adaptive_tpu_torch.ops import dropout as TD
from adaptive_tpu_torch.ops import lstm as tlstm
from adaptive_tpu_torch.ops import preprocess as tpre
from adaptive_tpu_torch.training import schedule as TS
from adaptive_tpu_torch.training import step as TST
from tests.torch_port_util import port_threads  # noqa: F401


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("vocab_pad", [0, 8])
def test_masked_ce_sum_and_mean_match_jax(vocab_pad):
    """Sum, count and mean against JAX within 1e-6 (relative), with some
    columns at the padded vocab's finfo.min."""
    rng = np.random.default_rng(1)
    B, T, V = 4, 7, 24
    scores = rng.normal(size=(B, T, V)).astype(np.float32) * 3
    if vocab_pad:
        scores[..., -vocab_pad:] = np.finfo(np.float32).min
    caps = rng.integers(1, V - vocab_pad, (B, T)).astype(np.int32)
    lens = np.array([7, 2, 5, 1], np.int32)
    js, jn = JST.masked_ce_sum(jnp.asarray(scores), jnp.asarray(caps), jnp.asarray(lens))
    ts, tn = TST.masked_ce_sum(torch.from_numpy(scores), torch.from_numpy(caps),
                               torch.from_numpy(lens))
    assert int(tn) == int(jn) == 6 + 1 + 4 + 0
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    jl = JST.masked_ce_loss(jnp.asarray(scores), jnp.asarray(caps), jnp.asarray(lens))
    tl = TST.masked_ce_loss(torch.from_numpy(scores), torch.from_numpy(caps),
                            torch.from_numpy(lens))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_masked_ce_ignores_padding():
    """Scores and tokens past a caption's length change nothing (exact)."""
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.normal(size=(2, 6, 10)).astype(np.float32))
    caps = torch.from_numpy(rng.integers(1, 10, (2, 6)).astype(np.int64))
    lens = torch.tensor([4, 6])
    a = TST.masked_ce_sum(scores, caps, lens)
    scores2, caps2 = scores.clone(), caps.clone()
    scores2[0, 3:] = 100.0
    caps2[0, 4:] = 0
    b = TST.masked_ce_sum(scores2, caps2, lens)
    assert float(a[0]) == float(b[0]) and int(a[1]) == int(b[1])


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_lstm_grads_matches_jax(scale):
    """Norm and clipped grads against JAX within 1e-6 (relative), below and
    above max_norm 5."""
    rng = np.random.default_rng(3)
    shapes = {"w_ih": (6, 16), "w_hh": (4, 16), "b_ih": (16,), "b_hh": (16,)}
    g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
    jg, jn = JST.clip_lstm_grads({"decoder": {"lstm": {k: jnp.asarray(v) for k, v in g.items()}}},
                                 5.0)
    tg = [torch.from_numpy(g[k].copy()) for k in shapes]
    tn = TST.clip_lstm_grads(tg, 5.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k, t in zip(shapes, tg):
        np.testing.assert_allclose(_np(t), np.asarray(jg["decoder"]["lstm"][k]), rtol=1e-6,
                                   atol=1e-9)


def test_lstm_scan_matches_jax():
    """Hiddens, per-step cells and the final state within 1e-5."""
    rng = np.random.default_rng(4)
    B, T, I, H = 3, 5, 6, 8
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = {"w_ih": f(I, 4 * H), "w_hh": f(H, 4 * H) * 0.3, "b_ih": f(4 * H) * 0.1,
         "b_hh": f(4 * H) * 0.1}
    xs, h0, c0 = f(B, T, I), f(B, H), f(B, H)
    jh, jc, (jhT, jcT) = jlstm.lstm_scan({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    th, tc, (thT, tcT) = tlstm.lstm_scan({k: torch.from_numpy(v) for k, v in p.items()},
                                         torch.from_numpy(xs),
                                         (torch.from_numpy(h0), torch.from_numpy(c0)))
    for t, j in ((th, jh), (tc, jc), (thT, jhT), (tcT, jcT)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=0)


# ------------------------------------------------------------ train-mode BN
def test_train_bn_matches_jax_custom_vjp():
    """F.batch_norm(training=True) against JAX's _bn(train=True): output,
    the new running mean and unbiased variance, and the gradients of x,
    scale and bias (JAX's custom_vjp) within 1e-5."""
    rng = np.random.default_rng(5)
    N, Hh, W, C = 4, 5, 5, 6
    x = (rng.normal(size=(N, Hh, W, C)) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.normal(size=C).astype(np.float32), rng.normal(size=C).astype(np.float32)
    mean, var = rng.normal(size=C).astype(np.float32), rng.uniform(0.5, 2, C).astype(np.float32)
    dy = rng.normal(size=(N, Hh, W, C)).astype(np.float32)

    def jf(x_, s_, b_):
        y, st = JR._bn(x_, {"scale": s_, "bias": b_},
                       {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}, True)
        return y, st

    (jy, jst), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, jst)))

    bn = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ty = TR._bn(tx, bn, True)
    ty.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    close = lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)  # noqa
    close(_np(ty.permute(0, 2, 3, 1)), jy)
    close(_np(bn.running_mean), jst["mean"])
    close(_np(bn.running_var), jst["var"])
    close(_np(tx.grad.permute(0, 2, 3, 1)), jdx)
    close(_np(bn.weight.grad), jds)
    close(_np(bn.bias.grad), jdb)


def test_finetune_mask_names_layer2_to_4():
    assert [n for n, on in TR.finetune_mask(5).items() if on] == ["layer2", "layer3", "layer4"]
    assert TR.CHILD_NAMES == JR.CHILD_NAMES
    assert [n for n, on in TR.finetune_mask(0).items() if on] == [
        "conv1", "bn1", "layer1", "layer2", "layer3", "layer4"]


# --------------------------------------------------------------- augmentation
@pytest.mark.parametrize("crop", [64, 50])
def test_crop_flip_matches_jax_on_its_draws(crop):
    """crop_flip on JAX's own draws (split(key, 3), randint, bernoulli)
    equals random_crop_flip exactly, and normalize after it
    train_preprocess within 1e-6."""
    rng = np.random.default_rng(6)
    B, S = 6, 64 if crop == 64 else 72
    images = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    tops = np.array(jax.random.randint(k1, (B,), 0, S - crop + 1))
    lefts = np.array(jax.random.randint(k2, (B,), 0, S - crop + 1))
    flips = np.array(jax.random.bernoulli(k3, 0.5, (B,)))
    want = np.asarray(jpre.random_crop_flip(key, jnp.asarray(images), crop))
    got = tpre.crop_flip(torch.from_numpy(images), torch.from_numpy(tops),
                         torch.from_numpy(lefts), torch.from_numpy(flips), crop)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_allclose(
        _np(tpre.normalize(got)),
        np.asarray(jpre.train_preprocess(key, jnp.asarray(images), crop)), atol=1e-6, rtol=0)


def test_draws_and_center_crop():
    """draw_crop_flip's ranges and coin; center_crop equals JAX's (exact)."""
    gen = torch.Generator().manual_seed(0)
    tops, lefts, flips = tpre.draw_crop_flip(gen, 4000, 72, 80, 64)
    assert int(tops.min()) == 0 and int(tops.max()) == 8
    assert int(lefts.min()) == 0 and int(lefts.max()) == 16
    assert flips.dtype == torch.bool and abs(float(flips.float().mean()) - 0.5) < 0.05
    images = np.random.default_rng(7).integers(0, 256, (2, 72, 72, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_np(tpre.center_crop(torch.from_numpy(images), 64)),
                                  np.asarray(jpre.center_crop(jnp.asarray(images), 64)))


# ------------------------------------------------------------------ dropout
def test_dropout_inactive_and_bad_rate():
    assert TD.make_dropout(None, 0.5) is None
    assert TD.make_dropout(torch.Generator(), 0.0) is None
    x = torch.ones(3, 4)
    assert TD.maybe_drop(None, x) is x
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError):
            TD.make_dropout(torch.Generator(), rate)


def test_inverted_dropout_semantics():
    """Survivors carry exactly 1/keep, keep frequency ~0.5, expectation
    kept; each call draws a fresh mask; the same seed the same masks; the
    dtype is kept."""
    drop = TD.make_dropout(torch.Generator().manual_seed(42), 0.5)
    y = _np(drop(torch.ones(256, 256)))
    kept = y != 0.0
    np.testing.assert_allclose(y[kept], 2.0, rtol=1e-6)
    assert abs(kept.mean() - 0.5) < 0.02 and abs(y.mean() - 1.0) < 0.05
    x = torch.ones(64, 64)
    assert (_np(drop(x)) != _np(drop(x))).any()
    a = TD.make_dropout(torch.Generator().manual_seed(3), 0.3)(torch.ones(32, 32))
    b = TD.make_dropout(torch.Generator().manual_seed(3), 0.3)(torch.ones(32, 32))
    np.testing.assert_array_equal(_np(a), _np(b))
    assert drop(torch.ones(8, 8, dtype=torch.bfloat16)).dtype == torch.bfloat16


# ---------------------------------------------------------- schedule, config
def test_plateau_and_early_stop_equal_jax():
    """The same losses give the same learning rates and stops (==)."""
    losses = [100, 3.0, 2.99, 2.98, 2.97, 2.96, 2.5, 2.49, 2.48, 2.47, 2.46, 2.45]
    js, ts = JS.ReduceLROnPlateau(1e-3, min_lr=1e-6), TS.ReduceLROnPlateau(1e-3, min_lr=1e-6)
    assert [js.step(v) for v in losses] == [ts.step(v) for v in losses]
    from adaptive_tpu.config import Config as JConfig

    for hist, best in (([0.1, 0.2], 0.2), ([0.1, 0.2, 0.15, 0.18], 0.2),
                       ([0.2, 0.1, 0.15, 0.18], 0.2)):
        kw = dict(train_early_stop=True, train_early_stop_patience=2)
        assert JS.early_stop_Ornot(JConfig(**kw), hist, best) == TS.early_stop_Ornot(
            Config(**kw), hist, best)


def test_config_training_checks():
    """The JAX _validate checks of the training knobs; lbfgs is accepted
    (training/lbfgs.py), but not with accumulation."""
    for kw in ({"opt_rnn_optimization": "rmsprop"}, {"train_dropout_rate": 1.0},
               {"train_grad_accum_steps": 0}, {"train_batch_size": 6, "train_grad_accum_steps": 4}):
        with pytest.raises(ValueError):
            Config(**kw)
    with pytest.raises(NotImplementedError, match="not supported with lbfgs"):
        Config(opt_cnn_optimization="lbfgs", train_grad_accum_steps=2)
    assert Config(opt_rnn_optimization="lbfgs").opt_rnn_lbfgs_max_iter == 20
    cf = Config(train_batch_size=6, train_grad_accum_steps=3, train_dropout_rate=0.5)
    assert cf.opt_fine_tune_cnn_start_layer == 5 and cf.train_lstm_maxnormal == 5.0


def test_metric_writer_and_hms(tmp_path):
    """JSONL lines as the JAX writer's; histograms under JAX's names and
    layouts, the resnet skipped; HMS equal."""
    import json

    from adaptive_tpu.utils.logging import HMS as JHMS
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.utils.logging import HMS, MetricWriter

    assert HMS(3725.4) == JHMS(3725.4) == "1h:02m:05s"
    cf = Config(encoder_backbone="resnet18", train_crop_size=64, vocab_length=32,
                adaptive_word_embed_size=8, adaptive_lstm_hidden_size=16)
    net = build_model(cf, device="cpu").init(0)
    w = MetricWriter(str(tmp_path))
    w.add_scalars("lr", {"decoder": 1e-3}, 2)
    w.add_param_histograms(net, 0)
    w.close()
    s = [json.loads(line) for line in open(tmp_path / "scalars.jsonl")]
    assert (s[0]["tag"], s[0]["value"], s[0]["step"]) == ("lr/decoder", 1e-3, 2)
    h = {json.loads(line)["tag"]: json.loads(line) for line in open(tmp_path / "histograms.jsonl")}
    assert "Weights_decoder/lstm/w_ih" in h and "Weights_encoder/affine_h0/kernel" in h
    assert not any("resnet" in k for k in h)
    w_ih = net.decoder.LSTM.weight_ih_l0.detach().numpy()
    assert h["Weights_decoder/lstm/w_ih"]["max"] == pytest.approx(float(w_ih.max()))
