"""The PyTorch port's teacher-forced model and train step against the JAX
package's on the same weights and batch (tests/conftest.py::tiny_cf:
ResNet-18 at 64 px, vocab 32, E 8, H 16), dropout 0: scores and BN state,
one and two train steps with the encoder off and on, adam and sgd, gradient
accumulation, the optimizer groups, and checkpoints read both ways. The
port's crop/flip draws are JAX's own for the step key (draw_crop_flip
patched), since the two packages draw different random numbers by design.
Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.models import decoders as JD
from adaptive_tpu.ops.preprocess import train_preprocess as j_train_preprocess
from adaptive_tpu.training import checkpoint as JC
from adaptive_tpu.training import optim as JO
from adaptive_tpu.training import step as JST
from adaptive_tpu_torch.models import decoders as TD
from adaptive_tpu_torch.models.jax_params import param_keys, to_jax, to_layout
from adaptive_tpu_torch.ops import preprocess as tpre
from adaptive_tpu_torch.training import checkpoint as TC
from adaptive_tpu_torch.training import optim as TO
from adaptive_tpu_torch.training import step as TST
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net
from tests.torch_port_util import default_threads, port_threads  # noqa: F401

B, T, S = 4, 6, 72
SCORE_ATOL = 3e-4  # the full-model bound (tests/test_full_model_parity.py:146)
STATE_ATOL = 1e-5  # BN running statistics
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_ATOL = 2e-6  # weights after the optimizer steps (lr 1e-3 / 5e-2 moves)
LOSS_RTOL = 1e-5
STEP_SEEDS = (21, 22)  # PRNGKeys of the two steps of test_train_step_matches_jax


@pytest.fixture(scope="module")
def setup(tiny_cf):
    """JAX's init from PRNGKey(0) (BN at its identity statistics) and a
    batch of 4 seeded 72 px images with captions of lengths 6, 3, 5, 4."""
    jcf = tiny_cf.replace(train_batch_size=B)
    _, params, state = jax_weights(jcf)
    rng = np.random.default_rng(7)
    batch = {
        "images": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "captions": rng.integers(1, jcf.vocab_length, (B, T)).astype(np.int32),
        "lengths": np.array([6, 3, 5, 4], np.int32),
    }
    return jcf, params, state, batch


def _jax_draws(key, n, size, crop):
    k1, k2, k3 = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.randint(k1, (n,), 0, size - crop + 1))),
            torch.from_numpy(np.array(jax.random.randint(k2, (n,), 0, size - crop + 1))),
            torch.from_numpy(np.array(jax.random.bernoulli(k3, 0.5, (n,)))))


def _patch_draws(monkeypatch, keys, crop):
    """The port's draws: JAX's for keys[0], keys[1], ... in call order."""
    it = iter(keys)

    def draws(gen, n, height, width, crop_):
        assert crop_ == crop and height == width
        return _jax_draws(next(it), n, height, crop)

    monkeypatch.setattr(tpre, "draw_crop_flip", draws)


def _flat_jax(params, state=None):
    tree = {"params": params} if state is None else {"params": params, "state": state}
    return {k: np.asarray(v) for k, v in JC._flatten(tree).items()}


def _close(got, want, atol, rtol=0.0, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=f"{what} {k}")


def _jax_copy(tree):
    return jax.tree.map(lambda a: jnp.array(a), tree)


# ------------------------------------------------------------ teacher forcing
def test_decoder_forward_matches_jax(setup):
    """decoder_forward's scores, alpha and beta on the same V, v_g, h0, c0
    and captions within 3e-4."""
    jcf, params, state, batch = setup
    model, net = port_model_and_net(port_cf(jcf), params, state)
    rng = np.random.default_rng(8)
    K, Hd, E = model.spec.num_slots, jcf.adaptive_lstm_hidden_size, jcf.adaptive_word_embed_size
    V, v_g = np.abs(rng.normal(size=(B, K, Hd))).astype(np.float32), rng.normal(size=(B, E))
    h0, c0 = np.tanh(rng.normal(size=(2, B, Hd))).astype(np.float32)
    v_g = v_g.astype(np.float32)
    from adaptive_tpu.models.factory import build_model as jbuild

    jm = jbuild(jcf)
    want = JD.decoder_forward(jax.tree.map(jnp.asarray, params["decoder"]), jm.spec,
                              jnp.asarray(V), jnp.asarray(v_g), jnp.asarray(batch["captions"]),
                              jnp.asarray(h0), jnp.asarray(c0))
    got = TD.decoder_forward(TD.decoder_params(net.decoder, detach=False), model.spec,
                             *map(torch.from_numpy, (V, v_g, batch["captions"], h0, c0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("train", [True, False])
def test_model_forward_matches_jax(setup, train):
    """model.forward's scores within 3e-4 and, in train mode, the new BN
    running statistics within 1e-5 of JAX's forward (eval mode leaves them
    as they were, in both)."""
    jcf, params, state, batch = setup
    from adaptive_tpu.models.factory import build_model as jbuild

    jm = jbuild(jcf)
    images = np.random.default_rng(9).normal(size=(B, 64, 64, 3)).astype(np.float32)
    js, _, jst = jm.forward(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                            jnp.asarray(images), jnp.asarray(batch["captions"]), train=train)
    model, net = port_model_and_net(port_cf(jcf), params, state)
    with torch.no_grad():
        ts, _ = model.forward(net, torch.from_numpy(images), torch.from_numpy(batch["captions"]),
                              train=train)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL, rtol=0)
    _, tstate = to_jax(net.state_dict(), model.arch)
    _close(TC.flatten_tree(tstate), {k: np.asarray(v) for k, v in JC._flatten(jst).items()},
           STATE_ATOL, what="BN state")


def test_eval_loss_matches_jax(setup):
    """make_eval_loss_step (eval-mode BN, masked mean CE) against JAX's
    within 3e-4; the BN statistics stay as they were."""
    jcf, params, state, batch = setup
    from adaptive_tpu.models.factory import build_model as jbuild

    images = np.random.default_rng(10).normal(size=(B, 64, 64, 3)).astype(np.float32)
    args = (batch["captions"], batch["lengths"])
    want = JST.make_eval_loss_step(jbuild(jcf), jcf)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(images), *map(jnp.asarray, args))
    pcf = port_cf(jcf)
    model, net = port_model_and_net(pcf, params, state)
    before = TC._model_flat(net)
    got = TST.make_eval_loss_step(model, pcf)(net, torch.from_numpy(images),
                                              *map(torch.from_numpy, args))
    assert abs(float(got) - float(want)) <= SCORE_ATOL
    _close(TC._model_flat(net), before, 0.0, what="unchanged")


# ------------------------------------------------------------------- the step
def _port_setup(jcf, params, state, **kw):
    pcf = port_cf(jcf, **kw)
    model, net = port_model_and_net(pcf, params, state)
    dual = TO.make_dual_optimizer(net, pcf)
    return pcf, model, net, dual, TST.make_train_step(model, dual, pcf)


def _jax_grads(jcf, jm, params, state, batch, key, encoder_on):
    """The JAX step's gradients after its division and clip (its
    grads_full, rebuilt outside the jitted step)."""
    def f(p):
        if not encoder_on:
            p = {**p, "encoder": {**p["encoder"],
                                  "resnet": jax.lax.stop_gradient(p["encoder"]["resnet"])}}
        imgs = j_train_preprocess(key, jnp.asarray(batch["images"]), jcf.train_crop_size,
                                  jm.compute_dtype)
        scores, _, _ = jm.forward(p, state, imgs, jnp.asarray(batch["captions"]), train=True)
        return JST.masked_ce_sum(scores, jnp.asarray(batch["captions"]),
                                 jnp.asarray(batch["lengths"]))

    (_, n), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jax.tree.map(jnp.asarray, params))
    g = jax.tree.map(lambda a: a / jnp.maximum(n, 1), g)
    return JST.clip_lstm_grads(g, jcf.train_lstm_maxnormal)[0]


@pytest.fixture(scope="module")
def jax_grads(setup):
    """The JAX step's gradients for the first step key, encoder on (the
    decoder group's equal those with the encoder off: the same forward,
    and stop_gradient only cuts the ResNet's)."""
    jcf, params, state, batch = setup
    from adaptive_tpu.models.factory import build_model as jbuild

    key = jax.random.PRNGKey(STEP_SEEDS[0])
    return _flat_jax(_jax_grads(jcf, jbuild(jcf), params, state, batch, key, True))


def _port_grads(net, dual, groups):
    keys = param_keys(net.encoder.resnet_conv.arch)
    params = dict(net.named_parameters())
    return {keys[n][0]: to_layout(params[n].grad, keys[n][1])
            for g in groups for n in dual.names(g)}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("encoder_on", [False, True])
def test_train_step_matches_jax(setup, jax_grads, monkeypatch, opt, encoder_on):
    """Two steps of make_train_step against JAX's on the same weights,
    batch and draws. Both steps: loss within 1e-5 (relative), LSTM grad
    norm within 1e-5 (relative). After the first: the gradients of both
    groups within atol 1e-5 + rtol 1e-4 (adam runs), the BN statistics
    within 1e-5 and every weight within 2e-6, except that adam's update
    lr * g / (|g| + eps) takes the sign of a gradient at the noise floor:
    where JAX's gradient is within the gradient bound of 0, the weight may
    differ by up to 2 lr. After both: the stem, layer1, affine_h0 and
    affine_c0 unchanged (exact), the ResNet unchanged with the encoder
    off."""
    jcf, params, state, batch = setup
    jcf = jcf.replace(opt_rnn_optimization=opt, opt_cnn_optimization=opt)
    from adaptive_tpu.models.factory import build_model as jbuild

    jm = jbuild(jcf)
    jp, js = _jax_copy(params), _jax_copy(state)
    jdual, jopt = JO.make_dual_optimizer(jp, jcf)
    jstep = JST.make_train_step(jm, jdual, jcf)
    keys = [jax.random.PRNGKey(seed) for seed in STEP_SEEDS]
    want_g = jax_grads if opt == "adam" else None

    _, model, net, dual, step = _port_setup(jcf, params, state)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    _patch_draws(monkeypatch, keys, jcf.train_crop_size)
    gen = torch.Generator().manual_seed(0)
    for i, key in enumerate(keys):
        out = jstep(jp, js, jopt, dict(batch), key, encoder_on)
        jp, js, jopt = out.params, out.model_state, out.opt_state
        got = step(net, batch, gen, encoder_on)
        np.testing.assert_allclose(float(got.loss), float(out.loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got.lstm_grad_norm), float(out.lstm_grad_norm),
                                   rtol=1e-5)
        if i:
            continue
        if want_g is not None:
            groups = ("decoder", "encoder") if encoder_on else ("decoder",)
            got_g = _port_grads(net, dual, groups)
            _close(got_g, {k: want_g[f"params|{k}"] for k in got_g}, GRAD_ATOL, GRAD_RTOL, "grad")
        flat, want = TC._model_flat(net), _flat_jax(jp, js)
        _close({k: v for k, v in flat.items() if k.startswith("state")},
               {k: v for k, v in want.items() if k.startswith("state")}, STATE_ATOL, what="BN")
        lr = jcf.opt_cnn_adam_learning_rate
        for k in (k for k in want if k.startswith("params")):
            d = np.abs(flat[k] - want[k])
            over = d > PARAM_ATOL
            if over.any():
                assert want_g is not None and "resnet" in k, k
                assert (np.abs(want_g[k][over]) <= GRAD_ATOL).all(), k
                assert (d[over] <= 2 * lr + PARAM_ATOL).all(), (k, d.max())
    after = net.state_dict()
    frozen = ["encoder.resnet_conv.0.", "encoder.resnet_conv.1.", "encoder.resnet_conv.4.",
              "encoder.affine_h0.", "encoder.affine_c0."]
    if not encoder_on:
        frozen.append("encoder.resnet_conv.")
    for k, v in before.items():
        if k.startswith(tuple(frozen)) and not k.endswith(("running_mean", "running_var")):
            assert torch.equal(after[k], v), k


def test_groups_and_lr(setup):
    """The two groups' members (JAX's masks: affine_a/b + decoder; ResNet
    children [5:]), neither holding affine_h0/c0, the stem or layer1;
    get_lr/set_lr."""
    jcf, params, state, _ = setup
    _, _, net, dual, _ = _port_setup(jcf, params, state)
    dmask, emask = JO.param_group_masks(jax.tree.map(jnp.asarray, params), jcf)
    keys = param_keys(net.encoder.resnet_conv.arch)
    for group, mask in (("decoder", dmask), ("encoder", emask)):
        on = {k[len("params|"):] for k, v in _flat_jax(mask).items() if bool(v)}
        assert {keys[n][0] for n in dual.names(group)} == on, group
    assert TO.get_lr(dual, "decoder") == pytest.approx(1e-3)
    assert TO.get_lr(dual, "encoder") == pytest.approx(1e-5)
    TO.set_lr(dual, "decoder", 5e-4)
    assert TO.get_lr(dual, "decoder") == pytest.approx(5e-4, rel=1e-7)  # held at fp32


def test_grad_accum_matches_jax(setup, monkeypatch):
    """train_grad_accum_steps=2 with the encoder on against JAX's scan over
    the same microbatches and keys (split(key, 2)): loss within 1e-5, BN
    statistics (updated once a microbatch) within 1e-5, weights within
    2e-6. The encoder group runs sgd: adam's sign of a gradient at the
    noise floor is test_train_step_matches_jax's business."""
    jcf, params, state, batch = setup
    jcf = jcf.replace(train_grad_accum_steps=2, opt_cnn_optimization="sgd")
    from adaptive_tpu.models.factory import build_model as jbuild

    jm = jbuild(jcf)
    jp, js = _jax_copy(params), _jax_copy(state)
    jdual, jopt = JO.make_dual_optimizer(jp, jcf)
    key = jax.random.PRNGKey(5)
    out = JST.make_train_step(jm, jdual, jcf)(jp, js, jopt, dict(batch), key, True)
    _, model, net, dual, step = _port_setup(jcf, params, state)
    _patch_draws(monkeypatch, list(jax.random.split(key, 2)), jcf.train_crop_size)
    got = step(net, batch, torch.Generator(), True)
    np.testing.assert_allclose(float(got.loss), float(out.loss), rtol=LOSS_RTOL)
    flat, want = TC._model_flat(net), _flat_jax(out.params, out.model_state)
    _close({k: v for k, v in flat.items() if k.startswith("state")},
           {k: v for k, v in want.items() if k.startswith("state")}, STATE_ATOL, what="BN")
    _close({k: v for k, v in flat.items() if k.startswith("params")},
           {k: v for k, v in want.items() if k.startswith("params")}, PARAM_ATOL, what="param")


@pytest.mark.usefixtures("default_threads")  # its bounds hold at that count only (ROADMAP.md §7 h)
def test_grad_accum_two_equals_monolithic(setup, monkeypatch):
    """On a batch of two equal halves (the same images, captions and draws)
    each microbatch's BN statistics are the whole batch's, so two
    accumulated microbatches give the monolithic step's loss (within 1e-6,
    relative) and gradients (the step's bound against JAX: atol 1e-5 +
    rtol 1e-4), sums taken in another order."""
    jcf, params, state, batch = setup
    half = {k: v[:2] for k, v in batch.items()}
    doubled = {k: np.concatenate([v, v]) for k, v in half.items()}
    zeros = (torch.zeros(2, dtype=torch.long), torch.zeros(2, dtype=torch.long),
             torch.tensor([False, True]))
    monkeypatch.setattr(tpre, "draw_crop_flip",
                        lambda gen, n, h, w, c: tuple(torch.cat([z] * (n // 2)) for z in zeros))
    runs = []
    for accum in (1, 2):
        _, _, net, dual, step = _port_setup(jcf, params, state, train_grad_accum_steps=accum)
        out = step(net, doubled, torch.Generator(), True)
        grads = {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}
        runs.append((float(out.loss), grads))
    (l1, g1), (l2, g2) = runs
    assert l1 == pytest.approx(l2, rel=1e-6)
    assert g1.keys() == g2.keys()
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=n)


def test_remat_encoder_equals_plain(setup):
    """remat_encoder recomputes the trunk in the backward: the loss,
    weights and BN statistics (updated once, not again by the recompute)
    equal the plain step's within 1e-6."""
    jcf, params, state, batch = setup
    runs = []
    for remat in (False, True):
        _, _, net, _, step = _port_setup(jcf, params, state, remat_encoder=remat)
        out = step(net, batch, torch.Generator().manual_seed(1), True)
        runs.append((float(out.loss), TC._model_flat(net)))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    _close(runs[1][1], runs[0][1], 1e-6, what="remat")


def test_dropout_in_the_step(setup):
    """Rate 0 draws no mask; an active rate changes the train loss but not
    eval scores, and the step runs and moves the weights."""
    jcf, params, state, batch = setup
    images = torch.from_numpy(np.random.default_rng(3).normal(size=(B, 64, 64, 3))
                              .astype(np.float32))
    caps = torch.from_numpy(batch["captions"])
    _, m0, net0, _, _ = _port_setup(jcf, params, state)
    _, m5, net5, _, step5 = _port_setup(jcf, params, state, train_dropout_rate=0.5)
    with torch.no_grad():  # eval first: train forwards move the BN statistics
        ev0 = m0.forward(net0, images, caps)[0]
        ev5 = m5.forward(net5, images, caps, gen=torch.Generator())[0]
        plain = m0.forward(net0, images, caps, train=True, gen=torch.Generator())[0]
        net0.load_state_dict(net5.state_dict())
        same = m0.forward(net0, images, caps, train=True)[0]
        dropped = m5.forward(net5, images, caps, train=True, gen=torch.Generator())[0]
    assert torch.equal(plain, same) and not torch.equal(plain, dropped)
    assert torch.equal(ev0, ev5)
    w = net5.decoder.embed.weight.clone()
    assert np.isfinite(float(step5(net5, batch, torch.Generator(), False).loss))
    assert not torch.equal(w, net5.decoder.embed.weight)


# ------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def stepped(setup):
    """A port net and dual optimizer after one encoder-on step (nonzero
    moments in both groups), and the JAX tree of the same config."""
    jcf, params, state, batch = setup
    _, model, net, dual, step = _port_setup(jcf, params, state)
    step(net, batch, torch.Generator().manual_seed(2), True)
    TO.set_lr(dual, "decoder", 2.5e-4)
    return jcf, model, net, dual, params, state


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_port_checkpoint_reads_in_jax(tmp_path, setup, opt):
    """A port checkpoint (model.npz, opt.npz, manifest) restores in the JAX
    package's restore_model / restore_opt_state to the port's values bit
    for bit, moments and traces in JAX's layouts, counts and learning rates
    included."""
    jcf, params, state, batch = setup
    jcf = jcf.replace(opt_rnn_optimization=opt, opt_cnn_optimization=opt)
    _, model, net, dual, step = _port_setup(jcf, params, state)
    step(net, batch, torch.Generator().manual_seed(2), True)
    path = str(tmp_path / TC.checkpoint_name(0.25, 3))
    TC.save_checkpoint(path, net, dual, {"epoch": 3})
    zeros = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, params))
    jp, js = JC.restore_model(path, zeros, jax.tree.map(jnp.zeros_like,
                                                        jax.tree.map(jnp.asarray, state)))
    for k, v in _flat_jax(jp, js).items():
        np.testing.assert_array_equal(v, TC._model_flat(net)[k], err_msg=k)
    _, template = JO.make_dual_optimizer(zeros, jcf)
    jopt = JC.restore_opt_state(path, jax.tree.map(jnp.zeros_like, template))
    got = {k: np.asarray(v) for k, v in JC._flatten(jopt).items()}
    want = TC._opt_flat(dual, net)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["decoder|inner_states|on|inner_state|count"]) == 1
    assert JO.get_lr(jopt, "decoder") == pytest.approx(jcf.opt_rnn_adam_learning_rate if
                                                       opt == "adam" else
                                                       jcf.opt_rnn_sgd_learning_rate)
    assert JC.load_metadata(path) == {"epoch": 3}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_jax_checkpoint_reads_in_port(tmp_path, setup, opt):
    """A JAX checkpoint whose optimizer state took one update of each group
    (seeded gradients through the JAX package's own transforms) restores in
    the port bit for bit: weights, BN statistics, adam moments or sgd
    traces, counts and learning rates. The port then steps from it, and its
    next checkpoint counts 2 updates."""
    import optax

    jcf, params, state, batch = setup
    jcf = jcf.replace(opt_rnn_optimization=opt, opt_cnn_optimization=opt)
    jp = jax.tree.map(jnp.asarray, params)
    jdual, jopt = JO.make_dual_optimizer(jp, jcf)
    rng = np.random.default_rng(11)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), jp)
    @jax.jit
    def update(p, o, g):
        upd, dec = jdual.decoder_tx.update(g, o["decoder"], p)
        p = optax.apply_updates(p, upd)
        upd, enc = jdual.encoder_tx.update(g, o["encoder"], p)
        return optax.apply_updates(p, upd), {"decoder": dec, "encoder": enc}

    jp, jopt = update(jp, jopt, grads)
    jopt = JO.set_lr(jopt, "decoder", 7.5e-4)
    path = str(tmp_path / JC.checkpoint_name(0.5, 1))
    JC.save_checkpoint(path, jp, state, jopt, {"epoch": 1})
    want_model = _flat_jax(jp, state)
    want_opt = {k: np.asarray(v) for k, v in JC._flatten(jopt).items()}

    _, model, net, dual, step = _port_setup(jcf, params, state)
    TC.restore_model(path, net, model.arch)
    TC.restore_opt_state(path, dual, net)
    got_model, got_opt = TC._model_flat(net), TC._opt_flat(dual, net)
    for k, v in want_model.items():
        np.testing.assert_array_equal(got_model[k], v, err_msg=k)
    assert set(got_opt) == set(want_opt)
    for k, v in want_opt.items():
        np.testing.assert_array_equal(got_opt[k], v, err_msg=k)
    assert TO.get_lr(dual, "decoder") == pytest.approx(7.5e-4)

    assert np.isfinite(float(step(net, batch, torch.Generator(), True).loss))
    counts = {k: int(v) for k, v in TC._opt_flat(dual, net).items() if k.endswith("count")}
    assert set(counts.values()) == {2}, counts


def test_checkpoint_atomic_and_refusals(tmp_path, stepped):
    """Overwrite through '.old', no '.tmp' left; a directory or file that is
    not a checkpoint is refused; AsyncCheckpointer copies before it returns
    (a weight changed after save() is not in the file) and prunes step
    checkpoints once the new one lands; a missing leaf raises KeyError."""
    jcf, model, net, dual, params, state = stepped
    path = str(tmp_path / TC.checkpoint_name(0.1, 1))
    TC.save_checkpoint(path, net, dual)
    TC.save_checkpoint(path, net, dual, {"again": True})
    assert sorted(p.name for p in tmp_path.iterdir()) == [TC.checkpoint_name(0.1, 1)]
    assert TC.load_metadata(path) == {"again": True}
    (tmp_path / "plain").mkdir()
    (tmp_path / "file").write_text("x")
    for bad in ("plain", "file"):
        with pytest.raises(ValueError, match="not a checkpoint"):
            TC.save_checkpoint(str(tmp_path / bad), net, dual)
    assert (tmp_path / "file").read_text() == "x"

    d = tmp_path / "async"
    d.mkdir()
    TC.save_checkpoint(str(d / TC.step_checkpoint_name(2, 3)), net)
    saver = TC.AsyncCheckpointer()
    w0 = net.decoder.embed.weight.detach().clone()
    saver.save(str(d / TC.checkpoint_name(0.2, 2)), net, dual, {"e": 2}, prune_before=(3, 0))
    with torch.no_grad():
        net.decoder.embed.weight.add_(1.0)
    saver.wait()
    assert sorted(p.name for p in d.iterdir()) == [TC.checkpoint_name(0.2, 2)]
    with np.load(d / TC.checkpoint_name(0.2, 2) / "model.npz") as f:
        np.testing.assert_array_equal(f["params|decoder|embed"], w0.numpy())
    with torch.no_grad():
        net.decoder.embed.weight.sub_(1.0)
    with np.load(d / TC.checkpoint_name(0.2, 2) / "opt.npz") as f:
        flat = dict(f)
    del flat["decoder|inner_states|on|inner_state|count"]
    np.savez(d / TC.checkpoint_name(0.2, 2) / "opt.npz", **flat)
    with pytest.raises(KeyError, match="inner_state\\|count"):
        TC.restore_opt_state(str(d / TC.checkpoint_name(0.2, 2)), dual, net)


def test_checkpoint_names_equal_jax(tmp_path):
    """find_latest_checkpoint, _resume_point and stale_step_checkpoints give
    the JAX package's answers on the same directory (==)."""
    names = ["cider-0.1000_model-1", "cider-0.0000_model-2_step-3", "cider-0.2000_model-2",
             "cider-0.0000_model-3_step-1", "cider-0.0000_model-3_step-4.tmp", "junk",
             "cider-0.3000_model-1"]
    for n in names:
        (tmp_path / n).mkdir()
    d = str(tmp_path)
    assert TC.find_latest_checkpoint(d) == JC.find_latest_checkpoint(d)
    assert TC.find_best_checkpoint(d) == JC.find_best_checkpoint(d)
    for n in names:
        assert TC._resume_point(n) == JC._resume_point(n), n
    for point in ((2, 0), (3, 2), (4, 0)):
        assert sorted(TC.stale_step_checkpoints(d, *point)) == sorted(
            JC.stale_step_checkpoints(d, *point))
    assert TC.step_checkpoint_name(4, 7) == JC.step_checkpoint_name(4, 7)
    assert TC.find_latest_checkpoint(str(tmp_path / "none")) is None
