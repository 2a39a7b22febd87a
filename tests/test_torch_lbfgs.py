"""The PyTorch port's L-BFGS train step (training/lbfgs.py) against the JAX
package's make_lbfgs_train_step on the same weights and batches
(tests/conftest.py::tiny_cf: ResNet-18 at 64 px, vocab 32, E 8, H 16), fp32,
max_iter 4 and history 3, so that two batches form a pair across the batch
boundary and wrap the ring. The port's crop/flip draws are JAX's own for the
step key (draw_crop_flip patched), as in tests/test_torch_train_step.py.
Also: the curvature memory's codec and checkpoints read both ways, a
bit-identical resume, the plateau scheduler's lr, the dropout masks and BN
statistics of one batch, and the refusal of accumulation with L-BFGS. Each
test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.training import checkpoint as JC
from adaptive_tpu.training import optim as JO
from adaptive_tpu.training.lbfgs import make_lbfgs_train_step as j_lbfgs_step
from adaptive_tpu_torch.config import Config
from adaptive_tpu_torch.ops import preprocess as tpre
from adaptive_tpu_torch.training import checkpoint as TC
from adaptive_tpu_torch.training import lbfgs as TL
from adaptive_tpu_torch.training import optim as TO
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net

B, T, S = 4, 6, 72
MAX_ITER, HISTORY = 4, 3
LOSS_RTOL = 1e-5  # loss and LSTM grad norm, relative
# the second step's LSTM grad norm after a first step in which an Adam group
# took the sign of noise-floor gradients (weights up to 5.1e-5 apart, below):
# 1.7e-5 apart (measured, decoder Adam before an L-BFGS encoder)
NORM_RTOL_AFTER_ADAM = 5e-5
STATE_ATOL = 1e-5  # BN running statistics
# weights after each L-BFGS step (absolute), and the decoder group's memory
# (its pairs s, y, its d and prev_grad relative to each vector's largest
# element; rho, t, prev_loss relative): the two packages sum in other orders
# (fp32), and each inner iteration's direction and step carry the earlier
# ones' rounding (measured: weights 1.3e-6, memory 9.2e-5)
PARAM_ATOL = 1e-5
MEMORY_RTOL = 1e-4
# The encoder group's L-BFGS pairs are formed over steps of ~1e-7 a weight
# (torch's first step min(1, 1/|g|_1) * lr over 8.4M parameters, then lr
# 0.01), across which the gradient changes less than its fp32 rounding: y is
# rounding noise in both packages (its rows part by up to the row's own
# scale), and so is everything built on it: the directions, and the points
# and gradients of the later evaluations (prev_grad 20-30% of its largest
# element apart after the second step, prev_loss 0.1-0.2%). At the default
# lr the encoder group's memory is held to count and n_iter (equal) and t
# (MEMORY_RTOL), its weights to ENC_PARAM_ATOL (measured 2.0e-5 after the
# second step, 6.7e-7 after the first); the codec itself is exact
# (test_codec_order_is_ravel_pytree, test_resume_bit_identical).
ENC_PARAM_ATOL = 5e-5
# dec_adam_enc_lbfgs_moving: an encoder group whose steps are past fp32
# rounding. At lr 30 and max_iter 2 (torch's max_eval, max_iter * 5 // 4,
# is then 2: each step takes one iteration and re-evaluates the closure
# once) the first step moves the weights along -g / |g|_1 by up to 1.1e-4
# and the second, on the pair formed across the batch boundary (a gradient
# change of the gradient's own order), by up to 1.7e-3, 35 times
# ENC_PARAM_ATOL (measured in JAX). There the encoder group's memory is
# held as the decoder's: count, n_iter, t, prev_loss, prev_grad and the
# pairs s, y within MEMORY_RTOL (measured: prev_grad 7.3e-5 of its largest
# element, the pairs 7.5e-5 of a row's). rho and d are held against a
# float64 evaluation of JAX's own pairs and gradient (rho = 1 / (y . s), d
# the two-loop recursion), within MEMORY_RTOL (measured: rho 6.9e-6, d
# 7.8e-5 of its largest element): JAX's stored rho is 0.9% from 1 / (y . s)
# of its own pair in float64 (its fp32 dot over 8.4M products; the port's
# d is within 2.2e-6 of the float64 recursion over its own memory), so
# JAX's d is 1.2% from its own recursion and its weights up to 2.0e-5 from
# the port's (ENC_PARAM_ATOL).
MOVING_KNOBS = {"opt_cnn_lbfgs_lr": 30.0, "opt_cnn_lbfgs_max_iter": 2}
MOVING_MIN_MOVE = 10 * ENC_PARAM_ATOL
GRAD_ATOL = 1e-5  # a gradient at the noise floor (tests/test_torch_train_step.py)
# The encoder group is layer4 (opt_fine_tune_cnn_start_layer 7): at these
# weights and batches XLA's CPU gradients of ResNet-18's layers 2 and 3 are
# up to 1.5% of a tensor's largest element from a float64 evaluation of the
# same function, layer4's within 4e-5, and the port's within 3e-5 everywhere
# (test_encoder_gradients_at_eval_point_against_fp64 holds the port's, of
# layers 2-4, at the L-BFGS decoder's evaluation point, to FP64_REL).
START_LAYER = 7
FP64_REL = 1e-4
STEP_SEEDS = (31, 32)
# (opt_rnn_optimization, opt_cnn_optimization, encoder_on)
CASES = {
    "dec_lbfgs_enc_off": ("lbfgs", "adam", False),
    "dec_lbfgs_enc_adam": ("lbfgs", "adam", True),
    "dec_adam_enc_lbfgs": ("adam", "lbfgs", True),
    "both_lbfgs": ("lbfgs", "lbfgs", True),
    "dec_adam_enc_lbfgs_moving": ("adam", "lbfgs", True),
}
CASE_KNOBS = {"dec_adam_enc_lbfgs_moving": MOVING_KNOBS}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "captions": rng.integers(1, 32, (B, T)).astype(np.int32),
        "lengths": np.array([6, 3, 5, 4], np.int32),
    }


BATCHES = (_batch(40), _batch(41))


def _jcf(tiny_cf, case, **kw):
    rnn, cnn, _ = CASES[case]
    knobs = dict(
        train_batch_size=B, opt_rnn_optimization=rnn, opt_cnn_optimization=cnn,
        opt_rnn_lbfgs_max_iter=MAX_ITER, opt_cnn_lbfgs_max_iter=MAX_ITER,
        opt_rnn_lbfgs_history=HISTORY, opt_cnn_lbfgs_history=HISTORY,
        opt_fine_tune_cnn_start_layer=START_LAYER)
    return tiny_cf.replace(**{**knobs, **CASE_KNOBS.get(case, {}), **kw})


def _weights(jcf):
    """JAX's init from PRNGKey(0): one compile for every case (the weights
    do not depend on the optimizer or dropout knobs)."""
    return jax_weights(jcf.replace(opt_rnn_optimization="adam", opt_cnn_optimization="adam",
                                   train_dropout_rate=0.0,
                                   opt_fine_tune_cnn_start_layer=START_LAYER))


def _jax_draws(key, n, size, crop):
    k1, k2, k3 = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.randint(k1, (n,), 0, size - crop + 1))),
            torch.from_numpy(np.array(jax.random.randint(k2, (n,), 0, size - crop + 1))),
            torch.from_numpy(np.array(jax.random.bernoulli(k3, 0.5, (n,)))))


def _patch_draws(monkeypatch, keys, crop):
    """The port's draws: JAX's for keys[0], keys[1], ... in call order."""
    it = iter(keys)
    monkeypatch.setattr(tpre, "draw_crop_flip",
                        lambda gen, n, h, w, c: _jax_draws(next(it), n, h, crop))


def _cp(tree):
    return jax.tree.map(jnp.array, tree)


def _flat(tree):
    return {k: np.asarray(v) for k, v in JC._flatten(tree).items()}


_JAX = {}


def _jax_run(tiny_cf, case):
    """JAX's two steps from PRNGKey(0)'s weights: (jcf, step function,
    [(out, flat params+state, flat opt_state) after each step]); memoized
    within the test process (one compile a case)."""
    if case not in _JAX:
        from adaptive_tpu.models.factory import build_model as jbuild

        jcf = _jcf(tiny_cf, case)
        _, params, state = _weights(jcf)
        dual, opt = JO.make_dual_optimizer(jax.tree.map(jnp.asarray, params), jcf)
        step = j_lbfgs_step(jbuild(jcf), dual, jcf)
        p, s, o = _cp(params), _cp(state), opt
        outs = []
        for b, seed in zip(BATCHES, STEP_SEEDS):
            out = step(p, s, o, dict(b), jax.random.PRNGKey(seed), CASES[case][2])
            p, s, o = out.params, out.model_state, out.opt_state
            outs.append((out, _flat({"params": p, "state": s}), _flat(o)))
        _JAX[case] = (jcf, step, dual, outs)
    return _JAX[case]


def _port(jcf):
    _, params, state = _weights(jcf)
    pcf = port_cf(jcf)
    model, net = port_model_and_net(pcf, params, state)
    dual = TO.make_dual_optimizer(net, pcf)
    return pcf, model, net, dual, TL.make_lbfgs_train_step(model, dual, pcf)


def _ring(flat, group):
    """A JAX-format memory's pairs oldest first: (s rows, y rows, rho)."""
    pre = f"{group}_lbfgs|"
    h, count, head = flat[pre + "s"].shape[0], int(flat[pre + "count"]), int(flat[pre + "head"])
    rows = [(head - count + j) % h for j in range(count)]
    return flat[pre + "s"][rows], flat[pre + "y"][rows], flat[pre + "rho"][rows]


def _vec_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=MEMORY_RTOL * scale, rtol=0, err_msg=what)


def _two_loop64(flat, group):
    """(rho, d) of a JAX-format memory evaluated in float64 from its pairs
    and prev_grad: rho = 1 / (y . s) per pair, d torch's two-loop recursion
    over them at prev_grad (H_diag from the newest pair)."""
    s, y, _ = (np.asarray(v, np.float64) for v in _ring(flat, group))
    rho = 1.0 / np.einsum("ij,ij->i", s, y)
    q = -np.asarray(flat[f"{group}_lbfgs|prev_grad"], np.float64)
    al = np.zeros(len(rho))
    for i in reversed(range(len(rho))):
        al[i] = s[i] @ q * rho[i]
        q -= al[i] * y[i]
    r = q * (s[-1] @ y[-1] / (y[-1] @ y[-1]) if len(rho) else 1.0)
    for i in range(len(rho)):
        r += s[i] * (al[i] - y[i] @ r * rho[i])
    return rho, r


def _memory_close(got, want, group, exact_encoder=False):
    """An L-BFGS group's memory through the codec (the tolerances above).
    exact_encoder: the encoder group's steps are past fp32 rounding
    (dec_adam_enc_lbfgs_moving), and its memory is held as the decoder's,
    rho and d against _two_loop64 of JAX's memory."""
    pre = f"{group}_lbfgs|"
    for f in ("count", "n_iter"):
        assert int(got[pre + f]) == int(want[pre + f]), (group, f)
    np.testing.assert_allclose(got[pre + "t"], want[pre + "t"], rtol=MEMORY_RTOL)
    if group == "encoder" and not exact_encoder:  # the rest is built on rounding noise (above)
        return
    np.testing.assert_allclose(got[pre + "prev_loss"], want[pre + "prev_loss"], rtol=MEMORY_RTOL)
    _vec_close(got[pre + "prev_grad"], want[pre + "prev_grad"], f"{group} prev_grad")
    rho64, d64 = _two_loop64(want, group) if group == "encoder" else (None, None)
    for g, w, name in zip(_ring(got, group), _ring(want, group), ("s", "y", "rho")):
        assert g.shape == w.shape, (group, name)
        if name == "rho":
            np.testing.assert_allclose(g, w if rho64 is None else rho64, rtol=MEMORY_RTOL,
                                       err_msg=f"{group} rho")
            continue
        for j in range(g.shape[0]):
            _vec_close(g[j], w[j], f"{group} {name} row {j}")
    _vec_close(got[pre + "d"], want[pre + "d"] if d64 is None else d64, f"{group} d")


def _model_close(got, want_flat, want_opt=None, lrs=None, floor=None):
    """Weights within PARAM_ATOL (an L-BFGS encoder group's within
    ENC_PARAM_ATOL), BN statistics within STATE_ATOL; except that Adam's
    update lr * m / (sqrt(v) + eps) takes the sign of a gradient at the noise
    floor: where JAX's first moment has been within GRAD_ATOL of 0 at any
    step so far (floor: {key: mask}, updated here), a weight of an Adam
    group may differ by up to 2 lr a step. got: a flat model as
    TC._model_flat gives it."""
    assert set(got) == set(want_flat)
    floor = {} if floor is None else floor
    for k, w in want_flat.items():
        if k.startswith("state"):
            np.testing.assert_allclose(got[k], w, atol=STATE_ATOL, rtol=0, err_msg=k)
            continue
        d = np.abs(got[k] - w)
        mu = [(m.split("|")[0], v) for m, v in (want_opt or {}).items()
              if m.endswith("|mu|" + k[len("params|"):])]
        if mu:
            group, mu = mu[0]
            floor[k] = floor.get(k, np.zeros(mu.shape, bool)) | (np.abs(mu) <= GRAD_ATOL)
        lbfgs_enc = any(m.startswith("encoder_lbfgs") for m in want_opt or {}) and \
            k.startswith("params|encoder|resnet")
        over = d > (ENC_PARAM_ATOL if lbfgs_enc else PARAM_ATOL)
        if not over.any():
            continue
        assert mu is not None and len(mu), (k, float(d.max()))
        assert floor[k][over].all(), (k, float(d.max()))
        assert (d[over] <= 2 * lrs[group] * len(BATCHES) + PARAM_ATOL).all(), (k, float(d.max()))


@pytest.mark.parametrize("case", list(CASES))
def test_lbfgs_step_matches_jax(tiny_cf, monkeypatch, case):
    """Two steps on two batches against JAX's: each step's loss (the first
    evaluation's) within 1e-5 relative and LSTM grad norm within 1e-5
    relative (NORM_RTOL_AFTER_ADAM in the second step after an Adam group);
    after each, the weights and BN statistics (_model_close), each L-BFGS
    group's memory through the codec (_memory_close), an Adam group's
    moments under the codec within 1e-5 (at noise-floor gradients Adam's
    second moment is ~0 and the first ~GRAD_ATOL: both stay within it)."""
    jcf, _, _, outs = _jax_run(tiny_cf, case)
    _, _, net, dual, step = _port(jcf)
    _patch_draws(monkeypatch, [jax.random.PRNGKey(s) for s in STEP_SEEDS], jcf.train_crop_size)
    gen = torch.Generator().manual_seed(0)
    lrs = {"decoder": jcf.opt_rnn_adam_learning_rate, "encoder": jcf.opt_cnn_adam_learning_rate}
    floor = {}
    adam = "adam" in CASES[case][:2] and CASES[case][2]
    moving = case in CASE_KNOBS
    before = None
    for i, (b, (jout, jflat, jopt)) in enumerate(zip(BATCHES, outs)):
        got = step(net, b, gen, CASES[case][2])
        np.testing.assert_allclose(float(got.loss), float(jout.loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got.lstm_grad_norm), float(jout.lstm_grad_norm),
                                   rtol=NORM_RTOL_AFTER_ADAM if i and adam else LOSS_RTOL)
        _model_close(TC._model_flat(net), jflat, jopt, lrs, floor)
        opt = TC._opt_flat(dual, net)
        assert set(opt) == set(jopt)
        for group in ("decoder", "encoder"):
            if dual.group(group).__class__ is torch.optim.LBFGS:
                _memory_close(opt, jopt, group, exact_encoder=moving)
        for k in (k for k in jopt if "|mu|" in k or "|nu|" in k):
            np.testing.assert_allclose(opt[k], jopt[k], atol=1e-5, rtol=0, err_msg=k)
        if moving and i:  # JAX's second step moves the encoder past rounding
            assert max(float(np.abs(w - before[k]).max()) for k, w in jflat.items()
                       if k.startswith("params|encoder|resnet")) > MOVING_MIN_MOVE
        before = jflat


def test_codec_order_is_ravel_pytree(tiny_cf):
    """group_segments' JAX order is jax.flatten_util.ravel_pytree's over the
    group's trainable subset: a vector of each parameter's index goes
    through to_jax_vector to JAX's ravel of the same tree (exact), and back
    through from_jax_vector unchanged."""
    from jax.flatten_util import ravel_pytree

    from adaptive_tpu.training.lbfgs import partition
    from adaptive_tpu_torch.models.jax_params import param_keys, to_jax, to_layout

    jcf = _jcf(tiny_cf, "both_lbfgs")
    _, net, dual = _port(jcf)[1:4]
    jdual, _ = JO.make_dual_optimizer(jax.tree.map(jnp.asarray, _weights(jcf)[1]), jcf)
    keys = param_keys(net.encoder.resnet_conv.arch)
    params = dict(net.named_parameters())
    for group, mask in (("decoder", jdual.decoder_mask), ("encoder", jdual.encoder_mask)):
        names = dual.names(group)
        vals = {n: torch.arange(params[n].numel(), dtype=torch.float32).view(params[n].shape)
                + 1e4 * i for i, n in enumerate(names)}
        vec = torch.cat([vals[n].reshape(-1) for n in names])
        segs = TL.group_segments(net, names)
        tree = jax.tree.map(np.zeros_like, to_jax(net.state_dict(), net.encoder.resnet_conv.arch)[0])
        flat_tree = JC._flatten(tree)
        for n in names:
            flat_tree[keys[n][0]] = to_layout(vals[n], keys[n][1])
        tree = JC._unflatten_into(tree, flat_tree)
        want = np.asarray(ravel_pytree(partition(tree, mask)[0])[0])
        got = TL.to_jax_vector(vec, segs)
        np.testing.assert_array_equal(got, want)
        back = TL.from_jax_vector(got, segs, "cpu")
        assert torch.equal(back, vec)


def test_encoder_gradients_at_eval_point_against_fp64(tiny_cf, monkeypatch):
    """An Adam encoder group (layers 2-4) after an L-BFGS decoder group
    steps on the gradients at the decoder's last evaluation point: the
    encoder's .grad after the step equals a float64 forward and backward at
    that point (the weights recorded at the closure's last evaluation)
    within FP64_REL of each tensor's largest element, and is not the
    gradient at the step's final decoder weights (torch skips the
    re-evaluation on the max_iter-th iteration), which is over 100 times
    further from it."""
    jcf = _jcf(tiny_cf, "dec_lbfgs_enc_adam", opt_fine_tune_cnn_start_layer=5)
    pcf, model, net, dual, step = _port(jcf)
    points = []
    real_clip = TL.clip_lstm_grads

    def clip(grads, max_norm):
        points.append({k: v.detach().clone() for k, v in net.state_dict().items()})
        return real_clip(grads, max_norm)

    monkeypatch.setattr(TL, "clip_lstm_grads", clip)
    gen = torch.Generator().manual_seed(2)
    drawn = gen.get_state()
    step(net, BATCHES[0], gen, True)
    assert len(points) == MAX_ITER
    params = dict(net.named_parameters())
    got = {n: params[n].grad.double() for n in dual.names("encoder")}
    images = tpre.train_preprocess(torch.Generator().set_state(drawn),
                                   torch.as_tensor(BATCHES[0]["images"]), pcf.train_crop_size,
                                   model.compute_dtype).double()
    model64 = model._replace(compute_dtype=torch.float64)
    final = {n: params[n].detach().clone() for n in dual.names("decoder")}

    def grads64(decoder_weights):
        _, _, n64, _, _ = _port(jcf)
        n64.load_state_dict({**points[-1], **decoder_weights})  # the encoder's: the start's
        n64 = n64.double()
        scores, _ = model64.forward(n64, images, torch.as_tensor(BATCHES[0]["captions"]),
                                    train=True, update_stats=False)
        from adaptive_tpu_torch.training.step import masked_ce_loss

        masked_ce_loss(scores, torch.as_tensor(BATCHES[0]["captions"]),
                       torch.as_tensor(BATCHES[0]["lengths"])).backward()
        p64 = dict(n64.named_parameters())
        return {n: p64[n].grad for n in got}

    def rel(a, b):
        return max(float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in b)

    at_point = grads64({})
    assert rel(got, at_point) <= FP64_REL
    assert rel(got, grads64(final)) > 100 * rel(got, at_point)


def test_checkpoints_both_ways(tiny_cf, monkeypatch, tmp_path):
    """Both groups L-BFGS, encoder on: the port's checkpoint after step 1
    restored in JAX, and JAX's restored in the port; each then takes step 2
    and lands within the parity bounds of the other package's
    uninterrupted step 2 (loss, weights, memories)."""
    jcf, jstep, jdual, outs = _jax_run(tiny_cf, "both_lbfgs")
    _, params, state = _weights(jcf)
    keys = [jax.random.PRNGKey(s) for s in STEP_SEEDS]
    _patch_draws(monkeypatch, keys, jcf.train_crop_size)

    # the port's step 1 -> JAX's step 2
    _, _, net, dual, step = _port(jcf)
    step(net, BATCHES[0], torch.Generator(), True)
    d = str(tmp_path / "port")
    TC.save_checkpoint(d, net, dual)
    jp, js = JC.restore_model(d, _cp(params), _cp(state))
    _, fresh = JO.make_dual_optimizer(_cp(params), jcf)
    jo = JC.restore_opt_state(d, fresh)
    jout = jstep(jp, js, jo, dict(BATCHES[1]), keys[1], True)
    want_out, want_flat, want_opt = outs[1]
    np.testing.assert_allclose(float(jout.loss), float(want_out.loss), rtol=LOSS_RTOL)
    _model_close(_flat({"params": jout.params, "state": jout.model_state}), want_flat, want_opt)
    got_opt = _flat(jout.opt_state)
    for group in ("decoder", "encoder"):
        _memory_close(got_opt, want_opt, group)

    # JAX's step 1 -> the port's step 2
    d = str(tmp_path / "jax")
    first = outs[0][0]
    JC.save_checkpoint(d, first.params, first.model_state, first.opt_state)
    _, _, net, dual, step = _port(jcf)
    TC.restore_model(d, net, net.encoder.resnet_conv.arch)
    TC.restore_opt_state(d, dual, net)
    _patch_draws(monkeypatch, keys[1:], jcf.train_crop_size)
    got = step(net, BATCHES[1], torch.Generator(), True)
    np.testing.assert_allclose(float(got.loss), float(want_out.loss), rtol=LOSS_RTOL)
    _model_close(TC._model_flat(net), want_flat, want_opt)
    opt = TC._opt_flat(dual, net)
    for group in ("decoder", "encoder"):
        _memory_close(opt, want_opt, group)


@pytest.mark.parametrize("case", ["dec_lbfgs_enc_adam", "both_lbfgs"])
def test_resume_bit_identical(tiny_cf, tmp_path, case):
    """The port's checkpoint after step 1, restored into a fresh net and
    optimizer, continues to the uninterrupted run's step 2 bit for bit
    (the JAX package's test_lbfgs_checkpoint_resume_bit_identical)."""
    jcf = _jcf(tiny_cf, case)
    _, _, net, dual, step = _port(jcf)
    gen = torch.Generator().manual_seed(5)
    step(net, BATCHES[0], gen, True)
    d = str(tmp_path / "ck")
    TC.save_checkpoint(d, net, dual)
    at = gen.get_state()
    want = step(net, BATCHES[1], gen, True)
    _, _, net2, dual2, step2 = _port(jcf)
    TC.restore_model(d, net2, net2.encoder.resnet_conv.arch)
    TC.restore_opt_state(d, dual2, net2)
    got = step2(net2, BATCHES[1], torch.Generator().set_state(at), True)
    assert float(got.loss) == float(want.loss)
    for (k, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), k
    a, b = TC._opt_flat(dual, net), TC._opt_flat(dual2, net2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lr_zero_leaves_weights(tiny_cf):
    """set_lr on an L-BFGS group reaches its update (the plateau scheduler,
    train.py:57-60,184-194): at lr 0 a step leaves the weights unchanged,
    exactly; at the configured lr it moves them (the JAX package's
    test_plateau_scheduler_rescales_lbfgs_lr)."""
    jcf = _jcf(tiny_cf, "dec_lbfgs_enc_off")
    for lr, moves in ((None, True), (0.0, False)):
        _, _, net, dual, step = _port(jcf)
        before = net.decoder.embed.weight.detach().clone()
        if lr is not None:
            TO.set_lr(dual, "decoder", lr)
            assert TO.get_lr(dual, "decoder") == 0.0
        step(net, BATCHES[0], torch.Generator().manual_seed(1), False)
        assert torch.equal(net.decoder.embed.weight, before) != moves


@pytest.mark.parametrize("case", ["dec_lbfgs_enc_off", "dec_adam_enc_lbfgs"])
def test_dropout_masks_repeat_within_a_batch(tiny_cf, monkeypatch, case):
    """With train_dropout_rate 0.5 every evaluation of a batch (the L-BFGS
    group's closure, the decoder's first forward) draws its masks from the
    same generator state, so they are the same masks; the next batch's
    differ. The loss is the rate-0.5 loss, not the rate-0 one."""
    jcf = _jcf(tiny_cf, case, train_dropout_rate=0.5)
    _, _, net, dual, step = _port(jcf)
    evals = []
    from adaptive_tpu_torch.ops import dropout as tdrop

    real = tdrop.make_dropout

    def recording(gen, rate, rows=None):
        inner = real(gen, rate, rows)
        if inner is None:
            return None
        evals.append([])

        def drop(x):
            evals[-1].append(gen.get_state().clone())
            return inner(x)
        return drop

    monkeypatch.setattr(tdrop, "make_dropout", recording)
    monkeypatch.setattr(TL, "make_dropout", recording)
    gen = torch.Generator().manual_seed(3)
    out = step(net, BATCHES[0], gen, True)
    first = [e for e in evals if e]
    assert len(first) >= 2
    for e in first[1:]:
        assert len(e) == len(first[0]) and all(torch.equal(a, b) for a, b in zip(e, first[0]))
    evals.clear()
    step(net, BATCHES[1], gen, True)
    assert not torch.equal([e for e in evals if e][0][0], first[0][0])
    _, _, net0, _, step0 = _port(_jcf(tiny_cf, case))
    assert abs(float(out.loss) - float(step0(net0, BATCHES[0], torch.Generator().manual_seed(3),
                                               True).loss)) > 1e-4


@pytest.mark.parametrize("case", list(CASES))
def test_bn_statistics_update_once_a_batch(tiny_cf, case):
    """After one step (up to 4 evaluations a group) the BN running
    statistics are those of one train-mode forward of the batch from the
    starting weights, exactly."""
    jcf = _jcf(tiny_cf, case)
    pcf, model, net, dual, step = _port(jcf)
    _, _, net0, _, _ = _port(jcf)
    gen = torch.Generator().manual_seed(9)
    start = gen.get_state()
    step(net, BATCHES[0], gen, CASES[case][2])
    images = tpre.train_preprocess(torch.Generator().set_state(start),
                                   torch.as_tensor(BATCHES[0]["images"]), pcf.train_crop_size,
                                   model.compute_dtype)
    with torch.no_grad():
        model.forward(net0, images, torch.as_tensor(BATCHES[0]["captions"]), train=True)
    bufs, bufs0 = net.encoder.resnet_conv.bn_buffers(), net0.encoder.resnet_conv.bn_buffers()
    assert len(bufs) == len(bufs0) > 0
    for a, b in zip(bufs, bufs0):
        assert torch.equal(a, b)


def test_accumulation_with_lbfgs_refused(tiny_cf):
    """train_grad_accum_steps > 1 with an L-BFGS group is refused with the
    JAX package's error, in Config and in load_config."""
    from adaptive_tpu.config import load_config as jload
    from adaptive_tpu_torch.config import load_config

    kw = dict(opt_cnn_optimization="lbfgs", train_grad_accum_steps=2, train_batch_size=4)
    with pytest.raises(NotImplementedError) as je:
        jload(None, **kw)
    with pytest.raises(NotImplementedError) as te:
        load_config(None, **kw)
    assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="not supported with lbfgs"):
        Config(**kw)
    assert Config(opt_cnn_optimization="lbfgs", train_batch_size=4).opt_cnn_lbfgs_history == 50
