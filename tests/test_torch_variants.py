"""The PyTorch port's baseline_attention and rnn_attention decoders against
the JAX package's on the CPU (tests/conftest.py::tiny_cf: ResNet-18 at 64
px, K = 4 slots, E 8, H 16; rnn bidirectional with hr 8, and
unidirectional with hr 16): the attention ops, the weight bridge, the
teacher-forced scores, a decode step, greedy and beam-3 decodes through the
kernels' twins and op by op, one Adam train step, a JAX-written model.npz,
the L-BFGS codec's order, coco_eval, CaptionService and the exported
decoder. The same numpy-seeded inputs and JAX weights (from_jax) go through
both packages. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.models import decoders as JD
from adaptive_tpu.ops import attention as JA
from adaptive_tpu.training import checkpoint as JC
from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
from adaptive_tpu_torch.models import decoders as TD
from adaptive_tpu_torch.models.jax_params import from_jax, to_jax
from adaptive_tpu_torch.ops import attention as TA
from adaptive_tpu_torch.training import checkpoint as TC
from tests.torch_port_util import jax_weights, np_tree, port_cf, port_model_and_net

OP_ATOL = 1e-5  # one op (ROADMAP.md's North star)
SCORE_ATOL = 3e-4  # teacher-forced scores of the whole model
MAP_ATOL = 2e-4  # decoded attention maps and beam scores (tests/test_torch_beam.py)
B, T, S = 3, 5, 72

# case -> (atten_model_name, rnn_attention_bidirectional, the init's seed:
# one whose random decoder captions the 3 images of setup differently)
CASES = {"baseline": ("baseline_attention", True, 4), "rnn_bi": ("rnn_attention", True, 3),
         "rnn_uni": ("rnn_attention", False, 4)}


def _jcf(tiny_cf, case, **kw):
    variant, bi, _ = CASES[case]
    # padded vocab (37 -> 40) exercises the head's -1e30 columns
    return tiny_cf.replace(atten_model_name=variant, rnn_attention_bidirectional=bi,
                           vocab_length=37, vocab_pad_multiple=8, decode_max_len=5, **kw)


@pytest.fixture(scope="module", params=list(CASES))
def setup(request, tiny_cf):
    """(case, jcf, params, state, images): 3 seeded 72 px images and JAX's
    init from the case's PRNGKey with the BN statistics calibrated on the
    images (resnet.calibrate_bn_), so that the captions differ from image
    to image, as numpy trees for both packages."""
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    case = request.param
    jcf = _jcf(tiny_cf, case)
    _, params, state = jax_weights(jcf, seed=CASES[case][2])
    images = np.random.default_rng(11).integers(0, 255, (B, S, S, 3), dtype=np.uint8)
    model, net = port_model_and_net(port_cf(jcf), params, state)
    calibrate_bn_(net.encoder.resnet_conv, eval_preprocess(torch.as_tensor(images),
                                                           jcf.train_crop_size))
    params, state = to_jax(net.state_dict(), model.arch)
    return case, jcf, params, state, images


def _jmodel(jcf):
    from adaptive_tpu.models.factory import build_model

    return build_model(jcf)


# ------------------------------------------------------------------- per op
@pytest.mark.parametrize("with_pv", [False, True])
def test_attention_ops_match_jax(setup, with_pv):
    """spatial_attention (baseline) and recurrent_attention (rnn, uni- and
    bidirectional: the backward direction's h_T first) against JAX's on the
    same seeded V and h, with and without the hoisted pv, within 1e-5."""
    case, jcf, params, _, _ = setup
    atten = params["decoder"]["adaptive"]["atten"]
    rng = np.random.default_rng(5)
    H, K = jcf.lstm_hidden_size, 4
    V = rng.normal(size=(B, K, H)).astype(np.float32)
    h = rng.normal(size=(B, T, H)).astype(np.float32)
    jat = jax.tree.map(jnp.asarray, atten)
    tat = jax.tree.map(torch.from_numpy, np_tree(atten))
    jpv = JA.precompute_slots(jat, jnp.asarray(V)) if with_pv else None
    tpv = torch.from_numpy(np.array(jpv)) if with_pv else None
    if case == "baseline":
        want = JA.spatial_attention(jat, jnp.asarray(V), jnp.asarray(h), jpv)
        got = TA.spatial_attention(tat, torch.from_numpy(V), torch.from_numpy(h), tpv)
    else:
        bi = CASES[case][1]
        want = JA.recurrent_attention(jat, jnp.asarray(V), jnp.asarray(h), bi, jpv)
        got = TA.recurrent_attention(tat, torch.from_numpy(V), torch.from_numpy(h), bi, tpv)
        assert tuple(got[0].shape) == (B, T, H)  # 2 x hr, or hr = H
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OP_ATOL, rtol=0)


# ------------------------------------------------------------------- bridge
def test_bridge_roundtrip_bit_for_bit(setup):
    """from_jax / to_jax both ways bit for bit; the state_dict carries the
    reference's names (rnn's aggregator adaptive.atten.lstm, *_reverse
    where bidirectional) and loads strictly into the port's model."""
    case, jcf, params, state, _ = setup
    sd = from_jax(params, state, jcf.encoder_backbone)
    model, net = port_model_and_net(port_cf(jcf), params, state)
    assert set(sd) == set(net.state_dict())
    assert ("decoder.adaptive.atten.lstm.weight_ih_l0_reverse" in sd) == (case == "rnn_bi")
    assert ("decoder.adaptive.atten.lstm.weight_ih_l0" in sd) == case.startswith("rnn")
    assert not any(k.startswith("decoder.adaptive.sentinel") for k in sd)
    p2, s2 = to_jax(net.state_dict(), model.arch)
    want = JC._flatten({"params": params, "state": state})
    got = TC.flatten_tree({"params": p2, "state": s2})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    sd2 = from_jax(p2, s2, model.arch)
    for k, v in sd.items():
        assert torch.equal(sd2[k], v), k


# --------------------------------------------------------- teacher forcing
def _decoder_inputs(jcf, seed=8):
    rng = np.random.default_rng(seed)
    H, E, K = jcf.lstm_hidden_size, jcf.word_embed_size, 4
    V = np.abs(rng.normal(size=(B, K, H))).astype(np.float32)
    v_g = rng.normal(size=(B, E)).astype(np.float32)
    h0, c0 = np.tanh(rng.normal(size=(2, B, H))).astype(np.float32)
    caps = rng.integers(1, jcf.vocab_length, (B, T)).astype(np.int32)
    return V, v_g, h0, c0, caps


def test_decoder_forward_matches_jax(setup):
    """decoder_forward's scores and alpha within 3e-4 of JAX's on the same
    inputs; beta is None in both (no sentinel)."""
    case, jcf, params, state, _ = setup
    model, net = port_model_and_net(port_cf(jcf), params, state)
    ins = _decoder_inputs(jcf)
    ws, wa, wb = JD.decoder_forward(jax.tree.map(jnp.asarray, params["decoder"]),
                                    _jmodel(jcf).spec, *map(jnp.asarray, ins[:2]),
                                    jnp.asarray(ins[4]), *map(jnp.asarray, ins[2:4]))
    V, v_g, h0, c0, caps = map(torch.from_numpy, ins)
    gs, ga, gb = TD.decoder_forward(TD.decoder_params(net.decoder, detach=False), model.spec,
                                    V, v_g, caps, h0, c0)
    assert wb is None and gb is None
    np.testing.assert_allclose(gs.detach().numpy(), np.asarray(ws), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(ga.detach().numpy(), np.asarray(wa), atol=SCORE_ATOL, rtol=0)


def test_decode_step_matches_jax(setup):
    """One decode_step's logits, alpha and beta (zeros) within 1e-5 of
    JAX's, from a seeded state and token."""
    case, jcf, params, state, _ = setup
    model, net = port_model_and_net(port_cf(jcf), params, state)
    V, v_g, h0, c0, caps = _decoder_inputs(jcf, seed=9)
    dec = TD.decoder_params(net.decoder)
    jst = JD.DecodeState(jnp.asarray(h0), jnp.asarray(c0), jnp.zeros_like(h0))
    want = JD.decode_step(jax.tree.map(jnp.asarray, params["decoder"]), _jmodel(jcf).spec,
                          jnp.asarray(caps[:, 0]), jnp.asarray(v_g), jst, jnp.asarray(V))
    tst = TD.DecodeState(torch.from_numpy(h0), torch.from_numpy(c0),
                         torch.zeros_like(torch.from_numpy(h0)))
    got = TD.decode_step(dec, model.spec, torch.from_numpy(caps[:, 0]), torch.from_numpy(v_g),
                         tst, torch.from_numpy(V))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OP_ATOL, rtol=0)
    assert not got[2].any()
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OP_ATOL, rtol=0)


# ----------------------------------------------------------------- decoding
def _jax_decode(jcf, params, state, images, beam):
    from adaptive_tpu.decoding import beam as jbeam
    from adaptive_tpu.decoding import greedy as jgreedy

    model = _jmodel(jcf)
    if beam:
        return jbeam.make_beam_decoder(model, jcf, beam_size=3)(params, state,
                                                                 jnp.asarray(images))
    return jgreedy.make_greedy_decoder(model, jcf)(params, state, jnp.asarray(images))


@pytest.fixture(scope="module")
def jax_decodes():
    """JAX's decodes by (case, beam), each made once."""
    return {}


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam3"])
@pytest.mark.parametrize("use_pallas", ["auto", "never"])
def test_decode_matches_jax(setup, jax_decodes, beam, use_pallas):
    """Greedy and beam-3 ids equal JAX's (all beams, and the best); the maps
    and beam scores within 2e-4; beta zeros. 'auto', the port's default,
    runs the head through the kernels' twins (kernels 2 and 4 on the card)
    on the cell's a (c or F_T), the cell op by op; 'never' the op-by-op step
    and head. JAX decodes these variants op by op either way."""
    case, jcf, params, state, images = setup
    if (case, beam) not in jax_decodes:
        jax_decodes[case, beam] = _jax_decode(jcf, params, state, images, beam)
    want = jax_decodes[case, beam]
    pcf = port_cf(jcf, use_pallas=use_pallas)
    model, net = port_model_and_net(pcf, params, state)
    assert model.fused == (use_pallas == "auto")
    decode = make_beam_decoder(model, pcf, beam_size=3) if beam else make_greedy_decoder(model,
                                                                                          pcf)
    got = decode(net, images)
    prepared = decode.prepare(net)
    assert prepared["cell"] is None and (prepared["head"] is not None) == model.fused
    ids = np.asarray(want.ids)
    assert len(np.unique(ids)) > 2 and len({tuple(r) for r in ids}) > 1  # non-degenerate
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    names = ("attention", "beta")
    if beam:
        np.testing.assert_array_equal(got.all_ids.numpy(), np.asarray(want.all_ids))
        names += ("all_scores", "score")
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=MAP_ATOL, rtol=0, err_msg=name)
    assert not got.beta.any()


# ----------------------------------------------------------------- training
def test_train_step_matches_jax(setup, monkeypatch):
    """One Adam step with the encoder off against JAX's make_train_step on
    the same weights, batch and crop/flip draws, under
    tests/test_torch_train_step.py's bounds: loss and LSTM grad norm within
    1e-5 (relative); the decoder group's gradients within atol 1e-5 + rtol
    1e-4 of JAX's; BN statistics within 1e-5; every weight within 2e-6,
    except that adam's update lr * g / (|g| + eps) takes the sign of a
    gradient at the noise floor: where JAX's gradient is within the
    gradient bound of 0, the weight may differ by up to 2 lr."""
    from adaptive_tpu.training import optim as JO
    from adaptive_tpu.training import step as JST
    from adaptive_tpu_torch.training import optim as TO
    from adaptive_tpu_torch.training import step as TST
    from tests.test_torch_train_step import (
        GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, STATE_ATOL, _close, _flat_jax, _jax_copy,
        _jax_grads, _patch_draws, _port_grads,
    )

    case, jcf, params, state, _ = setup
    jcf = jcf.replace(train_batch_size=4)
    rng = np.random.default_rng(7)
    batch = {"images": rng.integers(0, 256, (4, S, S, 3), dtype=np.uint8),
             "captions": rng.integers(1, jcf.vocab_length, (4, T + 1)).astype(np.int32),
             "lengths": np.array([6, 3, 5, 4], np.int32)}
    jm = _jmodel(jcf)
    jp, js = _jax_copy(params), _jax_copy(state)
    jdual, jopt = JO.make_dual_optimizer(jp, jcf)
    key = jax.random.PRNGKey(21)
    out = JST.make_train_step(jm, jdual, jcf)(jp, js, jopt, dict(batch), key, False)
    want_g = _flat_jax(_jax_grads(jcf, jm, params, state, batch, key, False))

    pcf = port_cf(jcf)
    model, net = port_model_and_net(pcf, params, state)
    dual = TO.make_dual_optimizer(net, pcf)
    _patch_draws(monkeypatch, [key], jcf.train_crop_size)
    got = TST.make_train_step(model, dual, pcf)(net, batch, torch.Generator().manual_seed(0),
                                                False)
    np.testing.assert_allclose(float(got.loss), float(out.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got.lstm_grad_norm), float(out.lstm_grad_norm), rtol=1e-5)
    got_g = _port_grads(net, dual, ("decoder",))
    assert any("atten|lstm" in k for k in got_g) == case.startswith("rnn")
    _close(got_g, {k: want_g[f"params|{k}"] for k in got_g}, GRAD_ATOL, GRAD_RTOL, "grad")
    flat, want = TC._model_flat(net), _flat_jax(out.params, out.model_state)
    _close({k: v for k, v in flat.items() if k.startswith("state")},
           {k: v for k, v in want.items() if k.startswith("state")}, STATE_ATOL, what="BN")
    lr = jcf.opt_rnn_adam_learning_rate
    for k in (k for k in want if k.startswith("params")):
        d = np.abs(flat[k] - want[k])
        over = d > PARAM_ATOL
        assert (np.abs(want_g[k][over]) <= GRAD_ATOL).all(), k
        assert (d[over] <= 2 * lr + PARAM_ATOL).all(), (k, d.max())


def test_restore_model_of_jax_npz(setup, tmp_path):
    """restore_model of a model.npz the JAX package wrote (its
    save_checkpoint) gives its weights bit for bit, and the port's own
    checkpoint of them holds JAX's keys and values."""
    case, jcf, params, state, _ = setup
    path = str(tmp_path / "cider-0.1000_model-1")
    JC.save_checkpoint(path, jax.tree.map(jnp.asarray, params), state, None, {"epoch": 1})
    model = port_model_and_net(port_cf(jcf), params, state)[0]
    net = model.init(3)
    TC.restore_model(path, net, model.arch)
    want = JC._flatten({"params": params, "state": state})
    got = TC._model_flat(net)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    TC.save_checkpoint(str(tmp_path / "port"), net)
    with np.load(tmp_path / "port" / "model.npz") as f, \
            np.load(tmp_path / "cider-0.1000_model-1" / "model.npz") as j:
        assert set(f) == set(j)
        for k in j:
            np.testing.assert_array_equal(f[k], j[k], err_msg=k)


@pytest.mark.parametrize("bi", [True, False], ids=["bi", "uni"])
def test_lbfgs_segments_follow_ravel_pytree(tiny_cf, bi):
    """The rnn decoder group's L-BFGS segments are in JAX's ravel_pytree
    order over the group's tree (dict keys sorted: lstm_bwd before
    lstm_fwd): each parameter's index vector goes through to_jax_vector to
    JAX's ravel of the same tree (exact) and back unchanged."""
    from jax.flatten_util import ravel_pytree

    from adaptive_tpu.training import optim as JO
    from adaptive_tpu.training.lbfgs import partition
    from adaptive_tpu_torch.models.jax_params import param_keys, to_layout
    from adaptive_tpu_torch.training import lbfgs as TL
    from adaptive_tpu_torch.training import optim as TO

    jcf = _jcf(tiny_cf, "rnn_bi" if bi else "rnn_uni", opt_rnn_optimization="lbfgs")
    pcf = port_cf(jcf)
    params = jax.eval_shape(_jmodel(jcf).init, jax.random.PRNGKey(0))[0]
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params)
    from adaptive_tpu_torch.models.factory import build_model

    net = build_model(pcf, device="cpu").init(0)
    dual = TO.make_dual_optimizer(net, pcf)
    jdual, _ = JO.make_dual_optimizer(jax.tree.map(jnp.asarray, params), jcf)
    keys = param_keys(net.encoder.resnet_conv.arch)
    named = dict(net.named_parameters())
    names = dual.names("decoder")
    assert any(".atten.lstm." in n for n in names)
    vals = {n: torch.arange(named[n].numel(), dtype=torch.float32).view(named[n].shape)
            + 1e4 * i for i, n in enumerate(names)}
    flat = JC._flatten(params)
    for n in names:
        flat[keys[n][0]] = to_layout(vals[n], keys[n][1])
    tree = JC._unflatten_into(params, flat)
    want = np.asarray(ravel_pytree(partition(tree, jdual.decoder_mask)[0])[0])
    vec = torch.cat([vals[n].reshape(-1) for n in names])
    segs = TL.group_segments(net, names)
    got = TL.to_jax_vector(vec, segs)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(TL.from_jax_vector(got, segs, "cpu"), vec)


# ---------------------------------------------------------- eval and serving
@pytest.fixture(scope="module")
def eval_split(tmp_path_factory):
    """4 synthetic images at 72 px with their captions and vocabulary."""
    from adaptive_tpu.data.coco_api import COCO as JCOCO
    from adaptive_tpu.data.synthetic import make_synthetic_dataset
    from adaptive_tpu.data.vocab import build_vocab

    root = str(tmp_path_factory.mktemp("variants_split"))
    ann, resized = make_synthetic_dataset(root, num_images=4, image_size=72, seed=4)
    jvocab = build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1)
    return ann, resized, jvocab


def test_coco_eval_greedy_matches_jax(setup, eval_split, tmp_path):
    """coco_eval greedy on 4 images: the results JSON, CIDEr and per-image
    scores equal (==) to the JAX driver's on the same weights."""
    import json

    from adaptive_tpu.evalcap import coco_eval as J
    from adaptive_tpu_torch.data.vocab import Vocabulary
    from adaptive_tpu_torch.evalcap import coco_eval as TE

    case, jcf, params, state, _ = setup
    ann, resized, jvocab = eval_split
    jcf = jcf.replace(vocab_length=len(jvocab), vocab_pad_multiple=1, resized_image_dir=resized,
                      val_anno_path=ann, eval_batch_size=4, dataloader_num_workers=1)
    _, params, _ = jax_weights(jcf, seed=CASES[case][2])
    tvocab = Vocabulary([jvocab.idx2word[i] for i in range(len(jvocab))])
    jexp, texp = str(tmp_path / "jax"), str(tmp_path / "port")
    want_pi, got_pi = {}, {}
    want = J.coco_eval(jcf.replace(exp_dir=jexp), _jmodel(jcf), params, state, epoch=1,
                       vocab=jvocab, per_image_out=want_pi)
    pcf = port_cf(jcf)
    model, net = port_model_and_net(pcf, params, state)
    got = TE.coco_eval(pcf.replace(exp_dir=texp), model, net, epoch=1, vocab=tvocab,
                       per_image_out=got_pi)
    results = []
    for exp in (jexp, texp):
        with open(f"{exp}/val_results/validation-1.json") as f:
            results.append(json.load(f))
    assert results[1] == results[0] and len(results[1]) == 4
    assert got == want and got_pi == want_pi


def test_caption_service_equals_direct_decode(tiny_cf):
    """CaptionService of a baseline decoder captions each image as a direct
    greedy decode of the same net and images does."""
    from adaptive_tpu_torch.data.vocab import SPECIALS, Vocabulary
    from adaptive_tpu_torch.serving import CaptionService

    words = SPECIALS + [f"w{i}" for i in range(28)]
    cf = port_cf(_jcf(tiny_cf, "baseline"), vocab_length=len(words), vocab_pad_multiple=1,
                 eval_batch_size=2)
    imgs = np.random.default_rng(2).integers(0, 255, (2, S, S, 3), dtype=np.uint8)
    svc = CaptionService(cf, Vocabulary(words), batch_size=2, max_wait_ms=1, device="cpu")
    try:
        got = [svc.caption(im, timeout=120)["caption"] for im in imgs]
        ids = make_greedy_decoder(svc.model, svc.cf)(svc.net, imgs).ids.numpy()
    finally:
        svc.close()
    assert got == [Vocabulary(words).decode_ids(r) for r in ids]


def test_exported_rnn_greedy_equals_in_process(tiny_cf, tmp_path):
    """The exported greedy decoder of the bidirectional rnn variant (its
    aggregator's 2 x K cell steps unrolled into each of the 5 steps) gives
    the in-process decoder's ids (==), attention and beta within 1e-6."""
    from adaptive_tpu_torch.export import export_decoder, load_decoder
    from adaptive_tpu_torch.models.factory import build_model

    cf = port_cf(_jcf(tiny_cf, "rnn_bi"), eval_batch_size=2)
    imgs = np.random.default_rng(3).integers(0, 255, (2, S, S, 3), dtype=np.uint8)
    model = build_model(cf, device="cpu")
    net = model.init(0)
    out = load_decoder(export_decoder(model, cf, net, str(tmp_path / "rnn.pt2")))(imgs)
    direct = make_greedy_decoder(model, cf)(net, imgs)
    assert torch.equal(out["ids"], direct.ids)
    for name in ("attention", "beta"):
        np.testing.assert_allclose(out[name].numpy(), getattr(direct, name).numpy(), rtol=0,
                                   atol=1e-6)
