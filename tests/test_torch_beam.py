"""The PyTorch port's beam search end to end on the CPU, against the JAX
package's make_beam_decoder on the same weights and images; its layouts
against each other; its scores against a teacher-forced rescoring."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu_torch.decoding import make_beam_decoder
from adaptive_tpu_torch.decoding.beam import backtrack
from adaptive_tpu_torch.ops.preprocess import eval_preprocess
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net
from tests.torch_port_util import port_threads  # noqa: F401

W = 3


@pytest.fixture(scope="module")
def setup(tiny_cf):
    # padded vocab (37 -> 40) exercises the head's -1e30 columns
    jcf = tiny_cf.replace(vocab_length=37, vocab_pad_multiple=8, decode_max_len=6)
    _, params, state = jax_weights(jcf.replace(use_pallas="always"), seed=4)
    # BN means near 0 and variances of 2-8 keep the random trunk's features
    # small and let each image move its beams' scores (by ~1e-2), so that a
    # beam row read from the wrong image shows
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(-0.1, 0.1, x.shape) if "mean" in str(path[-1])
                         else rng.uniform(2, 8, x.shape)).astype(np.float32), state)
    images = np.random.default_rng(11).integers(0, 255, (3, 72, 72, 3), dtype=np.uint8)
    return jcf, params, state, images


def _eos_biased(params, eos, boost):
    p = copy.deepcopy(params)
    p["decoder"]["adaptive"]["mlp"]["bias"][eos] += boost
    return p


def _jax_beam(jcf, params, state, images, monkeypatch, length_alpha):
    from jax.experimental.pallas import tpu as pltpu

    from adaptive_tpu.decoding import beam as jbeam
    from adaptive_tpu.decoding import spmd
    from adaptive_tpu.models.factory import build_model as jax_build

    model = jax_build(jcf)
    with monkeypatch.context() as m:
        m.setattr(spmd, "decode_mesh", lambda *_: None)  # single-device program
        with pltpu.force_tpu_interpret_mode():
            return jbeam.make_beam_decoder(model, jcf, beam_size=W, length_alpha=length_alpha)(
                params, state, jnp.asarray(images))


def _port_beam(jcf, params, state, images, beam_size=W, length_alpha=0.0, **kw):
    model, net = port_model_and_net(port_cf(jcf, **kw), params, state)
    return make_beam_decoder(model, port_cf(jcf, **kw), beam_size=beam_size,
                             length_alpha=length_alpha)(net, images)


CASES = {
    "fused": dict(use_pallas="always"),
    "plain": dict(use_pallas="never"),
    "early_exit": dict(use_pallas="always", decode_early_exit=True),
    "length_alpha": dict(use_pallas="always"),
    "prev_hidden": dict(use_pallas="always", sampler_sentinel_uses_prev_hidden=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_matches_jax(setup, monkeypatch, case):
    """all_ids and ids equal; all_scores, score, attention and beta within
    2e-4 (fp32). 'fused' runs the kernels' plain twins here and the Pallas
    kernels in interpret mode on the JAX side (beam-major on both); 'plain'
    the op-by-op step. early_exit runs with <end> favoured, so that every
    beam finishes before the last step and the fixed loop's tail is filled."""
    jcf, params, state, images = setup
    jcf = jcf.replace(**CASES[case])
    alpha = 0.7 if case == "length_alpha" else 0.0
    if case == "early_exit":
        params = _eos_biased(params, jcf.decode_eos_token, 1.0)
    want = _jax_beam(jcf, params, state, images, monkeypatch, alpha)
    got = _port_beam(jcf, params, state, images, length_alpha=alpha)
    assert got.all_ids.dtype == torch.int32 and tuple(got.all_ids.shape) == want.all_ids.shape
    if case == "early_exit":  # every beam ended before the last step
        assert (np.asarray(want.all_ids)[..., -2:] == jcf.decode_eos_token).all()
    else:
        assert len(np.unique(np.asarray(want.all_ids))) > 2  # non-degenerate captions
    np.testing.assert_array_equal(got.all_ids.numpy(), np.asarray(want.all_ids))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    for name in ("all_scores", "score", "attention", "beta"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=2e-4, err_msg=name)


def test_beam_major_matches_tiled_and_width_9(setup):
    """decode_beam_major=False (V/pv repeated per beam row) gives the same
    beams as the beam-major default, and so does each image decoded alone;
    W = 9, which the JAX package routes to the tiled layout, runs
    beam-major in the port."""
    jcf, params, state, images = setup
    jcf = jcf.replace(use_pallas="always")
    for beam_size in (W, 9):
        major = _port_beam(jcf, params, state, images, beam_size=beam_size)
        tiled = _port_beam(jcf, params, state, images, beam_size=beam_size,
                           decode_beam_major=False)
        np.testing.assert_array_equal(tiled.all_ids.numpy(), major.all_ids.numpy())
        np.testing.assert_allclose(tiled.all_scores.numpy(), major.all_scores.numpy(),
                                   atol=1e-5)
        for i in range(len(images)):
            alone = _port_beam(jcf, params, state, images[i:i + 1], beam_size=beam_size)
            np.testing.assert_array_equal(alone.all_ids[0].numpy(), major.all_ids[i].numpy())
            np.testing.assert_allclose(alone.all_scores[0].numpy(),
                                       major.all_scores[i].numpy(), atol=1e-5)
    assert tuple(major.all_ids.shape) == (3, 9, jcf.decode_max_len)
    assert float(major.all_scores[:, 0].max() - major.all_scores[:, 0].min()) > 1e-3


def test_backtrack_follows_crossed_parents():
    """Two steps, W = 2, the parents cross at step 1: slot 0's last token
    came from slot 1, so its path takes slot 1's step-0 token, step 1's
    maps of source row 1 and step 0's maps of source row 0, as the JAX
    package's reverse scan resolves them."""
    a = torch.arange(2 * 2 * 3, dtype=torch.float32).reshape(2, 1, 2, 3)  # [t, B, W, K]
    hist = [(torch.tensor([[5, 6]]), torch.tensor([[0, 0]]), a[0], torch.tensor([[0.1, 0.2]])),
            (torch.tensor([[7, 8]]), torch.tensor([[1, 0]]), a[1], torch.tensor([[0.3, 0.4]]))]
    ids, att, beta = backtrack(hist)
    assert ids.tolist() == [[[6, 7], [5, 8]]]
    assert torch.equal(att[0, 0], torch.stack([a[0, 0, 0], a[1, 0, 1]]))
    assert torch.equal(att[0, 1], torch.stack([a[0, 0, 0], a[1, 0, 0]]))
    torch.testing.assert_close(beta, torch.tensor([[[0.1, 0.4], [0.1, 0.3]]]))


def _rescore(model, net, cf, images, ids):
    """Teacher-force each [B, W, L] path through the port's own decode_step:
    summed fp32 log-probs [B, W], tokens after the first <end> at no cost."""
    prepared = model.prepare_inference(net)
    dec = prepared["decoder"]
    x = eval_preprocess(torch.as_tensor(images), cf.train_crop_size)
    V, v_g, h0, c0 = model.encode_inference(prepared, x)
    B, nb, L = ids.shape
    totals = torch.zeros(B, nb, dtype=torch.float64)
    for w in range(nb):
        st = model.init_decode_state(h0, c0)
        tok = torch.full((B,), cf.decode_start_token, dtype=torch.int32)
        done = torch.zeros(B, dtype=torch.bool)
        for t in range(L):
            logits, _, _, st = model.decode_step(dec, tok, v_g, st, V,
                                                 cf.sampler_sentinel_uses_prev_hidden)
            lp = torch.log_softmax(logits.float(), -1)
            nxt = ids[:, w, t]
            totals[:, w] += torch.where(done, 0.0, lp[torch.arange(B), nxt.long()].double())
            done |= nxt == cf.decode_eos_token
            tok = nxt
    return totals


@pytest.mark.parametrize("length_alpha", [0.0, 0.7])
def test_beam_scores_match_teacher_forced_rescoring(setup, length_alpha):
    """Every returned beam's score equals its path rescored step by step
    (normalised by len^alpha, lengths through the first <end>): a wrong
    source-beam gather would part the two. atol 5e-3, as
    tests/test_beam_rescore.py."""
    jcf, params, state, images = setup
    cf = port_cf(jcf, use_pallas="always")
    model, net = port_model_and_net(cf, params, state)
    out = make_beam_decoder(model, cf, beam_size=W, length_alpha=length_alpha)(net, images)
    raw = _rescore(model, net, cf, images, out.all_ids)
    eos_hit = out.all_ids == cf.decode_eos_token
    lengths = torch.where(eos_hit.any(-1), eos_hit.int().argmax(-1) + 1,
                          out.all_ids.shape[-1] + 1).double()
    want = raw / lengths ** length_alpha
    np.testing.assert_allclose(out.all_scores.double().numpy(), want.numpy(), atol=5e-3, rtol=0)
    best = out.all_scores.argmax(1)
    np.testing.assert_array_equal(out.ids.numpy(), out.all_ids[torch.arange(3), best].numpy())
    np.testing.assert_array_equal(out.score.numpy(), out.all_scores.max(1).values.numpy())
