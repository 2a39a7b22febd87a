"""The PyTorch port's greedy captioning slice end to end on the CPU, against
the JAX package's make_greedy_decoder on the same weights and images; plus
the port's guards (no JAX import, no silent CPU fallback)."""

import copy
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu_torch.decoding import make_greedy_decoder
from adaptive_tpu_torch.models.factory import build_model
from tests.torch_port_util import jax_weights, port_cf, port_model_and_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tiny_cf):
    # padded vocab (37 -> 40) exercises the head's -1e30 columns
    jcf = tiny_cf.replace(vocab_length=37, vocab_pad_multiple=8, decode_max_len=6)
    _, params, state = jax_weights(jcf.replace(use_pallas="always"), seed=4)
    # BN statistics away from (0, 1) keep the random trunk's features small
    # enough that the captions change from step to step
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda x: rng.uniform(2, 8, x.shape).astype(np.float32), state)
    images = np.random.default_rng(11).integers(0, 255, (3, 72, 72, 3), dtype=np.uint8)
    return jcf, params, state, images


def _jax_decode(jcf, params, state, images, monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    from adaptive_tpu.decoding import greedy as jgreedy
    from adaptive_tpu.decoding import spmd
    from adaptive_tpu.models.factory import build_model as jax_build

    model = jax_build(jcf)
    with monkeypatch.context() as m:
        m.setattr(spmd, "decode_mesh", lambda *_: None)  # single-device program
        with pltpu.force_tpu_interpret_mode():
            return jgreedy.make_greedy_decoder(model, jcf)(params, state, jnp.asarray(images))


def _port_decode(jcf, params, state, images, **kw):
    model, net = port_model_and_net(port_cf(jcf, **kw), params, state)
    return make_greedy_decoder(model, port_cf(jcf, **kw))(net, images)


@pytest.mark.parametrize("use_pallas", ["always", "never"])
@pytest.mark.parametrize("prev_hidden", [False, True])
def test_greedy_matches_jax(setup, monkeypatch, use_pallas, prev_hidden):
    """Ids equal; attention and beta within 2e-4 (fp32). 'always' runs the
    fused path (the kernels' plain twins here, the Pallas kernels in
    interpret mode on the JAX side); 'never' the op-by-op path."""
    jcf, params, state, images = setup
    jcf = jcf.replace(use_pallas=use_pallas, sampler_sentinel_uses_prev_hidden=prev_hidden)
    want = _jax_decode(jcf, params, state, images, monkeypatch)
    got = _port_decode(jcf, params, state, images)
    assert got.ids.dtype == torch.int32 and tuple(got.ids.shape) == want.ids.shape
    assert len(np.unique(np.asarray(want.ids))) > 2  # a non-degenerate caption
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention), atol=2e-4)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), atol=2e-4)


def _eos_biased(params, eos, boost):
    p = copy.deepcopy(params)
    p["decoder"]["adaptive"]["mlp"]["bias"][eos] += boost
    return p


@pytest.mark.parametrize("boost", [0.0, 3.0, 1e4])
def test_early_exit_ids_equal_fixed_loop(setup, boost):
    jcf, params, state, images = setup
    p = _eos_biased(params, jcf.decode_eos_token, boost)
    fixed = _port_decode(jcf, p, state, images)
    early = _port_decode(jcf, p, state, images, decode_early_exit=True)
    np.testing.assert_array_equal(early.ids.numpy(), fixed.ids.numpy())
    if boost == 1e4:  # every row ends at step 0: the tail is the zero prefill
        assert (early.ids == jcf.decode_eos_token).all()
        np.testing.assert_allclose(early.attention[:, 0].sum(-1).numpy(), 1.0, atol=1e-5)
        assert (early.attention[:, 1:] == 0).all() and (early.beta[:, 1:] == 0).all()


def test_decode_step_logits_match_jax(setup):
    """One decode step's logits, attention, beta and state (fused cell and
    op-by-op) against the JAX package's decode_step."""
    from adaptive_tpu.models.factory import build_model as jax_build

    jcf, params, state, _ = setup
    rng = np.random.default_rng(3)
    H, E, K, B = jcf.adaptive_lstm_hidden_size, jcf.adaptive_word_embed_size, 4, 4
    V, v_g = rng.normal(size=(B, K, H)).astype(np.float32), rng.normal(size=(B, E)).astype(np.float32)
    tok = np.array([1, 2, 3, 39], np.int32)
    jm = jax_build(jcf.replace(use_pallas="never"))
    jst = jm.init_decode_state(jnp.zeros((B, H)), jnp.zeros((B, H)))
    want = jm.decode_step({"decoder": params["decoder"]},
                          jnp.asarray(tok), jnp.asarray(v_g), jst, jnp.asarray(V))
    for use_pallas in ("always", "never"):
        model, net = port_model_and_net(port_cf(jcf, use_pallas=use_pallas), params, state)
        dec = model.prepare_inference(net)["decoder"]
        st = model.init_decode_state(torch.zeros(B, H), torch.zeros(B, H))
        got = model.decode_step(dec, torch.from_numpy(tok), torch.from_numpy(v_g), st,
                                torch.from_numpy(V))
        for name, a, b in zip(("logits", "alpha", "beta"), got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, err_msg=name)
        for name, a, b in zip(("h", "c", "h_prev"), got[3], want[3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, err_msg=name)


def test_prepare_cached_once_per_checkpoint(setup):
    jcf, params, state, images = setup
    model, net = port_model_and_net(port_cf(jcf), params, state)
    decode = make_greedy_decoder(model, port_cf(jcf))
    decode(net, images)
    decode(net, images)
    assert (decode.prepare.misses, decode.prepare.hits) == (1, 1)
    head_w, head_b = decode.prepare(net)["head"]
    assert head_w.shape[1] == 128 and (head_b[37:] == -1e30).all()


def test_prepare_cached_sees_in_place_weight_changes(setup):
    """A weight changed in place (as an optimiser step does) between two
    decodes misses the cache: the second ids are a fresh decoder's, not the
    first weights'. clear() forces a miss too."""
    jcf, params, state, images = setup
    model, net = port_model_and_net(port_cf(jcf), params, state)
    decode = make_greedy_decoder(model, port_cf(jcf))
    before = decode(net, images).ids
    with torch.no_grad():
        net.decoder.adaptive.mlp.bias[jcf.decode_eos_token] += 1e4  # every row ends at step 0
    after = decode(net, images).ids
    assert (decode.prepare.misses, decode.prepare.hits) == (2, 0)
    fresh = make_greedy_decoder(model, port_cf(jcf))(net, images).ids
    np.testing.assert_array_equal(after.numpy(), fresh.numpy())
    assert (after == jcf.decode_eos_token).all() and not torch.equal(after, before)
    decode(net, images)
    decode.prepare.clear()
    decode(net, images)
    assert (decode.prepare.misses, decode.prepare.hits) == (3, 1)


def test_prepare_cached_serves_a_replaced_parameter_until_clear(setup):
    """A parameter replaced by another tensor object is not among the listed
    tensors: the cached preparation is served (a hit, the first weights'
    ids) until clear(), after which the ids are a fresh decoder's."""
    jcf, params, state, images = setup
    model, net = port_model_and_net(port_cf(jcf), params, state)
    decode = make_greedy_decoder(model, port_cf(jcf))
    before = decode(net, images).ids
    mlp = net.decoder.adaptive.mlp
    bias = mlp.bias.detach().clone()
    bias[jcf.decode_eos_token] += 1e4  # every row ends at step 0
    mlp.bias = torch.nn.Parameter(bias)
    stale = decode(net, images).ids
    assert (decode.prepare.misses, decode.prepare.hits) == (1, 1)
    assert torch.equal(stale, before)
    decode.prepare.clear()
    after = decode(net, images).ids
    assert decode.prepare.misses == 2
    fresh = make_greedy_decoder(model, port_cf(jcf))(net, images).ids
    np.testing.assert_array_equal(after.numpy(), fresh.numpy())
    assert (after == jcf.decode_eos_token).all()


def test_port_imports_no_jax():
    """A fresh process imports the port and decodes on the CPU, greedy and
    beam, scores a 2-image synthetic split through coco_eval, takes a
    train step and writes its checkpoint, takes an L-BFGS step (both groups)
    and writes its checkpoint, runs the CLI's main on a config file with
    no stage on, serves a caption, exports and runs a decoder, converts a
    checkpoint, lays out a mesh, starts and ends a one-rank process group
    (parallel), and imports the port's tools and examples, without loading
    jax or any module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import tempfile
        import numpy as np
        from adaptive_tpu_torch import Config
        from adaptive_tpu_torch.models import build_model
        from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
        from adaptive_tpu_torch.data import loader, synthetic
        from adaptive_tpu_torch.data.vocab import Vocabulary
        from adaptive_tpu_torch.evalcap.coco_eval import coco_eval
        from adaptive_tpu_torch.training import checkpoint, main_train, optim, schedule, step
        from adaptive_tpu_torch.utils import logging
        from adaptive_tpu_torch.ops import dropout
        cf = Config(encoder_backbone="resnet18", train_crop_size=64, vocab_length=32,
                    adaptive_word_embed_size=8, adaptive_lstm_hidden_size=16,
                    decode_max_len=3, beam_size=2)
        model = build_model(cf, device="cpu")
        imgs = np.zeros((2, 64, 64, 3), np.uint8)
        net = model.init(0)
        out = make_greedy_decoder(model, cf)(net, imgs)
        assert tuple(out.ids.shape) == (2, 3)
        beams = make_beam_decoder(model, cf)(net, imgs)
        assert tuple(beams.all_ids.shape) == (2, 2, 3)
        with tempfile.TemporaryDirectory() as root:
            ann, resized = synthetic.make_synthetic_dataset(root, num_images=2, image_size=64)
            vocab = Vocabulary(["<pad>", "<start>", "<end>", "<unk>"]
                               + [f"w{i}" for i in range(28)])
            ecf = cf.replace(resized_image_dir=resized, val_anno_path=ann, exp_dir=root,
                             eval_batch_size=2, dataloader_num_workers=1)
            assert len(loader.EvalImageDataset(resized, ann)) == 2
            assert np.isfinite(coco_eval(ecf, model, net, vocab=vocab))
        assert checkpoint.find_best_checkpoint(root) is None
        dual = optim.make_dual_optimizer(net, cf)
        batch = {"images": np.zeros((2, 72, 72, 3), np.uint8),
                 "captions": np.ones((2, 4), np.int32), "lengths": np.array([4, 3], np.int32)}
        import torch
        out = step.make_train_step(model, dual, cf)(net, batch, torch.Generator(), True)
        assert np.isfinite(float(out.loss))
        with tempfile.TemporaryDirectory() as root:
            checkpoint.save_checkpoint(root + "/cider-0.0000_model-1", net, dual)
            checkpoint.restore_opt_state(root + "/cider-0.0000_model-1", dual, net)
        from adaptive_tpu_torch import experiment, main as cli
        from adaptive_tpu_torch.config import load_config
        from adaptive_tpu_torch.data import karpathy_split, resize
        from adaptive_tpu_torch.models import torch_import
        from adaptive_tpu_torch.training import lbfgs
        lcf = load_config(cf, opt_rnn_optimization="lbfgs", opt_cnn_optimization="lbfgs",
                          opt_rnn_lbfgs_max_iter=2, opt_cnn_lbfgs_max_iter=2,
                          opt_rnn_lbfgs_history=2, opt_cnn_lbfgs_history=2)
        dual = optim.make_dual_optimizer(net, lcf)
        out = lbfgs.make_lbfgs_train_step(model, dual, lcf)(net, batch, torch.Generator(), True)
        assert np.isfinite(float(out.loss))
        with tempfile.TemporaryDirectory() as root:
            checkpoint.save_checkpoint(root + "/cider-0.0000_model-1", net, dual)
            checkpoint.restore_opt_state(root + "/cider-0.0000_model-1", dual, net)
            with open(root + "/cfg.py", "w") as f:
                f.write(f"experiment_path = {root!r}\\n")
            cli.main(["-c", root + "/cfg.py"], device="cpu")
        from adaptive_tpu_torch.export import export_decoder, load_decoder
        from adaptive_tpu_torch.serving import CaptionService
        from adaptive_tpu_torch.utils import profiling, trace_report
        svc = CaptionService(cf.replace(eval_batch_size=2, resized_image_size=64), vocab,
                             net=net, batch_size=2, max_wait_ms=1, device="cpu")
        try:
            assert "caption" in svc.caption(imgs[0], timeout=120)
        finally:
            svc.close()
        with tempfile.TemporaryDirectory() as root:
            dec = load_decoder(export_decoder(model, cf.replace(beam_size=1,
                                                                resized_image_size=64),
                                              net, root + "/d.pt2", batch_size=2))
            assert tuple(dec(imgs)["ids"].shape) == (2, 3)
            torch_import.save_reference_checkpoint_npz(net.state_dict(), "adaptive_attention",
                                                       "resnet18", root + "/ckpt")
        from adaptive_tpu_torch import parallel
        from adaptive_tpu_torch.decoding import spmd
        assert parallel.make_mesh(world_size=8, shape=(-1, 2)).shape == (4, 2)
        assert parallel.init_distributed(load_config(cf, distributed_init=True), "cpu")
        assert parallel.get_world_size() == 1 and spmd.decode_mesh(model, cf) is None
        torch.distributed.destroy_process_group()
        sys.path[:0] = ["tools", "examples"]
        import torch_decode_timing, torch_int8_gate, torch_serving_bench
        import torch_caption_image, torch_convert_weights, torch_serve
        import torch_visualize_attention
        bad = [m for m in sys.modules
               if m in ("jax", "adaptive_tpu") or m.startswith(("jax.", "adaptive_tpu."))]
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_model_defaults_to_cuda(tiny_cf, monkeypatch):
    """No silent CPU fallback: the default device is CUDA, and it raises
    where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        build_model(port_cf(tiny_cf))
    assert build_model(port_cf(tiny_cf), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("variant", ["baseline_attention", "rnn_attention"])
def test_other_variants_build_on_cpu(tiny_cf, variant):
    """build_model of the other two variants on the CPU: the spec of JAX's
    build_model (its sizes, rnn's aggregator), a net that initialises and
    prepares with no cell tiles (the fused cell is the adaptive variant's)."""
    from adaptive_tpu.models.factory import build_model as jax_build

    jcf = tiny_cf.replace(atten_model_name=variant)
    model = build_model(port_cf(jcf), device="cpu")
    assert tuple(model.spec) == tuple(jax_build(jcf).spec)
    prepared = model.prepare_inference(model.init(0))
    assert prepared["cell"] is None and prepared["head"] is not None
