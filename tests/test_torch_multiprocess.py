"""The PyTorch port's multi-device path over torch.distributed, on the CPU:
ranks are processes on the gloo backend (a file store in the test's tmp
dir), each importing only the port; the JAX package's references run here
on the virtual CPU devices of tests/conftest.py. Two process groups:

* 2 ranks at mesh (2, 1): a data-parallel train step (Adam/Adam, encoder
  on) against JAX's step on a (2, 1) mesh; the step with ZeRO-1 against the
  replicated one, and the checkpoint it writes read back by JAX's
  restore_opt_state; a decoder L-BFGS step against the port's one-process
  step; coco_eval against JAX's driver (==);
* 4 ranks at mesh (2, 2): the data-parallel step with the model axis
  replicated against JAX's step on a (2, 2) mesh; tensor-parallel greedy and
  beam-3 decodes (kernel 4's twin on each vocab shard, the shards merged)
  against JAX's fused decode on a (2, 2) mesh in interpret mode.

The weights come across with models/jax_params.py::from_jax; the crop and
flip draws are JAX's for the global batch (draw_crop_flip patched in the
ranks); dropout is 0. Tolerances: loss rtol 1e-5, weights and BN
statistics atol 1e-5 (JAX's, tests/test_sharding.py:87-91), except that
Adam's first update lr * g / (|g| + eps) takes the sign of a gradient at
the noise floor: where the rank's gradient is within 1e-5 of 0, a weight
may differ by up to 2 lr (as tests/test_torch_train_step.py allows). The
main entry with distributed_init on a world of 1 is in
tests/test_torch_cli.py."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adaptive_tpu.parallel import make_mesh as jmake_mesh
from adaptive_tpu.parallel import shard_batch as jshard_batch
from adaptive_tpu.parallel import shard_params as jshard_params
from adaptive_tpu_torch.models.jax_params import to_jax
from adaptive_tpu_torch.training import checkpoint as TC
from tests.test_torch_train_step import _jax_draws
from tests.torch_port_util import jax_weights, port_cf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, S = 4, 6, 72
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5  # tests/test_sharding.py:87-91
GRAD_FLOOR = 1e-5
SCORE_ATOL = 1e-5  # TP beam scores against one process (tests/test_sharding.py:333)
MAP_ATOL = 2e-4  # scores, attention and beta, port vs JAX (tests/test_torch_beam.py:96)
RANK_TIMEOUT = 240

# One rank: joins the group, runs the payload's tasks in order, writes its
# results. Only the port is imported.
WORKER = r"""
import os, pickle, sys
rank, world, job, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(job, "store"),
                        world_size=world, rank=rank)
from adaptive_tpu_torch.config import Config
from adaptive_tpu_torch.models.factory import build_model, load_jax_weights
from adaptive_tpu_torch.ops import preprocess
from adaptive_tpu_torch.parallel import make_mesh, place_batch
from adaptive_tpu_torch.training import checkpoint as ckpt

with open(os.path.join(job, "payload.pkl"), "rb") as f:
    P = pickle.load(f)


def jax_draws(gen, n, height, width, crop):
    got = P["draws"]
    assert n == len(got[0]), (n, len(got[0]))  # drawn at the global batch's shape
    return tuple(torch.from_numpy(a) for a in got)


preprocess.draw_crop_flip = jax_draws


def setup(kw, weights="params"):
    cf = Config(**{**P["cf"], **kw})
    model = build_model(cf, device="cpu")
    return cf, model, load_jax_weights(model, *P[weights])


def snap(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def grads(net):
    return {k: p.grad.numpy().copy() for k, p in net.named_parameters() if p.grad is not None}


def train(kw, lbfgs=False):
    from adaptive_tpu_torch.training.lbfgs import make_lbfgs_train_step
    from adaptive_tpu_torch.training.optim import make_dual_optimizer, shard_opt_state
    from adaptive_tpu_torch.training.step import make_train_step

    cf, model, net = setup(kw)
    mesh = make_mesh(cf)
    dual = make_dual_optimizer(net, cf)
    if cf.opt_state_sharding == "data":
        dual = shard_opt_state(dual, net, mesh)
    step = (make_lbfgs_train_step if lbfgs else make_train_step)(model, dual, cf, mesh)
    out = step(net, place_batch(mesh, P["batch"]), torch.Generator().manual_seed(0),
               not lbfgs)
    return net, dual, out, mesh


out = {}
for task, kw in P["tasks"]:
    if task == "step":
        net, dual, res, mesh = train(kw)
        out[task] = {"loss": float(res.loss), "sd": snap(net), "grads": grads(net),
                     "coords": mesh.coords}
    elif task == "zero":
        net, dual, res, mesh = train(kw)
        moments = {}
        for name, z in dual.zero.shards.items():
            st = dual.group("decoder" if name in dual.decoder_names else "encoder").state[z.shard]
            moments[name] = (tuple(st["exp_avg"].shape), tuple(z.param.shape), z.dim)
        saver = ckpt.AsyncCheckpointer()
        saver.save(os.path.join(job, "zero_ckpt"), net, dual, metadata={"epoch": 1})
        saver.wait()
        out[task] = {"loss": float(res.loss), "sd": snap(net), "moments": moments}
    elif task == "lbfgs":
        net, dual, res, mesh = train(kw, lbfgs=True)
        st = dual.decoder.state[dual.decoder._params[0]]
        out[task] = {"loss": float(res.loss), "sd": snap(net), "n_iter": st["n_iter"],
                     "t": float(st["t"])}
    elif task == "coco_eval":
        from adaptive_tpu_torch.data.vocab import Vocabulary
        from adaptive_tpu_torch.evalcap.coco_eval import coco_eval

        cf, model, net = setup(kw, "eval_params")
        images, ids = P["eval_images"], P["eval_ids"]

        class Split:
            def __len__(self):
                return len(ids)

            def __getitem__(self, i):
                return images[i], ids[i]

        cider = coco_eval(cf, model, net, epoch=1, vocab=Vocabulary(P["words"]), dataset=Split())
        out[task] = {"cider": cider}
    elif task == "decode":
        from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

        cf, model, net = setup(kw)
        greedy = make_greedy_decoder(model, cf)
        g = greedy(net, P["decode_images"])
        prepared = greedy.prepare(net)
        b = make_beam_decoder(model, cf, beam_size=3)(net, P["decode_images"])
        out[task] = {
            "ids": g.ids.numpy(), "attention": g.attention.numpy(), "beta": g.beta.numpy(),
            "all_ids": b.all_ids.numpy(), "all_scores": b.all_scores.numpy(),
            "tp": prepared["tp"][1], "embed_rows": prepared["decoder"]["embed"].shape[0],
            "head_cols": prepared["head"][0].shape[1]}
with open(os.path.join(job, f"out{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def run_ranks(job, world, payload):
    """Start `world` ranks on the payload; every rank must exit 0. Returns
    each rank's results."""
    os.makedirs(job, exist_ok=True)
    with open(os.path.join(job, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), job, REPO],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
    out = []
    for r in range(world):
        with open(os.path.join(job, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def setup(tiny_cf, tmp_path_factory):
    """JAX's init from PRNGKey(0), a batch of 4 seeded 72 px images with
    captions of lengths 6, 3, 5, 4, JAX's draws for the step key, and an
    eval split of 8 synthetic images with weights whose BN statistics are
    calibrated on it, so that the captions differ. The vocabulary is padded
    to a multiple of 8, so that the model axis splits the embedding rows."""
    from adaptive_tpu.data.coco_api import COCO as JCOCO
    from adaptive_tpu.data.synthetic import make_synthetic_dataset
    from adaptive_tpu.data.vocab import build_vocab
    from adaptive_tpu_torch.data.loader import EvalImageDataset
    from adaptive_tpu_torch.models.factory import build_model, load_jax_weights
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    root = str(tmp_path_factory.mktemp("mp"))
    ann, resized = make_synthetic_dataset(root, num_images=8, image_size=S, seed=5)
    jvocab = build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1)
    jcf = tiny_cf.replace(
        train_batch_size=B, vocab_length=len(jvocab), resized_image_dir=resized,
        val_anno_path=ann, eval_batch_size=8, decode_max_len=6, dataloader_num_workers=2,
        vocab_pad_multiple=8)
    _, params, state = jax_weights(jcf)
    rng = np.random.default_rng(7)
    batch = {
        "images": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
        "captions": rng.integers(1, jcf.vocab_length, (B, T)).astype(np.int32),
        "lengths": np.array([6, 3, 5, 4], np.int32),
    }
    key = jax.random.PRNGKey(21)
    draws = tuple(t.numpy() for t in _jax_draws(key, B, S, jcf.train_crop_size))
    ds = EvalImageDataset(resized, ann)
    eval_images = np.stack([ds[i][0] for i in range(len(ds))])
    eval_ids = [ds[i][1] for i in range(len(ds))]
    model = build_model(port_cf(jcf), device="cpu")
    net = load_jax_weights(model, params, state)
    import torch

    calibrate_bn_(net.encoder.resnet_conv,
                  eval_preprocess(torch.as_tensor(eval_images), jcf.train_crop_size))
    return {"jcf": jcf, "params": params, "state": state, "batch": batch, "key": key,
            "draws": draws, "jvocab": jvocab, "eval_images": eval_images, "eval_ids": eval_ids,
            "eval_params": to_jax(net.state_dict(), model.arch),
            "padded_vocab": model.spec.vocab_param_dim}


def _payload(s, pcf, tasks, **extra):
    return {"cf": pcf.to_dict(), "params": (s["params"], s["state"]), "batch": s["batch"],
            "draws": s["draws"], "tasks": tasks, **extra}


def _jax_step(s, jcf, devices):
    """JAX's train step (encoder on) on a mesh over the first `devices`
    virtual devices, from the same weights, batch and key."""
    from adaptive_tpu.models.factory import build_model as jbuild
    from adaptive_tpu.training import optim as JO
    from adaptive_tpu.training import step as JST

    jm = jbuild(jcf)
    params = jax.tree.map(jnp.asarray, s["params"])
    dual, opt_state = JO.make_dual_optimizer(params, jcf)
    mesh = jmake_mesh(devices=jax.devices()[:devices], shape=jcf.mesh_shape)
    out = JST.make_train_step(jm, dual, jcf)(
        jshard_params(params, mesh), jax.tree.map(jnp.asarray, s["state"]), opt_state,
        jshard_batch(mesh, dict(s["batch"])), s["key"], True)
    return out


def _flat(params, state):
    return {k: np.asarray(v) for k, v in TC.flatten_tree({"params": params,
                                                          "state": state}).items()}


def _check_step(got, want, jcf):
    """A rank's step against JAX's: loss, BN statistics, weights (module
    docstring's rule for Adam's noise floor)."""
    np.testing.assert_allclose(got["loss"], float(want.loss), rtol=LOSS_RTOL)
    arch = jcf.encoder_backbone
    import torch

    sd = {k: torch.from_numpy(v) for k, v in got["sd"].items()}
    flat = _flat(*to_jax(sd, arch))
    ref = _flat(jax.tree.map(np.asarray, want.params), jax.tree.map(np.asarray, want.model_state))
    assert set(flat) == set(ref)
    from adaptive_tpu_torch.models.jax_params import param_keys, to_layout

    keys = {v[0]: (n, v[1]) for n, v in param_keys(arch).items()}
    lr = {"decoder": jcf.opt_rnn_adam_learning_rate, "encoder": jcf.opt_cnn_adam_learning_rate}
    for k, w in ref.items():
        d = np.abs(flat[k] - w)
        over = d > PARAM_ATOL
        if not over.any():
            continue
        assert k.startswith("params|"), k  # BN statistics within 1e-5
        name, layout = keys[k[len("params|"):]]
        g = np.abs(to_layout(torch.from_numpy(got["grads"][name]), layout))
        group_lr = lr["encoder" if "resnet" in k else "decoder"]
        assert (g[over] <= GRAD_FLOOR).all(), (k, d.max())
        assert (d[over] <= 2 * group_lr + PARAM_ATOL).all(), (k, d.max())


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """The 2-rank group at mesh (2, 1): the step, ZeRO-1, L-BFGS, coco_eval."""
    s = setup
    pcf = port_cf(s["jcf"], mesh_shape=(2, 1))
    job = str(tmp_path_factory.mktemp("two"))
    exp = os.path.join(job, "exp")
    lbfgs = {"opt_rnn_optimization": "lbfgs", "opt_rnn_lbfgs_max_iter": 4,
             "opt_rnn_lbfgs_history": 3}
    tasks = [("step", {}), ("zero", {"opt_state_sharding": "data"}), ("lbfgs", lbfgs),
             ("coco_eval", {"exp_dir": exp})]
    words = [s["jvocab"].idx2word[i] for i in range(len(s["jvocab"]))]
    out = run_ranks(job, 2, _payload(s, pcf, tasks, words=words, eval_images=s["eval_images"],
                                     eval_ids=s["eval_ids"], eval_params=s["eval_params"]))
    return pcf, job, exp, lbfgs, out


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    """The 4-rank group at mesh (2, 2): the step and the TP decodes."""
    s = setup
    pcf = port_cf(s["jcf"], mesh_shape=(2, 2))
    job = str(tmp_path_factory.mktemp("four"))
    images = np.random.default_rng(11).integers(0, 255, (8, S, S, 3), dtype=np.uint8)
    out = run_ranks(job, 4, _payload(s, pcf, [("step", {}), ("decode", {})],
                                     decode_images=images))
    return pcf, images, out


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_dp_step_matches_jax_mesh(setup, two_ranks, four_ranks, mesh):
    """Every rank's step equals JAX's on the same mesh of virtual devices;
    the model ranks of one data row hold the same rows and weights."""
    s = setup
    out = two_ranks[4] if mesh == (2, 1) else four_ranks[2]
    jcf = s["jcf"].replace(mesh_shape=mesh)
    want = _jax_step(s, jcf, int(np.prod(mesh)))
    assert [o["step"]["coords"] for o in out] == [
        tuple(int(c) for c in np.unravel_index(r, mesh)) for r in range(len(out))]
    for o in out:
        _check_step(o["step"], want, jcf)
    for o in out[1:]:
        assert o["step"]["loss"] == out[0]["step"]["loss"]


def test_zero1_equals_replicated_and_jax_restores(setup, two_ranks):
    """ZeRO-1: each rank's moments hold half of each sharded parameter's
    rows along JAX's leading dim, the weights equal the replicated step's,
    and the checkpoint rank 0 wrote (moments gathered whole) is read by
    JAX's restore_opt_state into its own tree, equal to the port's file."""
    from adaptive_tpu.training import checkpoint as JC
    from adaptive_tpu.training import optim as JO

    s = setup
    pcf, job, _, _, out = two_ranks
    for o in out:
        z, rep = o["zero"], o["step"]
        assert z["moments"], "no moment sharded"
        for name, (shard, full, dim) in z["moments"].items():
            assert shard[dim] * 2 == full[dim], name
        assert z["loss"] == rep["loss"]
        for k, v in rep["sd"].items():
            np.testing.assert_array_equal(z["sd"][k], v, err_msg=k)
    path = os.path.join(job, "zero_ckpt")
    assert not os.path.exists(os.path.join(job, "zero_ckpt.tmp"))
    jcf = s["jcf"].replace(opt_state_sharding="data")
    _, template = JO.make_dual_optimizer(jax.tree.map(jnp.asarray, s["params"]), jcf)
    restored = JC.restore_opt_state(path, template)
    with np.load(os.path.join(path, "opt.npz")) as f:
        written = dict(f)
    got = {k: np.asarray(v) for k, v in JC._flatten(restored).items()}
    assert set(got) <= set(written) and any("|mu|" in k for k in got)
    for k, v in got.items():
        np.testing.assert_array_equal(v, written[k], err_msg=k)


def test_lbfgs_step_two_ranks_equals_one(setup, two_ranks, monkeypatch):
    """The decoder L-BFGS closure step on 2 ranks (loss and gradients the
    data group's sums over the global count at every evaluation) against
    the port's one-process step: loss, n_iter, t and the weights."""
    import torch

    from adaptive_tpu_torch.models.factory import build_model, load_jax_weights
    from adaptive_tpu_torch.ops import preprocess as tpre
    from adaptive_tpu_torch.training.lbfgs import make_lbfgs_train_step
    from adaptive_tpu_torch.training.optim import make_dual_optimizer

    s = setup
    pcf, _, _, lbfgs, out = two_ranks
    cf = pcf.replace(mesh_shape=(-1, 1), **lbfgs)
    model = build_model(cf, device="cpu")
    net = load_jax_weights(model, s["params"], s["state"])
    dual = make_dual_optimizer(net, cf)
    monkeypatch.setattr(tpre, "draw_crop_flip",
                        lambda *a: tuple(torch.from_numpy(d) for d in s["draws"]))
    res = make_lbfgs_train_step(model, dual, cf)(net, s["batch"],
                                                 torch.Generator().manual_seed(0), False)
    st = dual.decoder.state[dual.decoder._params[0]]
    for o in out:
        got = o["lbfgs"]
        np.testing.assert_allclose(got["loss"], float(res.loss), rtol=LOSS_RTOL)
        assert got["n_iter"] == st["n_iter"]
        np.testing.assert_allclose(got["t"], float(st["t"]), rtol=LOSS_RTOL)
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(got["sd"][k], v.numpy(), atol=PARAM_ATOL, err_msg=k)


def test_coco_eval_two_ranks_equals_jax(setup, two_ranks, tmp_path):
    """coco_eval on 2 ranks, the batch of 8 split over the data axis and the
    ids gathered: every rank's results and CIDEr equal (==) the JAX driver's
    on its mesh; rank 1 wrote its .proc1 file."""
    from adaptive_tpu.evalcap import coco_eval as J
    from adaptive_tpu.models.factory import build_model as jbuild

    s = setup
    _, _, exp, _, out = two_ranks
    jexp = str(tmp_path / "jax")
    want = J.coco_eval(s["jcf"].replace(exp_dir=jexp), jbuild(s["jcf"]), *s["eval_params"],
                       epoch=1, vocab=s["jvocab"])
    with open(os.path.join(jexp, "val_results", "validation-1.json")) as f:
        results = json.load(f)
    for name in ("validation-1.json", "validation-1.proc1.json"):
        with open(os.path.join(exp, "val_results", name)) as f:
            assert json.load(f) == results, name
    assert len(results) == 8 and len({r["caption"] for r in results}) > 1
    for o in out:
        assert o["coco_eval"]["cider"] == want


def _jax_tp_decode(s, images, beam):
    """JAX's fused decode (Pallas in interpret mode) under shard_map on a
    (2, 2) mesh of virtual devices."""
    from adaptive_tpu.decoding import make_beam_decoder, make_greedy_decoder, spmd
    from adaptive_tpu.models.factory import build_model as jbuild

    jcf = s["jcf"].replace(mesh_shape=(2, 2))
    model = jbuild(jcf.replace(use_pallas="always"))._replace(pallas_interpret=True)
    mesh = jmake_mesh(devices=jax.devices()[:4], shape=(2, 2))
    saved = spmd.decode_mesh
    spmd.decode_mesh = lambda *_: mesh
    try:
        decode = (make_beam_decoder(model, jcf, beam_size=3) if beam
                  else make_greedy_decoder(model, jcf))
        params = jshard_params(jax.tree.map(jnp.asarray, s["params"]), mesh)
        return decode(params, jax.tree.map(jnp.asarray, s["state"]), jnp.asarray(images))
    finally:
        spmd.decode_mesh = saved


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam3"])
def test_tp_decode_matches_jax_mesh(setup, four_ranks, beam):
    """Mesh (2, 2): each rank holds half the embedding rows and half the
    prepared head's columns, and every rank's greedy ids or beam-3 paths
    equal JAX's fused decode on its (2, 2) mesh, with attention, beta and
    beam scores within 2e-4 (the port's bound against JAX); as JAX holds its
    TP decode against its one-device one (tests/test_sharding.py:271-333),
    the same ids and beam scores within 1e-5 against the port's
    one-process decode."""
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.models.factory import build_model, load_jax_weights

    s = setup
    pcf, images, out = four_ranks
    want = _jax_tp_decode(s, images, beam)
    one_cf = pcf.replace(mesh_shape=(-1, 1))
    model = build_model(one_cf, device="cpu")
    net = load_jax_weights(model, s["params"], s["state"])
    one = (make_beam_decoder(model, one_cf, beam_size=3) if beam
           else make_greedy_decoder(model, one_cf))(net, images)
    for o in out:
        d = o["decode"]
        assert d["tp"] and d["embed_rows"] * 2 == s["padded_vocab"] and d["head_cols"] * 2 == 128
        if beam:
            np.testing.assert_array_equal(d["all_ids"], np.asarray(want.all_ids))
            np.testing.assert_array_equal(d["all_ids"], one.all_ids.numpy())
            np.testing.assert_allclose(d["all_scores"], np.asarray(want.all_scores),
                                       atol=MAP_ATOL, rtol=0)
            np.testing.assert_allclose(d["all_scores"], one.all_scores.numpy(),
                                       atol=SCORE_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(d["ids"], np.asarray(want.ids))
            np.testing.assert_array_equal(d["ids"], one.ids.numpy())
            np.testing.assert_allclose(d["attention"], np.asarray(want.attention), atol=MAP_ATOL)
            np.testing.assert_allclose(d["beta"], np.asarray(want.beta), atol=MAP_ATOL)
