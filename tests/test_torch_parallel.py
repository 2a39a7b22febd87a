"""The PyTorch port's mesh rules and the single-process pieces of its
multi-device path (adaptive_tpu_torch/parallel, decoding/spmd.py, the
process-sharded loader), against the JAX package on the 8 virtual CPU
devices of tests/conftest.py: make_mesh's shapes, coordinates and errors;
param_sharding_rules and opt_state_sharding_rules at the shapes of
configs/coco_adaptive_v5e8.py (names mapped, the head transposed); the
shards' top-k merge with planted ties; TrainBatches(process_index=,
process_count=) as tests/test_multiprocess_input.py:110-190 holds JAX's;
place_batch's two contracts. The collectives run in
tests/test_torch_multiprocess.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.data.coco_api import COCO as JCOCO
from adaptive_tpu.data.loader import CocoCaptionDataset as JDataset
from adaptive_tpu.data.loader import TrainBatches as JTrainBatches
from adaptive_tpu.data.synthetic import make_synthetic_dataset
from adaptive_tpu.data.vocab import build_vocab
from adaptive_tpu.parallel import make_mesh as jmake_mesh
from adaptive_tpu_torch.config import load_config
from adaptive_tpu_torch.data.loader import CocoCaptionDataset, TrainBatches
from adaptive_tpu_torch.data.vocab import Vocabulary
from adaptive_tpu_torch.models.jax_params import param_keys
from adaptive_tpu_torch.parallel import (
    make_mesh, opt_state_sharding_rules, param_sharding_rules, place_batch, shard_batch,
)
from tests.torch_port_util import port_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E8 = os.path.join(REPO, "configs", "coco_adaptive_v5e8.py")
KEYS = ("images", "captions", "lengths", "img_ids")

SHAPES = [(-1, 2), (-1, 1), (8, 1), (4, 2), (2, 4), (1, -1), (2, 2, 2), (3, 2), (-1, 3), (0, -1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_make_mesh_equals_jax(shape):
    """Over 8 ranks: the shape, and rank r's coordinates, are JAX's mesh over
    8 devices (device r's place); a shape that cannot tile raises JAX's
    ValueError, word for word."""
    axes = ("data", "model", "x")[:len(shape)]
    try:
        want = jmake_mesh(shape=shape, axes=axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(world_size=8, shape=shape, axes=axes)
        assert str(got.value) == str(e)
        return
    assert make_mesh(world_size=8, shape=shape, axes=axes).shape == tuple(want.shape.values())
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for r in range(8):
        mesh = make_mesh(world_size=8, shape=shape, axes=axes, rank=r)
        assert ids[mesh.coords] == r
        assert (mesh.data_rank, mesh.model_rank) == (mesh.coords[0], mesh.coords[1])
        assert mesh.data_group is None and mesh.model_group is None


def test_make_mesh_from_config():
    """mesh_shape and mesh_axes come from the config: the v5e-8 config's
    (-1, 2) over 8 ranks is (4, 2), as JAX's make_mesh(cf)."""
    cf = load_config(V5E8)
    from adaptive_tpu.config import load_config as jload

    assert make_mesh(cf, world_size=8).shape == tuple(jmake_mesh(jload(V5E8)).shape.values())
    assert make_mesh(cf, world_size=8).axes == ("data", "model")


@pytest.fixture(scope="module")
def v5e8():
    """The port's parameters at the v5e-8 config's shapes (meta tensors),
    and JAX's parameter and optimizer-state shapes (eval_shape), with JAX's
    (4, 2) mesh over the 8 devices."""
    from adaptive_tpu.config import load_config as jload
    from adaptive_tpu.models.factory import build_model as jbuild
    from adaptive_tpu.training.optim import make_dual_optimizer as jdual
    from adaptive_tpu_torch.models.factory import Encoder2Decoder, build_model
    from adaptive_tpu_torch.training.optim import param_group_names

    cf, jcf = load_config(V5E8), jload(V5E8)
    model = build_model(cf, device="cpu")
    with torch.device("meta"):
        net = Encoder2Decoder(model.spec, model.arch)
    params = dict(net.named_parameters())
    jparams, _ = jax.eval_shape(jbuild(jcf).init, jax.random.PRNGKey(0))
    jopt = jax.eval_shape(lambda p: jdual(p, jcf)[1], jparams)
    names = param_group_names(net, cf)
    return cf, model, params, names["decoder"] + names["encoder"], jparams, jopt, jmake_mesh(jcf)


def _picked(rules, axis):
    """{JAX key: the sharded dim} of a NamedSharding tree's leaves sharded
    over `axis`."""
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(rules)[0]:
        key = "|".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", ""))))
                       for p in path)
        spec = tuple(sh.spec)
        if axis in spec:
            out[key] = spec.index(axis)
    return out


def test_param_sharding_rules_equal_jax_v5e8(v5e8):
    """The model axis splits the same tensors as JAX's rule: the embedding's
    rows and the vocab head with its bias, the head's JAX column (dim 1 of
    [H, vocab]) being torch's row (dim 0 of [vocab, H])."""
    from adaptive_tpu.parallel import param_sharding_rules as jrules

    cf, model, params, _, jparams, _, jmesh = v5e8
    want = _picked(jrules(jparams, jmesh), "model")
    got = param_sharding_rules(params, make_mesh(cf, world_size=8))
    keys = param_keys(model.arch)
    layouts = {"linear": lambda d: 1 - d, "vector": lambda d: d}
    mapped = {keys[n][0]: d for n, d in got.items() if d is not None}
    assert set(mapped) == set(want) == {"decoder|embed", "decoder|adaptive|mlp|kernel",
                                        "decoder|adaptive|mlp|bias"}
    for n, d in got.items():
        if d is not None:
            key, layout = keys[n]
            assert layouts[layout](want[key]) == d, n
    assert params["decoder.embed.weight"].shape[0] == 10240  # padded: the rule needs it


def test_opt_state_sharding_rules_equal_jax_v5e8(v5e8):
    """ZeRO-1 splits the moments of the same parameters as JAX's rule over
    the (4, 2) mesh's data axis of 4 (the decoder group's big linear
    kernels, LSTM weights, embedding and head; no convolution, whose JAX
    leading dim is its kernel height), each along JAX's leading dim."""
    from adaptive_tpu.parallel import opt_state_sharding_rules as jrules

    cf, model, params, group_names, _, jopt, jmesh = v5e8
    want = set()
    for key, dim in _picked(jrules(jopt, jmesh), "data").items():
        assert dim == 0
        for moment in ("|mu|", "|nu|", "|trace|"):
            if moment in key:
                want.add(key.split(moment, 1)[1])
    got = opt_state_sharding_rules(params, make_mesh(cf, world_size=8), model.arch)
    keys = param_keys(model.arch)
    picked = {keys[n][0] for n in group_names if got[n] is not None}
    assert picked == want and "decoder|embed" in want
    lead = {"linear": 1, "vector": 0, "conv": 2}
    for n in group_names:
        if got[n] is not None:
            assert got[n] == lead[keys[n][1]] and params[n].shape[got[n]] % 4 == 0, n


def test_opt_state_sharding_rules_small_and_indivisible():
    """JAX's test_zero1_opt_state_sharding_rules on the port's names: big
    and divisible splits, indivisible, tiny and integer stay whole; one
    rank never splits."""
    p = {"decoder.embed.weight": torch.zeros(64, 256),
         "decoder.adaptive.mlp.bias": torch.zeros(63 * 255),
         "decoder.LSTM.bias_ih_l0": torch.zeros(8),
         "decoder.LSTM.weight_hh_l0": torch.zeros(256, 64, dtype=torch.int32)}
    mesh = make_mesh(world_size=8, shape=(4, 2))
    got = opt_state_sharding_rules(p, mesh, "resnet18", min_size=1024)
    assert got == {"decoder.embed.weight": 0, "decoder.adaptive.mlp.bias": None,
                   "decoder.LSTM.bias_ih_l0": None, "decoder.LSTM.weight_hh_l0": None}
    one = make_mesh(world_size=1, shape=(-1, 1))
    assert set(opt_state_sharding_rules(p, one, "resnet18", 1024).values()) == {None}


@pytest.mark.parametrize("k", [1, 3])
def test_merge_topk_equals_jax(k):
    """The shards' lists laid side by side merge to JAX's _tp_merge_topk
    (run under vmap over a named axis of 4 shards): values planted with ties
    across and within shards, the lower global id first."""
    from adaptive_tpu.models import decoders as JD
    from adaptive_tpu_torch.models.decoders import merge_topk

    S, R = 4, 6
    rng = np.random.default_rng(k)
    vals = np.sort(rng.integers(0, 3, (S, R, k)).astype(np.float32), axis=-1)[..., ::-1]
    vals[:, 0, :] = 1.0  # every candidate of row 0 tied
    ids = np.stack([np.argsort(rng.random((R, 20)), axis=1)[:, :k] + 20 * s
                    for s in range(S)]).astype(np.int32)
    want = jax.vmap(lambda v, i: JD._tp_merge_topk(v, i, k, "m"), axis_name="m")(
        jnp.asarray(np.ascontiguousarray(vals)), jnp.asarray(ids))
    allv = torch.from_numpy(np.concatenate(list(vals), axis=1))
    alli = torch.from_numpy(np.concatenate(list(ids), axis=1))
    got = merge_topk(allv, alli, k)
    for s in range(S):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0][s]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1][s]))
    assert got[1].dtype == torch.int32 and int(got[1][0, 0]) == int(alli[0].min())


def test_embed_lookup_without_group_is_a_gather():
    from adaptive_tpu_torch.models.decoders import embed_lookup

    table = torch.randn(10, 4)
    tok = torch.tensor([3, 0, 9], dtype=torch.int32)
    assert torch.equal(embed_lookup(table, tok), table[tok])


def test_place_batch_contracts():
    """local=False keeps the data rank's rows of a global batch (rank 5 of
    (4, 2) is data rank 2), an indivisible batch raises; local=True and no
    mesh place the batch as it is."""
    batch = {"images": np.arange(16 * 3).reshape(16, 3), "lengths": np.arange(16)}
    mesh = make_mesh(world_size=8, shape=(4, 2), rank=5)
    got = shard_batch(mesh, batch)
    np.testing.assert_array_equal(got["lengths"].numpy(), [8, 9, 10, 11])
    np.testing.assert_array_equal(got["images"].numpy(), batch["images"][8:12])
    local = place_batch(mesh, batch, local=True)
    assert torch.equal(local["lengths"], torch.arange(16))
    assert torch.equal(place_batch(None, batch)["lengths"], torch.arange(16))
    with pytest.raises(ValueError, match="not divisible by the data axis 4"):
        shard_batch(mesh, {"x": np.zeros((6, 2))})


def _datasets(root, n, seed):
    ann, resized = make_synthetic_dataset(root, num_images=n, image_size=48, seed=seed)
    jv = build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1)
    path = os.path.join(root, "vocab.json")
    jv.save(path)
    return (JDataset(resized, ann, jv), CocoCaptionDataset(resized, ann, Vocabulary.load(path)),
            ann)


def _same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_process_sharded_loader_slices_locally(tmp_path):
    """Each rank's batches equal JAX's process-sharded loader's (==), and the
    two halves concatenate to the one-process global batch, with the same
    bucket (tests/test_multiprocess_input.py:110-135)."""
    jds, ds, _ = _datasets(str(tmp_path), 16, 6)
    full = list(TrainBatches(ds, 8, seed=3, num_workers=2))
    halves = [list(TrainBatches(ds, 8, seed=3, num_workers=2, process_index=i,
                                process_count=2)) for i in range(2)]
    for i in range(2):
        want = list(JTrainBatches(jds, 8, seed=3, num_workers=2, process_index=i,
                                  process_count=2))
        assert len(want) == len(halves[i]) == len(full)
        for bi, (a, b) in enumerate(zip(halves[i], want)):
            _same(a, b, f"rank {i} batch {bi}")
    for bi, ref in enumerate(full):
        lo, hi = halves[0][bi], halves[1][bi]
        assert lo["images"].shape[0] == 4
        for k in KEYS:
            np.testing.assert_array_equal(np.concatenate([lo[k], hi[k]]), ref[k])


def test_process_sharded_short_tail_wrap_pads(tmp_path):
    """drop_last=False: a short tail is wrap-padded so that both ranks take
    an equal slice and no sample is dropped; JAX's batches (==)
    (tests/test_multiprocess_input.py:138-179)."""
    jds, ds, ann = _datasets(str(tmp_path), 13, 8)
    kw = dict(batch_size=8, seed=4, num_workers=2, drop_last=False)
    full = list(TrainBatches(ds, **kw))
    halves = [list(TrainBatches(ds, **kw, process_index=i, process_count=2)) for i in range(2)]
    for i in range(2):
        want = list(JTrainBatches(jds, **kw, process_index=i, process_count=2))
        for bi, (a, b) in enumerate(zip(halves[i], want, strict=True)):
            _same(a, b, f"rank {i} batch {bi}")
    seen = []
    for bi, ref in enumerate(full):
        cat = {k: np.concatenate([halves[0][bi][k], halves[1][bi][k]]) for k in KEYS}
        n_ref = ref["img_ids"].shape[0]
        assert cat["img_ids"].shape[0] % 2 == 0
        for k, r in ref.items():
            np.testing.assert_array_equal(cat[k][:n_ref], r)
            np.testing.assert_array_equal(cat[k][n_ref:], r[: cat[k].shape[0] - n_ref])
        seen.extend(ref["img_ids"].tolist())
    assert sorted(set(seen)) == sorted(i["id"] for i in JCOCO(ann).imgs.values())


def test_process_sharded_loader_rejects_indivisible():
    with pytest.raises(ValueError, match="divisible") as got:
        TrainBatches(dataset=None, batch_size=9, process_index=0, process_count=2)
    with pytest.raises(ValueError) as want:
        JTrainBatches(dataset=None, batch_size=9, process_index=0, process_count=2)
    assert str(got.value) == str(want.value)


def test_microbatched_slices_take_each_microbatch_in_turn(tmp_path):
    """With 2 microbatches a rank's rows are its half of microbatch 0, then
    its half of microbatch 1 (the global batch's rows [0, 4) and [4, 8)),
    so that the step's k-th chunk of rows is its part of microbatch k."""
    _, ds, _ = _datasets(str(tmp_path), 16, 6)
    full = list(TrainBatches(ds, 8, seed=3, num_workers=2))
    for i in range(2):
        got = list(TrainBatches(ds, 8, seed=3, num_workers=2, process_index=i,
                                process_count=2, microbatches=2))
        for bi, ref in enumerate(full):
            rows = np.r_[2 * i:2 * i + 2, 4 + 2 * i:4 + 2 * i + 2]
            for k in KEYS:
                np.testing.assert_array_equal(got[bi][k], ref[k][rows])
