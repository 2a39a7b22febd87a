"""The PyTorch port's CLI pipeline against the JAX package's, on the CPU:
``load_config`` on every config file, its near-miss warning, ``_validate``'s
refusals and the other decoder variants' knobs; ``Experiment`` (the
experiment dir's name, the stdout tee, the config.json snapshot); the data
stages (the Karpathy split, the vocabulary, the resize) equal (``==``) to
JAX's; a pretrained trunk .npz written by JAX's ``save_resnet_npz``; and
``main(["-c", path], device="cpu")`` through every stage at tiny widths,
training with an L-BFGS decoder group."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from adaptive_tpu.config import Config as JConfig
from adaptive_tpu.config import Experiment as JExperiment
from adaptive_tpu.config import load_config as jload
from adaptive_tpu.config.experiment import get_model_description as j_description
from adaptive_tpu_torch.config import Config, load_config
from adaptive_tpu_torch.experiment import Experiment, get_model_description
from tests.test_karpathy_split import SUBSETS, _cf, _fake_coco_origin
from tests.torch_port_util import port_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.py")))


# the port's knobs that JAX's Config lacks, at their defaults: the hybrid LM
# decoder's (adaptive_tpu_torch/config.py::hybrid_lm)
PORT_ONLY = {"hybrid_lm": None}


def _fields(cf):
    """The knobs by name, JAX's and the port's alike: the port's own knobs
    are taken out, and must be at their defaults."""
    out = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cf.to_dict().items()}
    for k, default in PORT_ONLY.items():
        assert out.pop(k, default) == default
    return out


def _port_message(jax_message: str) -> str:
    """JAX's refusal with the port's list of variants, which adds the hybrid
    LM decoders to JAX's LSTM ones."""
    from adaptive_tpu_torch.config import LSTM_VARIANTS, VARIANTS

    return jax_message.replace(str(LSTM_VARIANTS), str(VARIANTS))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_load_as_jax(path, capsys):
    """Every field of every configs/*.py equals JAX's load_config's, with
    the same warnings printed. The v5e-8 config's mesh and ZeRO-1 load."""
    want = jload(path)
    want_out = capsys.readouterr().out
    got = load_config(path)
    assert capsys.readouterr().out == want_out
    assert _fields(got) == _fields(want)


def test_near_miss_warning_equal(tmp_path, capsys):
    """A file variable that is a near-miss of a knob is ignored with JAX's
    warning, word for word; helper variables stay silent."""
    p = tmp_path / "cfg.py"
    p.write_text("num_epochs = 2\nmy_data_root = '/tmp'\ntrain_hidden_size = 3\n"
                 "vocab_treshold = 4\ntrain_batch_size = 7\nimport os\n_private = 1\n")
    want = jload(str(p))
    want_out = capsys.readouterr().out
    got = load_config(str(p))
    got_out = capsys.readouterr().out
    assert got_out == want_out and "IGNORED" in got_out and "my_data_root" not in got_out
    assert _fields(got) == _fields(want) and got.train_batch_size == 7


@pytest.mark.parametrize("source", ["dict", "json", "config"])
def test_sources_equal(tmp_path, source):
    """A dict, a .json file and a Config are sources too; unknown keys of a
    dict or file are dropped, an unknown override raises KeyError."""
    vals = {"train_batch_size": 5, "mesh_axes": ["data", "model"], "not_a_knob": 1,
            "opt_rnn_optimization": "lbfgs"}
    if source == "json":
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(vals))
        src = jsrc = str(path)
    elif source == "dict":
        src = jsrc = vals
    else:
        src, jsrc = Config(train_batch_size=5), JConfig(train_batch_size=5)
    assert _fields(load_config(src)) == _fields(jload(jsrc))
    for loader in (load_config, jload):
        with pytest.raises(KeyError, match="nonsense_knob"):
            loader(None, nonsense_knob=1)


BAD = [
    {"atten_model_name": "transformer"},
    {"opt_rnn_optimization": "rmsprop"},
    {"opt_cnn_optimization": "adagrad"},
    {"compute_dtype": "float16"},
    {"use_pallas": "sometimes"},
    {"encoder_quant": "int4"},
    {"encoder_quant_granularity": "block"},
    {"opt_state_sharding": "zero3"},
    {"train_dropout_rate": 1.0},
    {"train_grad_accum_steps": 0},
    {"train_batch_size": 6, "train_grad_accum_steps": 4},
    {"opt_rnn_optimization": "lbfgs", "train_batch_size": 4, "train_grad_accum_steps": 2},
]


@pytest.mark.parametrize("bad", BAD, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_validate_refusals_equal(bad):
    """_validate's refusals: the same exception type and message as JAX's
    load_config, from load_config and from Config itself."""
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jload(None, **bad)
    with pytest.raises(want.type) as got:
        load_config(None, **bad)
    assert str(got.value) == _port_message(str(want.value))
    with pytest.raises(want.type) as direct:
        Config(**bad)
    assert str(direct.value) == _port_message(str(want.value))


VARIANT_VALUES = {
    "base_word_embed_size": ("baseline_attention", 128),
    "base_lstm_hidden_size": ("baseline_attention", 256),
    "rnn_attention_bidirectional": ("rnn_attention", False),
    "rnn_attention_embed_size": ("rnn_attention", 128),
    "rnn_attention_numlayers": ("rnn_attention", 2),
    "rnn_attention_hiddensize": ("rnn_attention", 256),
}
# the multi-device knobs (ROADMAP.md, queue 1, item 6), honoured since it landed
MESH_VALUES = {"mesh_axes": ("batch", "model"), "mesh_shape": (4, 2),
               "opt_state_sharding": "data", "distributed_init": True}


@pytest.mark.parametrize("knob", list(VARIANT_VALUES))
def test_variant_knobs_honoured(knob):
    """The other decoder variants' knobs load at another value equal to
    JAX's Config, and reach the built model's spec as JAX's build_model
    carries them (the variant's embed and hidden sizes, rnn's direction);
    rnn_attention_numlayers=2 raises JAX's exact NotImplementedError, from
    load_config and from build_model. param_dtype, train_tb_gradOrnot and
    decode_scan_prefix load at any value, as JAX reads the first two
    nowhere and the third changes no id."""
    from adaptive_tpu.models.factory import build_model as jax_build
    from adaptive_tpu_torch.models.factory import build_model

    variant, value = VARIANT_VALUES[knob]
    kw = {"atten_model_name": variant, knob: value}
    if knob == "rnn_attention_numlayers":
        with pytest.raises(NotImplementedError) as want:
            jload(None, **kw)
        with pytest.raises(NotImplementedError) as got:
            load_config(None, **kw)
        assert str(got.value) == str(want.value)
        with pytest.raises(NotImplementedError) as jb:
            jax_build(JConfig(**kw))
        cf = load_config(None, atten_model_name=variant)
        cf.rnn_attention_numlayers = value  # an assignment skips _validate
        with pytest.raises(NotImplementedError) as tb:
            build_model(cf, device="cpu")
        assert str(jb.value) == str(tb.value) == str(want.value)
        assert getattr(load_config(None, **{knob: value}), knob) == value  # not read there
        return
    cf = load_config(None, **kw)
    assert _fields(cf) == _fields(jload(None, **kw))
    spec = build_model(cf, device="cpu").spec
    assert tuple(spec) == tuple(jax_build(JConfig(**kw)).spec)
    assert value in (spec.embed_size, spec.hidden_size, spec.rnn_bidirectional)
    ok = load_config(None, param_dtype="bfloat16", train_tb_gradOrnot=False, decode_scan_prefix=5)
    assert ok.decode_scan_prefix == 5


def test_v5e8_config_loads():
    """configs/coco_adaptive_v5e8.py loads through load_config with its
    scale-out knobs as JAX reads them: mesh (-1, 2), ZeRO-1, batch 512 in 2
    microbatches, the vocabulary padded to a multiple of 128."""
    path = os.path.join(REPO, "configs", "coco_adaptive_v5e8.py")
    cf = load_config(path)
    assert _fields(cf) == _fields(jload(path))
    assert (cf.mesh_shape, cf.mesh_axes, cf.opt_state_sharding) == ((-1, 2), ("data", "model"),
                                                                    "data")
    assert (cf.train_batch_size, cf.train_grad_accum_steps, cf.vocab_pad_multiple) == (512, 2, 128)
    assert cf.distributed_init is False


def _honoured_mesh(cf, tmp_path):
    """make_mesh reads mesh_shape and mesh_axes: (4, 2) over 8 ranks."""
    from adaptive_tpu_torch.parallel import make_mesh

    mesh = make_mesh(cf, world_size=8)
    assert (mesh.shape, mesh.axes) == ((4, 2), tuple(cf.mesh_axes))


def _honoured_zero(cf, tmp_path):
    """A 2-rank step at mesh (2, 1) with the knob: each rank's Adam moments
    of the sharded parameters hold half of JAX's leading dim."""
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.models.jax_params import to_jax
    from tests.test_torch_multiprocess import run_ranks

    tiny = cf.replace(encoder_backbone="resnet18", train_crop_size=64, vocab_length=32,
                      adaptive_word_embed_size=8, adaptive_lstm_hidden_size=16,
                      train_batch_size=4, mesh_shape=(2, 1))
    model = build_model(tiny, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"images": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
             "captions": rng.integers(1, 32, (4, 5)).astype(np.int32),
             "lengths": np.array([5, 4, 3, 5], np.int32)}
    draws = (rng.integers(0, 9, 4), rng.integers(0, 9, 4), rng.random(4) < 0.5)
    out = run_ranks(str(tmp_path / "job"), 2, {
        "cf": tiny.to_dict(), "params": to_jax(model.init(0).state_dict(), model.arch),
        "batch": batch, "draws": draws, "tasks": [("zero", {})]})
    for o in out:
        assert o["zero"]["moments"]
        for name, (shard, full, dim) in o["zero"]["moments"].items():
            assert shard[dim] * 2 == full[dim], name
    assert out[0]["zero"]["loss"] == out[1]["zero"]["loss"]


def _train_cfg(tmp_path, name, **kw):
    """A config file of one tiny training epoch with its eval on a synthetic
    split of 8 images."""
    from adaptive_tpu.data.coco_api import COCO as JCOCO
    from adaptive_tpu.data.vocab import build_vocab
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path / name
    ann, resized = make_synthetic_dataset(str(root / "data"), num_images=8, image_size=72,
                                          seed=2)
    vocab = str(root / "vocab.json")
    build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1).save(vocab)
    values = {"experiment_path": str(root / "Experiments"), "vocab_path": vocab,
              "resized_image_dir": resized, "train_anno_path": ann, "val_anno_path": ann,
              "train_eval_anno_path": ann, "trainOrnot": True, "train_evalOrnot": True,
              "encoder_backbone": "resnet18", "train_crop_size": 64,
              "adaptive_word_embed_size": 8, "adaptive_lstm_hidden_size": 16,
              "train_num_epochs": 1, "train_batch_size": 4, "eval_batch_size": 4,
              "decode_max_len": 5, "dataloader_num_workers": 1, **kw}
    path = root / "cfg.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in values.items()))
    return str(path)


def _honoured_distributed_init(cf, tmp_path):
    """main with distributed_init on a world of 1: it starts a gloo process
    group for the run and ends it after, and the run equals the one without
    a group in its loss history and CIDEr."""
    import torch.distributed as dist

    from adaptive_tpu_torch.main import main
    from adaptive_tpu_torch.training import checkpoint as TCK

    started = []
    real = dist.init_process_group

    def record(backend, **kw):
        started.append((backend, kw.get("world_size")))
        return real(backend, **kw)

    runs = {}
    for name, on in (("plain", False), ("dist", True)):
        path = _train_cfg(tmp_path, name, distributed_init=on)
        dist.init_process_group = record
        try:
            main(["-c", path], device="cpu")
        finally:
            dist.init_process_group = real
        (ck,) = glob.glob(str(tmp_path / name / "Experiments" / "*" / "trained_models" /
                              "cider-*_model-1"))
        runs[name] = TCK.load_metadata(ck)
    assert started == [("gloo", 1)] and not dist.is_initialized()
    for key in ("train_epoch_losses", "cider_scores", "cider_scores_train_eval"):
        assert runs["dist"][key] == runs["plain"][key], key


HONOURED = {"mesh_shape": _honoured_mesh, "mesh_axes": _honoured_mesh,
            "opt_state_sharding": _honoured_zero, "distributed_init": _honoured_distributed_init}


@pytest.mark.parametrize("knob", list(MESH_VALUES))
def test_mesh_knobs_load_and_are_honoured(knob, tmp_path):
    """Each multi-device knob at a value off its default loads as JAX loads
    it and is honoured: mesh_shape and mesh_axes by make_mesh,
    opt_state_sharding="data" by a 2-rank step (ZeRO-1), distributed_init by
    main, which starts a process group."""
    value = MESH_VALUES[knob]
    cf = load_config(None, **{knob: value})
    assert getattr(cf, knob) == value == getattr(jload(None, **{knob: value}), knob)
    if knob == "mesh_axes":
        cf = cf.replace(mesh_shape=(4, 2))
    HONOURED[knob](cf, tmp_path)


FLAGS = [
    {},
    {"resizeOrnot": True, "vacab_build_Ornot": True, "KarpathySplitOrnot": True},
    {"trainOrnot": True},
    {"trainOrnot": True, "train_pretrained": True, "train_pretrained_model": "a/b/model-3.npz"},
    {"testOrnot": True, "test_pretrained_model": "Experiments/x/cider-0.9_model-2"},
    {"validOrnot": True, "valid_pretrained_model": "auto", "trainOrnot": True,
     "KarpathySplitOrnot": True},
]


@pytest.mark.parametrize("flags", FLAGS, ids=range(len(FLAGS)))
def test_model_description_equal(flags):
    assert get_model_description(Config(**flags)) == j_description(JConfig(**flags))


def test_experiment_snapshot_and_tee(tmp_path):
    """The experiment dir '<description>___<stamp>' under experiment_path,
    the filled-in exp_dir, model_description and log_file, and config.json
    equal JAX's (but for the paths under each run's own dir); the stdout
    tee writes logfile.log and is torn down."""
    kw = dict(trainOrnot=True, train_batch_size=7, opt_rnn_optimization="lbfgs")
    dirs = {}
    for name, cls, exp_cls in (("jax", JConfig, JExperiment), ("port", Config, Experiment)):
        stdout = sys.stdout
        exp = exp_cls(cls(experiment_path=str(tmp_path / name), **kw))
        cf = exp.setup()
        print("inside the tee")
        exp.teardown()
        assert sys.stdout is stdout
        assert os.path.basename(cf.exp_dir).startswith("Train_adaptive_attention___")
        assert cf.log_file == os.path.join(cf.exp_dir, "logfile.log")
        with open(cf.log_file) as f:
            assert "inside the tee" in f.read()
        with open(os.path.join(cf.exp_dir, "config.json")) as f:
            snap = json.load(f)
        dirs[name] = cf.exp_dir
        for k in ("experiment_path", "exp_dir", "log_file"):
            snap[k] = os.path.relpath(snap[k], str(tmp_path / name)).replace(
                os.path.basename(cf.exp_dir), "<run>")
        for k, default in PORT_ONLY.items():
            assert snap.pop(k, default) == default
        dirs[name + "_snap"] = snap
    assert dirs["port_snap"] == dirs["jax_snap"]


def test_karpathy_split_equal(tmp_path):
    """main_KarpathySplit's 8 files equal (==) JAX's on JAX's fake origin
    (tests/test_karpathy_split.py), byte for byte."""
    from adaptive_tpu.data.karpathy_split import main_KarpathySplit as j_split
    from adaptive_tpu_torch.data.karpathy_split import main_KarpathySplit

    tp, vp = _fake_coco_origin(tmp_path)
    want = j_split(_cf(tmp_path, "jax_", tp, vp))
    got = main_KarpathySplit(_cf(tmp_path, "port_", tp, vp))
    assert got == want and list(got) == SUBSETS
    for subset in SUBSETS:
        with open(tmp_path / f"jax_{subset}.json", "rb") as a, \
                open(tmp_path / f"port_{subset}.json", "rb") as b:
            assert a.read() == b.read(), subset


def test_build_vocab_equal(tmp_path):
    """main_build_vocab's file equals JAX's (the COCO API path here, JAX's
    native scanner or API there: the same captions in the same order), at
    the default threshold and at 1."""
    from adaptive_tpu.data.synthetic import make_synthetic_dataset
    from adaptive_tpu.data.vocab import main_build_vocab as j_build
    from adaptive_tpu_torch.data.vocab import main_build_vocab

    ann, _ = make_synthetic_dataset(str(tmp_path), num_images=40, captions_per_image=3,
                                    seed=4, write_images=False)
    for threshold in (5, 1):
        jp, tp = str(tmp_path / f"j{threshold}.json"), str(tmp_path / f"t{threshold}.json")
        j_build(JConfig(train_anno_path=ann, vocab_path=jp, vocab_threshold=threshold))
        v = main_build_vocab(Config(train_anno_path=ann, vocab_path=tp,
                                    vocab_threshold=threshold))
        with open(jp, "rb") as a, open(tp, "rb") as b:
            assert a.read() == b.read()
        assert len(v) > 4


def test_resize_equal(tmp_path):
    """main_resize_images' files equal JAX's byte for byte (PIL LANCZOS to
    resized_image_size, the source's format), both splits, a bad file
    skipped."""
    from PIL import Image

    from adaptive_tpu.data.resize import main_resize_images as j_resize
    from adaptive_tpu_torch.data.resize import main_resize_images

    rng = np.random.default_rng(0)
    for split in ("train2014", "val2014"):
        d = tmp_path / "raw" / split
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (90 + 9 * i, 70, 3), dtype=np.uint8)).save(
                d / f"img{i}.jpg")
    (tmp_path / "raw" / "val2014" / "broken.jpg").write_bytes(b"not a jpeg")
    for fn, out, cls in ((j_resize, "jax", JConfig), (main_resize_images, "port", Config)):
        fn(cls(image_dir=str(tmp_path / "raw"), resized_image_dir=str(tmp_path / out),
               resized_image_size=48))
    for split in ("train2014", "val2014"):
        names = sorted(os.listdir(tmp_path / "jax" / split))
        assert names == sorted(os.listdir(tmp_path / "port" / split)) and len(names) == 2
        for n in names:
            a = (tmp_path / "jax" / split / n).read_bytes()
            assert a == (tmp_path / "port" / split / n).read_bytes()
            with Image.open(tmp_path / "port" / split / n) as im:
                assert im.size == (48, 48)


def test_pretrained_trunk_equal(tmp_path, tiny_cf):
    """A trunk .npz written by JAX's save_resnet_npz (a torchvision-layout
    ResNet-18 with random BN statistics) loads through the port's get_model
    equal (exact) to JAX's get_model; the heads and decoder keep their init;
    a training checkpoint restores over the trunk; a wrong arch raises."""
    import jax

    from adaptive_tpu.models.factory import get_model as j_get_model
    from adaptive_tpu.models.torch_import import save_resnet_npz
    from adaptive_tpu_torch.models.factory import get_model
    from adaptive_tpu_torch.models.jax_params import to_jax
    from adaptive_tpu_torch.training import checkpoint as TC
    from tests.test_torch_import import BasicBlock, TorchResNet
    from tests.torch_port_util import port_cf

    torch.manual_seed(0)
    tm = TorchResNet(BasicBlock, (2, 2, 2, 2))
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    npz = str(tmp_path / "trunk.npz")
    save_resnet_npz(tm.state_dict(), "resnet18", npz)
    jcf = tiny_cf.replace(encoder_pretrained_npz=npz)
    _, jp, js, _ = j_get_model(jcf)
    _, net, start = get_model(port_cf(jcf), device="cpu")
    assert start == 1
    tp, ts = to_jax(net.state_dict(), "resnet18")
    want = TC.flatten_tree({"resnet": jax.tree.map(np.asarray, jp["encoder"]["resnet"]),
                            "state": jax.tree.map(np.asarray, js["resnet"])})
    got = TC.flatten_tree({"resnet": tp["encoder"]["resnet"], "state": ts["resnet"]})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, net0, _ = get_model(port_cf(tiny_cf), device="cpu")  # the same seed, no trunk file
    for (k, a), b in zip(net.state_dict().items(), net0.state_dict().values()):
        if not k.startswith("encoder.resnet_conv."):
            assert torch.equal(a, b), k

    ck = str(tmp_path / "cider-0.1000_model-2")
    TC.save_checkpoint(ck, net0)
    _, net2, start = get_model(port_cf(jcf, train_pretrained=True, train_pretrained_model=ck),
                               device="cpu")
    assert start == 3
    assert torch.equal(net2.encoder.resnet_conv[0].weight, net0.encoder.resnet_conv[0].weight)
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        get_model(port_cf(jcf, encoder_backbone="resnet34"), device="cpu")


def test_image_source_seam(tmp_path):
    """CocoCaptionDataset and EvalImageDataset read each image through
    image_source (called with the file's path) in place of the JPEG decode."""
    from adaptive_tpu_torch.data.loader import CocoCaptionDataset, EvalImageDataset
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset
    from adaptive_tpu_torch.data.vocab import Vocabulary

    ann, resized = make_synthetic_dataset(str(tmp_path), num_images=2, write_images=False)
    seen = []

    def source(path):
        seen.append(path)
        return np.full((5, 5, 3), len(seen), np.uint8)

    vocab = Vocabulary(["<pad>", "<start>", "<end>", "<unk>", "a"])
    image, caption, img_id = CocoCaptionDataset(resized, ann, vocab, source)[1]
    assert (image == 1).all() and img_id == 2 and caption[0] == 1
    image, img_id = EvalImageDataset(resized, ann, source)[0]
    assert (image == 2).all() and img_id == 1
    assert seen == [os.path.join(resized, "train2014", "COCO_train2014_%012d.jpg" % i)
                    for i in (2, 1)]


def _coco_origin(root, n_train, n_val, size, seed):
    """Raw COCO-style splits: train2014/ and val2014/ JPEGs of `size` px
    (the synthetic patterns) and captions_{train,val}2014.json, 2 captions
    an image from the synthetic grammar."""
    from PIL import Image

    from adaptive_tpu_torch.data.synthetic import synthetic_caption, synthetic_image

    rng = np.random.default_rng(seed)
    paths = {}
    ann_id = 1
    for split, n, offset in (("train2014", n_train, 0), ("val2014", n_val, 1000)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        images, anns = [], []
        for i in range(n):
            img_id = offset + i + 1
            name = "COCO_%s_%012d.jpg" % (split, img_id)
            Image.fromarray(synthetic_image(img_id % 97, size)).save(os.path.join(root, split, name))
            images.append({"id": img_id, "file_name": name, "height": size, "width": size})
            for _ in range(2):
                anns.append({"id": ann_id, "image_id": img_id, "caption": synthetic_caption(rng)})
                ann_id += 1
        path = os.path.join(root, "annotations", f"captions_{split}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"info": {}, "licenses": [], "images": images, "annotations": anns}, f)
        paths[split] = path
    return paths["train2014"], paths["val2014"]


def test_main_runs_every_stage(tmp_path, capsys):
    """main(["-c", config.py], device="cpu"): resize -> Karpathy split ->
    vocab -> train (1 epoch, an L-BFGS decoder group, the per-epoch eval) ->
    valid ("auto") -> test ("auto") at tiny widths. It writes the experiment
    dir (logfile.log with every stage's banner, config.json; the start,
    end and ET lines on stdout, outside the tee as in JAX), the split files at the configured sizes, the vocabulary,
    an epoch checkpoint whose opt.npz holds the L-BFGS memory
    (decoder_lbfgs|s of shape [history, n]), the eval results, and tears
    the stdout tee down."""
    data = tmp_path / "data"
    train_o, val_o = _coco_origin(str(data / "raw"), 16, 8, 80, seed=1)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
root = {str(data)!r}
experiment_path = {str(tmp_path / "Experiments")!r}
vocab_path = root + "/vocab.json"
image_dir = root + "/raw"
resized_image_dir = root + "/resized"
captions_train_origin = {train_o!r}
captions_val_origin = {val_o!r}
splited_anno_path_prefix = root + "/annotations/karpathy_split_"
train_anno_path = splited_anno_path_prefix + "train.json"
val_anno_path = splited_anno_path_prefix + "val.json"
test_anno_path = splited_anno_path_prefix + "test.json"
train_eval_anno_path = splited_anno_path_prefix + "train_eval.json"
resizeOrnot = KarpathySplitOrnot = vacab_build_Ornot = True
trainOrnot = validOrnot = testOrnot = True
valid_pretrained_model = test_pretrained_model = "auto"
num_val, num_test, num_train_eval = 4, 4, 4
num_train_overfit, num_train_hyperparameter = 2, 6
num_train_eval_hyperparameter, num_val_hyperparameter = 2, 2
resized_image_size = 72
vocab_threshold = 1
encoder_backbone = "resnet18"
train_crop_size = 64
adaptive_word_embed_size, adaptive_lstm_hidden_size = 8, 16
train_num_epochs = 1
train_batch_size = 8
eval_batch_size = 4
decode_max_len = 6
train_evalOrnot = True
train_log_step = 1
dataloader_num_workers = 2
opt_rnn_optimization = "lbfgs"
opt_rnn_lbfgs_max_iter = 3
opt_rnn_lbfgs_history = 4
""")
    from adaptive_tpu_torch.main import main

    stdout = sys.stdout
    main(["-c", str(cfg)], device="cpu")
    assert sys.stdout is stdout
    out = capsys.readouterr().out
    assert "Start Time" in out and "End Time" in out and "ET: " in out

    (exp,) = glob.glob(str(tmp_path / "Experiments" / "*"))
    assert os.path.basename(exp).startswith(
        "resize_images_size_72build_vocabulary_vocab_threshold1Karpathy_SplitTrain_"
        "adaptive_attentionTest_autoValid_auto___")
    with open(os.path.join(exp, "logfile.log")) as f:
        log = f.read()
    for banner in ("resize images", "KarpathySplit", "vocal build", "start train",
                   "start valid", "start test", "Save Path"):
        assert banner in log, banner
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["exp_dir"] == exp
    sizes = {"val": 4, "test": 4, "train": 16, "train_eval": 4, "train_overfit": 2}
    for subset, n in sizes.items():
        with open(data / "annotations" / f"karpathy_split_{subset}.json") as f:
            assert len(json.load(f)["images"]) == n, subset
    assert len(os.listdir(data / "resized" / "train2014")) == 16
    vocab = json.loads((data / "vocab.json").read_text())["words"]
    assert vocab[:4] == ["<pad>", "<start>", "<end>", "<unk>"] and len(vocab) > 20

    (ckpt,) = glob.glob(os.path.join(exp, "trained_models", "cider-*_model-1"))
    with np.load(os.path.join(ckpt, "opt.npz")) as opt:
        s, n_iter = opt["decoder_lbfgs|s"], int(opt["decoder_lbfgs|n_iter"])
    # 4 steps (32 captions, batch 8) of 2 iterations each: torch's default
    # max_eval = max_iter * 5 // 4 = 3 evaluations stops max_iter 3 at 2
    assert s.shape[0] == 4 and s.shape[1] > 1000 and n_iter == 4 * 2
    results = os.listdir(os.path.join(exp, "val_results"))
    assert "validation-1.json" in results and any(r.startswith("Experiments") or "cider" in r
                                                  for r in results)
    test_res = [r for r in os.listdir(exp) if r.endswith(".json") and "cider" in r]
    assert len(test_res) == 1
    with open(os.path.join(exp, test_res[0])) as f:
        assert len(json.load(f)) == 4


def test_main_refuses_without_card(tmp_path, monkeypatch):
    """The entry points run on the card unless asked for the CPU: with no
    card, main raises before it makes the experiment dir, and process
    before any stage."""
    from adaptive_tpu_torch.main import main, process

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"experiment_path = {str(tmp_path / 'E')!r}\nKarpathySplitOrnot = True\n")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["-c", str(cfg)])
    assert not (tmp_path / "E").exists()
    with pytest.raises(RuntimeError, match="is_available"):
        process(Config(KarpathySplitOrnot=True))
