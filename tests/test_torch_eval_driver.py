"""The PyTorch port's eval driver (evalcap/coco_eval.py) and checkpoint
reader (training/checkpoint.py) against the JAX package's, on the CPU: the
same synthetic split and weights through both drivers give the same results
JSON, CIDEr and per-image scores in greedy, beam, train, int8, valid and test
mode; a model.npz written by the JAX package restores bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from adaptive_tpu.data.coco_api import COCO as JCOCO
from adaptive_tpu.data.synthetic import make_synthetic_dataset
from adaptive_tpu.data.vocab import build_vocab
from adaptive_tpu.evalcap import coco_eval as J
from adaptive_tpu.training import checkpoint as JC
from adaptive_tpu_torch.data.vocab import Vocabulary
from adaptive_tpu_torch.evalcap import coco_eval as T
from adaptive_tpu_torch.models.jax_params import from_jax, to_jax
from adaptive_tpu_torch.training import checkpoint as TC
from tests.torch_port_util import port_cf, port_model_and_net
from tests.torch_port_util import port_threads  # noqa: F401


@pytest.fixture(scope="module")
def split(tmp_path_factory, tiny_cf):
    """The setup of tests/test_eval_driver.py: 5 synthetic images at 72 px,
    batch 4 (the last batch padded). The weights are the port's init from
    seed 0 with BN statistics calibrated on the split (resnet.calibrate_bn_),
    so the captions differ from image to image, handed to JAX as numpy."""
    from adaptive_tpu_torch.data.loader import EvalImageDataset
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    root = str(tmp_path_factory.mktemp("split"))
    ann, resized = make_synthetic_dataset(root, num_images=5, image_size=72, seed=4)
    jvocab = build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1)
    words = [jvocab.idx2word[i] for i in range(len(jvocab))]
    jcf = tiny_cf.replace(
        vocab_length=len(jvocab), resized_image_dir=resized, val_anno_path=ann,
        train_eval_anno_path=ann, test_anno_path=ann, eval_batch_size=4, decode_max_len=6,
        dataloader_num_workers=2)
    model = build_model(port_cf(jcf), device="cpu")
    net = model.init(0)
    ds = EvalImageDataset(resized, ann)
    images = torch.as_tensor(np.stack([ds[i][0] for i in range(len(ds))]))
    calibrate_bn_(net.encoder.resnet_conv, eval_preprocess(images, jcf.train_crop_size))
    params, state = to_jax(net.state_dict(), model.arch)
    return jcf, params, state, jvocab, Vocabulary(words), root


def _read(path):
    with open(path) as f:
        return json.load(f)


def _results_file(exp, mode, epoch=1):
    if mode == "train":
        return os.path.join(exp, "train_eval_results", f"train_eval-{epoch}.json")
    return os.path.join(exp, "val_results", f"validation-{epoch}.json")


MODES = {
    "greedy": ({}, {}),
    "beam3": ({"beam_size": 3}, {}),
    "train": ({}, {"train_mode": True}),
    "int8": ({"encoder_quant": "int8"}, {}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_coco_eval_matches_jax(split, tmp_path, mode):
    """Results JSON, CIDEr and per-image scores equal (==) to the JAX
    driver's; int8 runs per-channel scales that each driver calibrates on
    the split's first images."""
    from adaptive_tpu.models.factory import build_model as jax_build

    jcf, params, state, jvocab, tvocab, _ = split
    cf_kw, call_kw = MODES[mode]
    jcf = jcf.replace(**cf_kw)
    pcf = port_cf(jcf)
    jexp, texp = str(tmp_path / "jax"), str(tmp_path / "port")
    want_pi, got_pi = {}, {}
    want = J.coco_eval(jcf.replace(exp_dir=jexp), jax_build(jcf), params, state, epoch=1,
                       vocab=jvocab, per_image_out=want_pi, **call_kw)
    model, net = port_model_and_net(pcf, params, state)
    got = T.coco_eval(pcf.replace(exp_dir=texp), model, net, epoch=1, vocab=tvocab,
                      per_image_out=got_pi, **call_kw)
    results = _read(_results_file(texp, mode.replace("greedy", "val")))
    assert results == _read(_results_file(jexp, mode.replace("greedy", "val")))
    assert len(results) == 5  # one caption an image: the padded row dropped
    assert len({r["caption"] for r in results}) > 1
    assert got == want
    assert got_pi == want_pi and len(got_pi) == 5


def test_coco_eval_matches_jax_without_nltk(split, tmp_path, monkeypatch):
    """The nltk fallbacks (regex tokenizer, suffix stemmer) in both packages:
    the same results and scores. The card runs this path where nltk is
    absent."""
    from adaptive_tpu.data import tokenizer as jtok
    from adaptive_tpu.evalcap import meteor as jmet
    from adaptive_tpu_torch.data import tokenizer as ttok
    from adaptive_tpu_torch.evalcap import meteor as tmet
    from tests.test_torch_evalcap import jax_fallback_stem

    for mod in (jtok, ttok):
        monkeypatch.setattr(mod, "_TREEBANK", None)
    monkeypatch.setattr(jmet, "_STEM", jax_fallback_stem)
    monkeypatch.setattr(tmet, "_STEM", tmet._fallback_stem)
    test_coco_eval_matches_jax(split, tmp_path, "greedy")


def test_dataset_seam_changes_no_result(split, tmp_path):
    """dataset= (images served from memory) gives the results of the JPEG
    split it holds, with the same padded last batch."""
    from adaptive_tpu_torch.data.loader import EvalImageDataset

    jcf, params, state, _, tvocab, _ = split
    pcf = port_cf(jcf, exp_dir=str(tmp_path))
    ds = EvalImageDataset(jcf.resized_image_dir, jcf.val_anno_path)
    in_memory = [ds[i] for i in range(len(ds))]
    model, net = port_model_and_net(pcf, params, state)
    a, b = {}, {}
    ca = T.coco_eval(pcf, model, net, epoch=1, vocab=tvocab, per_image_out=a)
    ra = _read(_results_file(str(tmp_path), "val"))
    cb = T.coco_eval(pcf, model, net, epoch=2, vocab=tvocab, per_image_out=b, dataset=in_memory)
    assert _read(_results_file(str(tmp_path), "val", epoch=2)) == ra
    assert (ca, a) == (cb, b)


def _write_checkpoints(exp, params, state):
    """A trained_models dir whose best complete checkpoint is model-3; a
    higher-CIDEr '.tmp' staging dir and a '_step-K' dir must not be picked."""
    d = os.path.join(exp, "trained_models")
    JC.save_checkpoint(os.path.join(d, JC.checkpoint_name(0.7, 3)), params, state)
    JC.save_checkpoint(os.path.join(d, JC.checkpoint_name(0.5, 2)), params, state)
    os.makedirs(os.path.join(d, "cider-0.9000_model-4.tmp"))
    os.makedirs(os.path.join(d, "cider-0.9500_model-5_step-2"))
    return os.path.join(d, "cider-0.7000_model-3")


@pytest.mark.parametrize("mode", ["valid", "test"])
def test_checkpoint_modes_match_jax(split, tmp_path, mode):
    """valid mode with 'auto' and test mode with a path: the JAX package's
    model.npz restored by each driver; the same checkpoint picked, the same
    results file and scores, and the port's results equal its in-memory run
    on the same weights."""
    jcf, params, state, jvocab, tvocab, _ = split
    exp = str(tmp_path)
    best = _write_checkpoints(exp, params, state)
    assert TC.find_best_checkpoint(os.path.join(exp, "trained_models")) == best
    assert JC.find_best_checkpoint(os.path.join(exp, "trained_models")) == best
    knob = {"valid": {"valid_pretrained_model": "auto"}, "test": {"test_pretrained_model": best}}
    jcf = jcf.replace(exp_dir=exp, **knob[mode])
    flag = {f"{mode}_mode": True}
    name = J._results_name(best)
    path = os.path.join(exp, "val_results", name) if mode == "valid" else os.path.join(exp, name)
    want_pi, got_pi = {}, {}
    want = J.coco_eval(jcf, vocab=jvocab, per_image_out=want_pi, **flag)
    want_res = _read(path)
    os.remove(path)
    got = T.coco_eval(port_cf(jcf), vocab=tvocab, per_image_out=got_pi, device="cpu", **flag)
    assert _read(path) == want_res and len(want_res) == 5
    assert (got, got_pi) == (want, want_pi)

    pcf = port_cf(jcf, exp_dir=str(tmp_path / "mem"))
    model, net = port_model_and_net(pcf, params, state)
    assert T.coco_eval(pcf, model, net, epoch=1, vocab=tvocab) == got
    assert _read(_results_file(str(tmp_path / "mem"), "val")) == want_res


def test_restore_model_bit_for_bit(split, tmp_path):
    """A model.npz written by the JAX package's save_checkpoint restores,
    from the directory or the file, to the state_dict that from_jax gives;
    the key codec writes the JAX package's keys and arrays."""
    jcf, params, state, _, _, _ = split
    path = str(tmp_path / JC.checkpoint_name(0.25, 1))
    JC.save_checkpoint(path, params, state)
    model, _ = port_model_and_net(port_cf(jcf), params, state)
    want = from_jax(params, state, model.arch)
    for src in (path, os.path.join(path, "model.npz")):
        net = TC.restore_model(src, model.init(7), model.arch)
        got = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    tree = {"params": params, "state": state}
    jflat, tflat = JC._flatten(tree), TC.flatten_tree(tree)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    again = TC.flatten_tree(TC.unflatten_tree(tflat))
    assert set(again) == set(tflat)
    p2, s2 = to_jax(net.state_dict(), model.arch)
    assert set(TC.flatten_tree({"params": p2, "state": s2})) == set(jflat)


def test_restore_model_errors(split, tmp_path):
    """A leaf missing from the file raises KeyError naming it, as in the
    JAX package; a leaf of another shape raises ValueError."""
    jcf, params, state, _, _, _ = split
    path = str(tmp_path / "ck")
    JC.save_checkpoint(path, params, state)
    with np.load(os.path.join(path, "model.npz")) as data:
        flat = dict(data)
    gone = "params|decoder|lstm|w_hh"
    model, _ = port_model_and_net(port_cf(jcf), params, state)

    np.savez(os.path.join(path, "model.npz"), **{k: v for k, v in flat.items() if k != gone})
    with pytest.raises(KeyError, match=r"w_hh"):
        TC.restore_model(path, model.init(0), model.arch)
    with pytest.raises(KeyError, match=r"w_hh"):
        JC.restore_model(path, params, state)

    bad = dict(flat, **{gone: np.zeros((3, 3), np.float32)})
    np.savez(os.path.join(path, "model.npz"), **bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.restore_model(path, model.init(0), model.arch)


def test_valid_mode_requires_checkpoint(tiny_cf, tmp_path):
    """An empty path raises ValueError, as JAX's driver does
    (tests/test_eval_driver.py); so does 'auto' over no checkpoint."""
    cf = port_cf(tiny_cf, valid_pretrained_model="", vocab_length=25)
    with pytest.raises(ValueError, match="valid_pretrained_model"):
        T.get_testOrValid_model(cf, test_mode=False, valid_mode=True, device="cpu")
    cf = cf.replace(test_pretrained_model="auto", exp_dir=str(tmp_path))
    with pytest.raises(ValueError, match="auto"):
        T.get_testOrValid_model(cf, test_mode=True, valid_mode=False, device="cpu")
    with pytest.raises(AssertionError, match="mutually exclusive"):
        T.coco_eval(cf, train_mode=True, valid_mode=True)


def test_checkpoint_names_match_jax():
    """_results_name on the JAX package's cases; the checkpoint name codec."""
    for p in ("exp/cider-0.9300_model-9.pkl", "exp/cider-0.8100_model-3.pkl",
              "exp/cider-0.9300_model-9/", "m.msgpack", "a/b.c/model.npz", "ckpt"):
        assert T._results_name(p) == J._results_name(p)
    assert T._results_name("exp/cider-0.9300_model-9.pkl") == "exp_cider-0_9300_model-9.json"
    for cider, epoch in ((0.93, 9), (1.23456, 12)):
        name = TC.checkpoint_name(cider, epoch)
        assert name == JC.checkpoint_name(cider, epoch)
        assert TC.epoch_from_filename(name + "/") == JC.epoch_from_filename(name + "/") == epoch
    with pytest.raises(ValueError):
        TC.epoch_from_filename("no-epoch-here")
