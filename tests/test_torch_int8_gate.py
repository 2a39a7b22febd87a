"""The PyTorch port's int8 quality gate (tools/torch_int8_gate.py) on the
CPU: the tool end to end at a tiny width, its ladder mode by mode equal
(==) to the JAX package's coco_eval on the same JAX checkpoint, and its
paired bootstrap equal to the JAX gate's own code on the same scores."""

import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.torch_port_util import port_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_int8_gate as gate  # noqa: E402

TINY = dict(encoder_backbone="resnet18", train_crop_size=64, resized_image_size=72,
            adaptive_word_embed_size=8, adaptive_lstm_hidden_size=16, train_batch_size=4,
            train_grad_accum_steps=1, eval_batch_size=4, decode_max_len=6,
            compute_dtype="float32", dataloader_num_workers=1)


def test_gate_end_to_end_tiny(tmp_path):
    """Train 1 epoch on 8 synthetic images (fine-tuning on), score the six
    modes; gate_results.json is well formed and (b), (c) caption every
    image as the per-tensor control does."""
    out = gate.run_gate(str(tmp_path), {**TINY, "train_num_epochs": 1,
                                        "opt_fine_tune_cnn_start_epoch": 1},
                        device="cpu", images=8)
    with open(tmp_path / "gate_results.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(out))
    names = [name for name, _, _ in gate.LADDER]
    assert list(written["modes"]) == names and written["n_images"] == 8
    assert "model-1" in written["checkpoint"]
    for name in names[1:]:
        m = written["modes"][name]
        assert np.isfinite(m["cider"]) and m["paired_ci95"][0] <= m["paired_ci95"][1]
        assert m["delta"] == pytest.approx(m["cider"] - written["modes"][names[0]]["cider"])
    assert written["captions_differ_from_control"] == {names[4]: 0, names[5]: 0}
    assert set(written["per_image"][names[0]]) == {str(i) for i in range(1, 9)}


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory, tiny_cf):
    """A 6-image synthetic split with its JPEGs, a vocabulary, and a JAX
    checkpoint of weights whose BN statistics are calibrated on the split
    and whose heads and decoder matrices are drawn at 3x their init scale,
    so that the images caption apart (handed to JAX as numpy), written by
    the JAX package."""
    from adaptive_tpu.data.coco_api import COCO as JCOCO
    from adaptive_tpu.data.synthetic import make_synthetic_dataset
    from adaptive_tpu.data.vocab import build_vocab
    from adaptive_tpu.training import checkpoint as JC
    from adaptive_tpu_torch.data.loader import EvalImageDataset
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.models.jax_params import to_jax
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess
    from tests.torch_port_util import port_cf

    root = str(tmp_path_factory.mktemp("gate"))
    ann, resized = make_synthetic_dataset(root, num_images=6, image_size=72, seed=4)
    vocab = build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1)
    vocab_path = os.path.join(root, "vocab.json")
    vocab.save(vocab_path)
    jcf = tiny_cf.replace(vocab_length=len(vocab), vocab_path=vocab_path,
                          resized_image_dir=resized, val_anno_path=ann, eval_batch_size=4,
                          decode_max_len=6, dataloader_num_workers=1)
    model = build_model(port_cf(jcf), device="cpu")
    net = model.init(0)
    ds = EvalImageDataset(resized, ann)
    images = torch.as_tensor(np.stack([ds[i][0] for i in range(len(ds))]))
    calibrate_bn_(net.encoder.resnet_conv, eval_preprocess(images, jcf.train_crop_size))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # heads and decoder that tell the images apart
        for name, p in net.named_parameters():
            if name.startswith(("encoder.affine", "decoder.")) and p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 3 / p.shape[1] ** 0.5)
    params, state = to_jax(net.state_dict(), model.arch)
    ckpt = os.path.join(root, "cider-0.5000_model-3")
    JC.save_checkpoint(ckpt, params, state)
    return jcf, ckpt, root


def test_ladder_matches_jax_coco_eval(jax_checkpoint, tmp_path):
    """Each mode's CIDEr and per-image scores == JAX's coco_eval in valid
    mode on the same checkpoint: JAX's four modes by name, and (b), (c)
    against JAX's per-tensor mode, whose captions the kernels reproduce."""
    from adaptive_tpu.evalcap.coco_eval import coco_eval as jax_coco_eval
    from tests.torch_port_util import port_cf

    jcf, ckpt, root = jax_checkpoint
    rows, captions = gate.score_ladder(port_cf(jcf), ckpt, str(tmp_path / "port"), device="cpu")
    jax_modes = {}
    for name, quant, fields in gate.LADDER:
        if fields:
            continue
        per = {}
        c = jcf.replace(valid_pretrained_model=ckpt, exp_dir=str(tmp_path / "jax"), **quant)
        jax_modes[name] = (jax_coco_eval(c, valid_mode=True, per_image_out=per), per)
    for name, cider, per in rows:
        ref = gate.CONTROL if name not in jax_modes else name
        assert (cider, per) == jax_modes[ref], name
    assert captions[gate.LADDER[4][0]] == captions[gate.CONTROL] == captions[gate.LADDER[5][0]]
    assert len(set(captions[gate.LADDER[0][0]].values())) > 1  # the images caption apart


def _jax_gate_table(rows):
    """tools/int8_gate.py's own paired bootstrap (the code between its
    ladder and its results file), run on rows."""
    with open(os.path.join(REPO, "tools", "int8_gate.py")) as f:
        src = f.read()
    start = src.index("    base_name, base, base_per = rows[0]")
    end = src.index("    with open(os.path.join(args.workdir")
    ns = {"rows": rows, "ckpt": "ckpt", "np": np, "print": lambda *a, **k: None}
    exec(textwrap.dedent(src[start:end]), ns)
    return ns["out"]


def test_bootstrap_equals_jax_gate_code():
    """paired_table == the JAX gate's code on the same per-image scores."""
    rng = np.random.default_rng(5)
    ids = list(range(1, 41))
    rows = [(name, float(rng.random()), {i: {"CIDEr": float(rng.random())} for i in ids})
            for name, _, _ in gate.LADDER]
    rows[4] = (rows[4][0], rows[1][1], rows[1][2])  # a mode equal to another: deltas repeat
    out, lines = gate.paired_table(rows, "ckpt")
    assert out == _jax_gate_table(rows)
    assert len(lines) == 2 + len(rows)
