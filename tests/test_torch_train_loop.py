"""The PyTorch port's training loop (training/train_loop.py::main_train) and
train loader (data/loader.py) against the JAX package's, on the CPU: equal
batch plans and batches; main_train on a synthetic split, 2 epochs with the
per-epoch eval, against JAX's main_train from the same checkpoint; a JAX
checkpoint resumed by the port; mid-epoch resume bit for bit within the
port; no silent CPU path."""

import json
import os
import time

import numpy as np
import pytest
import torch

from adaptive_tpu.data import loader as JL
from adaptive_tpu.data.coco_api import COCO as JCOCO
from adaptive_tpu.data.synthetic import make_synthetic_dataset, synthetic_image
from adaptive_tpu.data.vocab import Vocabulary as JVocabulary
from adaptive_tpu.data.vocab import build_vocab
from adaptive_tpu_torch.data import loader as TL
from adaptive_tpu_torch.data.vocab import Vocabulary as TVocabulary
from adaptive_tpu_torch.training import train_loop as TT
from tests.torch_port_util import port_cf
from tests.torch_port_util import port_threads  # noqa: F401

N_IMAGES, SIZE = 8, 64


@pytest.fixture(scope="module")
def split(tmp_path_factory, tiny_cf):
    """8 synthetic images at 64 px (the crop size) with one caption each,
    their vocabulary saved as JSON, and a config pointing every split at
    them: batch 4 (2 steps an epoch), 2 epochs, fine-tuning from epoch 2,
    the per-epoch eval on."""
    root = str(tmp_path_factory.mktemp("train_split"))
    ann, resized = make_synthetic_dataset(root, num_images=N_IMAGES, image_size=SIZE, seed=5)
    vocab = build_vocab((a["caption"] for a in JCOCO(ann).anns.values()), threshold=1)
    vocab_path = os.path.join(root, "vocab.json")
    vocab.save(vocab_path)
    jcf = tiny_cf.replace(
        vocab_path=vocab_path, vocab_length=len(vocab), resized_image_dir=resized,
        train_anno_path=ann, val_anno_path=ann, train_eval_anno_path=ann,
        train_num_epochs=2, train_batch_size=4, eval_batch_size=4, decode_max_len=6,
        opt_fine_tune_cnn_start_epoch=1, train_evalOrnot=True, dataloader_num_workers=2,
        train_log_step=1, train_tb_interval_batches=3)
    return jcf, ann, resized


def _symmetric(i):
    """synthetic_image(i)'s left half and its mirror: a flip is the identity."""
    half = synthetic_image(i, SIZE)[:, : SIZE // 2]
    return np.concatenate([half, half[:, ::-1]], axis=1)


def _memory(base):
    """The train dataset with flip-symmetric images served from memory (the
    eval still reads the split's JPEGs)."""
    class Memory(base):
        def __getitem__(self, index):
            ann = self.coco.anns[self.ids[index]]
            img_id = ann["image_id"]
            return _symmetric(img_id), self.vocab.encode_caption(ann["caption"]), img_id

    return Memory


# ------------------------------------------------------------------ loader
def test_batch_plans_and_batches_equal_jax(split):
    """TrainBatches over CocoCaptionDataset (JPEGs) gives JAX's batch plan
    for each epoch and the same batches (==), at batch 3 with a leftover
    and bucket edges; pad_to_bucket and DEFAULT_BUCKETS equal."""
    jcf, ann, resized = split
    jv, tv = JVocabulary.load(jcf.vocab_path), TVocabulary.load(jcf.vocab_path)
    assert TL.DEFAULT_BUCKETS == JL.DEFAULT_BUCKETS
    for n in (1, 16, 17, 56, 80):
        assert TL.pad_to_bucket(n, TL.DEFAULT_BUCKETS) == JL.pad_to_bucket(n, JL.DEFAULT_BUCKETS)
    buckets = (8, 12, 56)
    jb = JL.TrainBatches(JL.CocoCaptionDataset(resized, ann, jv), 3, seed=4, buckets=buckets,
                         num_workers=2)
    tb = TL.TrainBatches(TL.CocoCaptionDataset(resized, ann, tv), 3, seed=4, buckets=buckets,
                         num_workers=2)
    assert len(tb) == len(jb)
    for epoch in range(3):
        jb.epoch = tb.epoch = epoch
        assert tb._batch_indices() == jb._batch_indices()
    jb.epoch = tb.epoch = 1
    for a, b in zip(tb.iter_from(1), jb.iter_from(1), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert tb.epoch == jb.epoch == 2


def test_device_prefetch_keeps_order():
    batches = [{"x": np.full((2,), i, np.int32)} for i in range(5)]
    out = list(TL.device_prefetch(iter(batches), "cpu", size=2))
    assert [int(b["x"][0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


# -------------------------------------------------------------------- loop
def _start_checkpoint(jcf, root):
    """The port's init from seed 0 with BN statistics calibrated on the
    split (so that captions differ from image to image), as a model.npz
    both loops start from."""
    from adaptive_tpu_torch.models.factory import build_model
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess
    from adaptive_tpu_torch.training import checkpoint as TC

    model = build_model(port_cf(jcf), device="cpu")
    net = model.init(0)
    images = torch.as_tensor(np.stack([_symmetric(i) for i in range(1, N_IMAGES + 1)]))
    calibrate_bn_(net.encoder.resnet_conv, eval_preprocess(images, jcf.train_crop_size))
    path = os.path.join(root, "start", "cider-0.0000_model-0")
    TC.save_checkpoint(path, net)
    return path


def _results(exp, epoch):
    out = []
    for sub, name in (("train_eval_results", "train_eval"), ("val_results", "validation")):
        with open(os.path.join(exp, sub, f"{name}-{epoch}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def both_loops(split, tmp_path_factory):
    """JAX's main_train and the port's from the same checkpoint on the same
    train split in memory, 2 epochs with the eval; the train images are
    flip-symmetric at the crop size, so augmentation is the identity in both
    (the packages draw different random numbers by design; crop_flip has its
    own test)."""
    from adaptive_tpu.training import train_loop as JT

    jcf, ann, _ = split
    root = str(tmp_path_factory.mktemp("loops"))
    start = _start_checkpoint(jcf, root)
    mp = pytest.MonkeyPatch()
    try:
        jv, tv = JVocabulary.load(jcf.vocab_path), TVocabulary.load(jcf.vocab_path)
        cfj = jcf.replace(exp_dir=os.path.join(root, "jax"), train_pretrained=True,
                          train_pretrained_model=start)
        jout = JT.main_train(cfj, dataset=_memory(JL.CocoCaptionDataset)(
            jcf.resized_image_dir, ann, jv))
        cft = port_cf(cfj, exp_dir=os.path.join(root, "port"))
        plans = []
        orig = TL.TrainBatches._batch_indices
        mp.setattr(TL.TrainBatches, "_batch_indices",
                   lambda self: plans.append(orig(self)) or plans[-1])
        tout = TT.main_train(cft, dataset=_memory(TL.CocoCaptionDataset)(
            jcf.resized_image_dir, ann, tv), device="cpu")
    finally:
        mp.undo()
    return cfj, cft, jout, tout, plans, jv, root


def test_main_train_matches_jax(both_loops):
    """Equal batch plans; per-epoch train losses within 1e-4 (relative:
    one fp32 step agrees within 1e-5, four compound); the eval's captions
    and CIDEr on train_eval and val equal (==) each epoch; the epoch
    checkpoints' manifests carry the same histories; the figure is drawn."""
    cfj, cft, jout, tout, plans, jv, root = both_loops
    jl = JL.TrainBatches(JL.CocoCaptionDataset(cfj.resized_image_dir, cfj.train_anno_path, jv),
                         cfj.train_batch_size, seed=cfj.train_random_seed)
    for epoch, plan in enumerate(plans):
        jl.epoch = epoch
        assert plan == jl._batch_indices()
    assert len(plans) == 2

    def manifest(exp, epoch):
        d = os.path.join(exp, "trained_models")
        (name,) = [n for n in os.listdir(d) if n.endswith(f"_model-{epoch}")]
        with open(os.path.join(d, name, "manifest.json")) as f:
            return name, json.load(f)

    for epoch in (1, 2):
        jname, jm = manifest(cfj.exp_dir, epoch)
        tname, tm = manifest(cft.exp_dir, epoch)
        assert tname == jname
        np.testing.assert_allclose(tm["train_epoch_losses"], jm["train_epoch_losses"], rtol=1e-4)
        assert (tm["cider_scores"], tm["cider_scores_train_eval"]) == (
            jm["cider_scores"], jm["cider_scores_train_eval"])
        assert _results(cft.exp_dir, epoch) == _results(cfj.exp_dir, epoch)
        assert "rng_key" not in tm and TT.GEN_KEY in tm and "rng_key" in jm
        for k in ("decoder_sched", "encoder_sched", "global_n_iter", "best_epoch", "epoch"):
            assert tm[k] == pytest.approx(jm[k], rel=1e-4), k
    assert tout[1:] == jout[2:]  # (best CIDEr, best epoch)
    assert os.path.exists(os.path.join(cft.exp_dir, "loss_figure_2.jpg"))
    with open(os.path.join(cft.exp_dir, "tensorboard", "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"loss-performance/train loss per epoch", "decoder_norm/decoder_lstm_norm",
            "learning_rate_per_epoch/encoder"} <= tags


def test_jax_checkpoint_resumes_in_port(both_loops):
    """The port resumes JAX's epoch-2 checkpoint (weights, BN statistics,
    moments, learning rates, schedulers, histories; the generator seeded
    afresh, since JAX's rng_key is a JAX key) and trains epoch 3."""
    cfj, cft, _, _, _, _, root = both_loops
    d = os.path.join(cfj.exp_dir, "trained_models")
    (ckpt,) = [os.path.join(d, n) for n in os.listdir(d) if n.endswith("_model-2")]
    cf3 = cft.replace(exp_dir=os.path.join(root, "resumed"), train_num_epochs=3,
                      train_pretrained_model=ckpt, train_evalOrnot=False)
    tv = TVocabulary.load(cf3.vocab_path)
    net, _, _ = TT.main_train(cf3, dataset=_memory(TL.CocoCaptionDataset)(
        cf3.resized_image_dir, cf3.train_anno_path, tv), device="cpu")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        jm = json.load(f)
    d3 = os.path.join(cf3.exp_dir, "trained_models")
    (name,) = os.listdir(d3)
    assert name.endswith("_model-3")
    with open(os.path.join(d3, name, "manifest.json")) as f:
        tm = json.load(f)
    assert tm["train_epoch_losses"][:2] == jm["train_epoch_losses"]
    assert len(tm["train_epoch_losses"]) == 3 and tm["global_n_iter"] == jm["global_n_iter"] + 2
    assert tm["cider_scores"] == jm["cider_scores"]
    assert np.isfinite(tm["train_epoch_losses"][-1])


# ---------------------------------------------------------------- resume
def _wait_for_step_ckpt(directory, timeout=30.0):
    """The AsyncCheckpointer's thread outlives the preempted main_train
    call: wait for its '_step-' write to land (atomic rename)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        hits = [n for n in os.listdir(directory) if "_step-" in n and not n.endswith(".tmp")]
        if hits:
            return os.path.join(directory, sorted(hits)[-1])
        time.sleep(0.2)
    raise AssertionError(f"no step checkpoint appeared in {directory}")


def test_mid_epoch_resume_bit_identical(split, tmp_path, monkeypatch):
    """Preempted in epoch 1 after 3 of its 4 steps (a step-2 checkpoint
    exists), auto-resumed with the same config: the weights and BN
    statistics equal (bit for bit) those of the uninterrupted run, dropout
    masks drawn from the restored generator; every step checkpoint is
    pruned."""
    jcf, ann, _ = split
    tv = TVocabulary.load(jcf.vocab_path)

    def cf_for(tag):
        exp = str(tmp_path / tag)
        return port_cf(jcf, exp_dir=exp, train_batch_size=2, train_evalOrnot=False,
                       train_checkpoint_every_steps=2, train_log_step=100,
                       train_auto_resume_dir=os.path.join(exp, "trained_models"),
                       train_dropout_rate=0.3)

    def data(cf):
        return _memory(TL.CocoCaptionDataset)(cf.resized_image_dir, ann, tv)

    cfa = cf_for("a")
    net_a, _, _ = TT.main_train(cfa, dataset=data(cfa), device="cpu")
    assert not [n for n in os.listdir(cfa.train_auto_resume_dir) if "_step-" in n]

    cfb = cf_for("b")
    calls = {"n": 0}
    orig = TT.make_train_step

    def limited(model, dual, cf, mesh=None):
        step = orig(model, dual, cf, mesh)

        def run(*a, **k):
            if calls["n"] >= 3:
                raise RuntimeError("synthetic preemption")
            calls["n"] += 1
            return step(*a, **k)

        return run

    monkeypatch.setattr(TT, "make_train_step", limited)
    with pytest.raises(RuntimeError, match="synthetic preemption"):
        TT.main_train(cfb, dataset=data(cfb), device="cpu")
    monkeypatch.setattr(TT, "make_train_step", orig)
    latest = _wait_for_step_ckpt(cfb.train_auto_resume_dir)
    with open(os.path.join(latest, "manifest.json")) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["step_in_epoch"], meta["epoch_n_steps"]) == (1, 2, 2)
    net_b, _, _ = TT.main_train(cfb, dataset=data(cfb), device="cpu")
    sa, sb = net_a.state_dict(), net_b.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert not [n for n in os.listdir(cfb.train_auto_resume_dir) if "_step-" in n]


def test_main_train_defaults_to_cuda(split, monkeypatch):
    """No silent CPU path: the default device is CUDA, which raises where
    there is no card, before any work."""
    jcf, _, _ = split
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TT.main_train(port_cf(jcf, exp_dir="/nonexistent/never-created"))
