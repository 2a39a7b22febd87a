"""The PyTorch port's weight converters (adaptive_tpu_torch/models/
torch_import.py, examples/torch_convert_weights.py) against the JAX
package's (adaptive_tpu/models/torch_import.py) on the same in-memory
torchvision-layout and reference-layout state_dicts: the same trees, the
same trunk .npz, checkpoints that restore in both packages, and a trunk
that computes what the torch oracle computes. No torchvision, no download."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from adaptive_tpu.models import torch_import as J
from adaptive_tpu.training import checkpoint as JC
from adaptive_tpu_torch.models import torch_import as T
from adaptive_tpu_torch.models.factory import build_model
from adaptive_tpu_torch.models.jax_params import resnet_to_jax, to_jax
from adaptive_tpu_torch.models.resnet import ResNet
from adaptive_tpu_torch.training.checkpoint import flatten_tree, restore_model
from tests.test_torch_import import BasicBlock, Bottleneck, TorchResNet, _randomize_bn_stats
from tests.torch_port_util import port_cf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"resnet18": (BasicBlock, (2, 2, 2, 2)), "resnet50": (Bottleneck, (3, 4, 6, 3))}


def _torchvision_sd(arch, seed=0):
    block, stages = ARCHS[arch]
    torch.manual_seed(seed)
    tm = TorchResNet(block, stages).eval()
    _randomize_bn_stats(tm, seed)
    return tm, {**tm.state_dict(), "fc.weight": torch.zeros(10, 4), "fc.bias": torch.zeros(10)}


def _assert_same_flat(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_convert_torchvision_resnet_matches_jax(arch):
    """The port's rename gives JAX's (params, state) leaf for leaf, and the
    port's trunk on it computes what the torch oracle does (JAX's bound)."""
    tm, sd = _torchvision_sd(arch)
    rn = T.convert_torchvision_resnet(sd, arch)
    jp, js = J.convert_torchvision_resnet(sd, arch)
    _assert_same_flat(flatten_tree(dict(zip(("resnet", "state"), resnet_to_jax(rn, arch, "")))),
                      flatten_tree({"resnet": jp, "state": js}))
    net = ResNet(arch).eval()
    net.load_state_dict(rn)
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.tensor(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
        got = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_convert_torchvision_resnet_checks_keys_and_shapes():
    _, sd = _torchvision_sd("resnet18")
    del sd["layer3.1.bn2.running_var"]
    with pytest.raises(KeyError, match="layer3.1.bn2.running_var"):
        T.convert_torchvision_resnet(sd, "resnet18")
    _, sd = _torchvision_sd("resnet18")
    with pytest.raises(ValueError, match="shape"):
        T.convert_torchvision_resnet(sd, "resnet50")


def test_save_resnet_npz_is_jax_npz_and_restores_in_both(tmp_path, tiny_cf):
    """save_resnet_npz writes JAX's file (same keys, same arrays); the
    port's load_pretrained_resnet installs it, and JAX's reads it into the
    same trunk."""
    _, sd = _torchvision_sd("resnet18")
    T.save_resnet_npz(sd, "resnet18", str(tmp_path / "t.npz"))
    J.save_resnet_npz(sd, "resnet18", str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        _assert_same_flat(dict(t), dict(j))
    model = build_model(port_cf(tiny_cf), device="cpu")
    net = T.load_pretrained_resnet(str(tmp_path / "t.npz"), model.init(0))
    from adaptive_tpu.models.factory import build_model as jax_build

    jmodel = jax_build(tiny_cf)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jparams, jstate = J.load_pretrained_resnet(str(tmp_path / "t.npz"), params, state)
    got = flatten_tree(dict(zip(("resnet", "state"),
                                resnet_to_jax(net.encoder.resnet_conv.state_dict(),
                                              "resnet18", ""))))
    _assert_same_flat(got, flatten_tree({"resnet": jax.tree.map(np.asarray,
                                                                jparams["encoder"]["resnet"]),
                                         "state": jax.tree.map(np.asarray, jstate["resnet"])}))


@pytest.fixture(scope="module")
def reference_sd(tiny_cf):
    """A reference Encoder2Decoder state_dict (the reference's names, which
    the port's modules keep) with a torchvision trunk, as a .pkl holds it."""
    _, tv = _torchvision_sd("resnet18", seed=3)
    net = build_model(port_cf(tiny_cf), device="cpu").init(5)
    sd = {k: v for k, v in net.state_dict().items() if not k.startswith("encoder.resnet_conv.")}
    for k, v in T.convert_torchvision_resnet(tv, "resnet18").items():
        sd["encoder.resnet_conv." + k] = v
    return sd


def test_convert_reference_checkpoint_matches_jax(reference_sd, tiny_cf):
    sd = T.convert_reference_checkpoint(reference_sd, "adaptive_attention", "resnet18")
    jp, js = J.convert_reference_checkpoint(reference_sd, "adaptive_attention", "resnet18")
    _assert_same_flat(flatten_tree(dict(zip(("params", "state"), to_jax(sd, "resnet18")))),
                      flatten_tree({"params": jp, "state": js}))
    net = build_model(port_cf(tiny_cf), device="cpu").init(0)
    net.load_state_dict(sd)  # strict: every key of the port's model, no other
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, reference_sd[k]), k
    partial = dict(reference_sd)
    del partial["decoder.adaptive.sentinel.affine_x.weight"]
    with pytest.raises(KeyError, match="sentinel.affine_x"):
        T.convert_reference_checkpoint(partial, "adaptive_attention", "resnet18")


@pytest.mark.parametrize("variant,bi", [("baseline_attention", True), ("rnn_attention", True),
                                        ("rnn_attention", False)],
                         ids=["baseline", "rnn_bi", "rnn_uni"])
def test_convert_reference_checkpoint_variants_match_jax(tiny_cf, variant, bi):
    """A reference state_dict of the other two variants (rnn's aggregator
    with *_reverse tensors where bidirectional, none where not) converts to
    JAX's tree leaf for leaf and loads strictly into the port's model of the
    variant with the reference's values; a missing aggregator weight raises
    KeyError naming it."""
    cf = port_cf(tiny_cf, atten_model_name=variant, rnn_attention_bidirectional=bi)
    _, tv = _torchvision_sd("resnet18", seed=3)
    net = build_model(cf, device="cpu").init(5)
    ref = {k: v for k, v in net.state_dict().items() if not k.startswith("encoder.resnet_conv.")}
    for k, v in T.convert_torchvision_resnet(tv, "resnet18").items():
        ref["encoder.resnet_conv." + k] = v
    assert any(k.endswith("_reverse") for k in ref) == (variant == "rnn_attention" and bi)
    sd = T.convert_reference_checkpoint(ref, variant, "resnet18")
    jp, js = J.convert_reference_checkpoint(ref, variant, "resnet18")
    _assert_same_flat(flatten_tree(dict(zip(("params", "state"), to_jax(sd, "resnet18")))),
                      flatten_tree({"params": jp, "state": js}))
    net.load_state_dict(sd)  # strict: every key of the port's model, no other
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    partial = dict(ref)
    missing = ("decoder.adaptive.atten.lstm.weight_hh_l0" if variant == "rnn_attention"
               else "decoder.adaptive.atten.affine_g.weight")
    del partial[missing]
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        T.convert_reference_checkpoint(partial, variant, "resnet18")


def test_reference_checkpoint_restores_in_both(tmp_path, tiny_cf):
    """save_reference_checkpoint_npz writes JAX's checkpoint dir: the same
    model.npz and manifest as JAX's converter; the JAX package's
    restore_model and the port's read it to the same weights."""
    sd = build_model(port_cf(tiny_cf), device="cpu").init(9).state_dict()
    T.save_reference_checkpoint_npz(sd, "adaptive_attention", "resnet18", str(tmp_path / "t"))
    J.save_reference_checkpoint_npz(sd, "adaptive_attention", "resnet18", str(tmp_path / "j"))
    with np.load(tmp_path / "t" / "model.npz") as t, np.load(tmp_path / "j" / "model.npz") as j:
        _assert_same_flat(dict(t), dict(j))
    for d in ("t", "j"):
        with open(tmp_path / d / "manifest.json") as f:
            assert json.load(f) == {"source": "reference", "variant": "adaptive_attention"}
    from adaptive_tpu.models.factory import build_model as jax_build

    params, state = jax.jit(jax_build(tiny_cf).init)(jax.random.PRNGKey(1))
    jparams, jstate = JC.restore_model(str(tmp_path / "t"), params, state)
    net = restore_model(str(tmp_path / "j"), build_model(port_cf(tiny_cf), device="cpu").init(0),
                        "resnet18")
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    _assert_same_flat(flatten_tree(dict(zip(("params", "state"), to_jax(sd, "resnet18")))),
                      flatten_tree({"params": jax.tree.map(np.asarray, jparams),
                                    "state": jax.tree.map(np.asarray, jstate)}))


def test_pad_vocab_params_matches_jax_and_keeps_ids(tiny_cf):
    """Zero padding of the embedding and head rows equals JAX's on the same
    weights, and a vocab-padded model on the padded weights decodes the
    unpadded model's ids."""
    from adaptive_tpu_torch.decoding import make_greedy_decoder

    cf = port_cf(tiny_cf, vocab_length=30)
    model = build_model(cf, device="cpu")
    net = model.init(4)
    sd = net.state_dict()
    padded = T.pad_vocab_params(sd, 64)
    jdec = J.pad_vocab_params(to_jax(sd, "resnet18")[0]["decoder"], 64)
    got = to_jax(padded, "resnet18")[0]["decoder"]
    _assert_same_flat(flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, jdec)))
    assert T.pad_vocab_params(padded, 64)["decoder.embed.weight"].shape[0] == 64
    pcf = cf.replace(vocab_pad_multiple=64)
    pmodel = build_model(pcf, device="cpu")
    pnet = pmodel.init(0)
    pnet.load_state_dict(padded)
    imgs = np.random.default_rng(2).integers(0, 255, (2, 72, 72, 3), dtype=np.uint8)
    assert torch.equal(make_greedy_decoder(pmodel, pcf)(pnet, imgs).ids,
                       make_greedy_decoder(model, cf)(net, imgs).ids)


def test_convert_weights_cli(tmp_path, reference_sd):
    """examples/torch_convert_weights.py on a .pth and a .pkl written with
    torch.save: the converters' files."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import torch_convert_weights as cli

    _, tv = _torchvision_sd("resnet18")
    torch.save(tv, tmp_path / "r.pth")
    cli.main(["resnet", "--pth", str(tmp_path / "r.pth"), "--arch", "resnet18",
              "--out", str(tmp_path / "r.npz")])
    T.save_resnet_npz(tv, "resnet18", str(tmp_path / "want.npz"))
    with np.load(tmp_path / "r.npz") as got, np.load(tmp_path / "want.npz") as want:
        _assert_same_flat(dict(got), dict(want))
    torch.save(reference_sd, tmp_path / "m.pkl")
    cli.main(["checkpoint", "--pkl", str(tmp_path / "m.pkl"), "--arch", "resnet18",
              "--out", str(tmp_path / "ckpt")])
    assert os.path.exists(tmp_path / "ckpt" / "model.npz")
