"""The PyTorch port's repo-level programs against the JAX package's, on the
CPU: tools/torch_meteor_tables.py against tools/meteor_tables.py (the
tables byte for byte, and loaded by the port's MatchTables),
examples/torch_make_synthetic_data.py against examples/make_synthetic_data.py
(annotations and vocabulary byte for byte, images pixel for pixel) and
tools/torch_layer_bench.py against tools/layer_bench.py (the conv shapes, and
_conv_i8 at them: equal int32 accumulators, outputs within one bf16 ulp).
The JAX programs are loaded by file path, as tests/test_meteor_tables.py
loads its tool."""

import gzip
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_meteor_tables import PPDB_LINES, WORDNET_ADJ, WORDNET_NOUN
from tests.torch_port_util import port_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METEOR_ENV = ("ADAPTIVE_TPU_METEOR_SYNONYMS", "ADAPTIVE_TPU_METEOR_PARAPHRASES",
              "ADAPTIVE_TPU_METEOR_TABLES")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {"jax_mt": _load("tools/meteor_tables.py", "jax_meteor_tables"),
            "mt": _load("tools/torch_meteor_tables.py", "torch_meteor_tables"),
            "jax_lb": _load("tools/layer_bench.py", "jax_layer_bench"),
            "lb": _load("tools/torch_layer_bench.py", "torch_layer_bench")}


# ------------------------------------------------------------ METEOR tables
@pytest.fixture
def meteor_inputs(tmp_path):
    d = tmp_path / "dict"
    d.mkdir()
    (d / "data.noun").write_text(WORDNET_NOUN)
    (d / "data.adj").write_text(WORDNET_ADJ)
    (tmp_path / "ppdb.txt").write_text(PPDB_LINES)
    with gzip.open(tmp_path / "ppdb.gz", "wt", encoding="utf-8") as f:
        f.write(PPDB_LINES)
    return tmp_path


METEOR_CASES = {
    "wordnet": ["wordnet", "--dict-dir", "{dir}/dict"],
    "paraphrase": ["paraphrase", "--input", "{dir}/ppdb.txt"],
    "paraphrase_gz_min_score": ["paraphrase", "--input", "{dir}/ppdb.gz", "--min-score", "3.0"],
    "paraphrase_min_score_max_words": ["paraphrase", "--input", "{dir}/ppdb.txt",
                                       "--min-score", "0.5", "--max-words", "2"],
    "paraphrase_gz_keep_case": ["paraphrase", "--input", "{dir}/ppdb.gz", "--keep-case",
                                "--max-words", "8"],
}


@pytest.mark.parametrize("case", list(METEOR_CASES))
def test_meteor_tables_equal_jax_tool(tools, meteor_inputs, case):
    """Both tools on the same input write the same bytes."""
    args = [a.format(dir=meteor_inputs) for a in METEOR_CASES[case]]
    outs = {}
    for key in ("jax_mt", "mt"):
        out = meteor_inputs / f"{key}.txt"
        assert tools[key].main(args + ["-o", str(out)]) == 0
        outs[key] = out.read_bytes()
    assert outs["mt"] == outs["jax_mt"] and outs["mt"].count(b"\n") > 3


def test_meteor_tables_load_in_port(tools, meteor_inputs, monkeypatch):
    """The port's MatchTables loads the tool's tables as JAX's loads them,
    through the paths and through the environment variables the port reads,
    and sentence_meteor on them equals JAX's."""
    from adaptive_tpu.evalcap import meteor as JM
    from adaptive_tpu_torch.evalcap import meteor as TM

    syn, para = meteor_inputs / "syn.txt", meteor_inputs / "para.txt"
    tools["mt"].main(["wordnet", "--dict-dir", str(meteor_inputs / "dict"), "-o", str(syn)])
    tools["mt"].main(["paraphrase", "--input", str(meteor_inputs / "ppdb.gz"),
                      "--min-score", "0.5", "-o", str(para)])
    got = TM.MatchTables.load(str(syn), str(para))
    want = JM.MatchTables.load(str(syn), str(para))
    assert got.synonyms == want.synonyms and got.paraphrases == want.paraphrases
    assert got.max_phrase == want.max_phrase >= 3
    assert got.synonymous("dog", "puppy") and not got.synonymous("dog", "cat")
    for k in METEOR_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ADAPTIVE_TPU_METEOR_SYNONYMS", str(syn))
    monkeypatch.setenv("ADAPTIVE_TPU_METEOR_PARAPHRASES", str(para))
    try:
        env_tables = TM.default_tables(refresh=True)
        assert env_tables.synonyms == want.synonyms
        assert env_tables.paraphrases == want.paraphrases
    finally:
        monkeypatch.undo()
        TM.default_tables(refresh=True)
    pairs = [("a cat on top of a couch", "a cat atop a sofa"),
             ("a puppy next to a sofa", "a dog beside a couch"),
             ("a pretty dog", "a beautiful puppy")]
    for hyp, ref in pairs:
        assert TM.sentence_meteor(hyp, ref, got) == JM.sentence_meteor(hyp, ref, want)
    hyp, ref = pairs[0]
    assert TM.sentence_meteor(hyp, ref, got) > TM.sentence_meteor(hyp, ref, None)


# ----------------------------------------------------------- synthetic data
def test_make_synthetic_data_equals_jax_example(tmp_path, monkeypatch):
    """The same flags give the same annotation JSON and vocab.json bytes and
    the same image pixels."""
    from PIL import Image

    flags = ["--images", "5", "--captions-per-image", "3", "--size", "40", "--seed", "7"]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_ex = _load("examples/make_synthetic_data.py", "jax_make_synthetic_data")
    monkeypatch.setattr(sys, "argv", ["make_synthetic_data.py", "--root", str(jax_root), *flags])
    jax_ex.main()
    _load("examples/torch_make_synthetic_data.py", "torch_make_synthetic_data").main(
        ["--root", str(port_root), *flags])
    for name in ("synthetic_captions.json", "vocab.json"):
        assert (port_root / name).read_bytes() == (jax_root / name).read_bytes(), name
    files = sorted(os.listdir(jax_root / "resized" / "train2014"))
    assert len(files) == 5 and sorted(os.listdir(port_root / "resized" / "train2014")) == files
    for f in files:
        a = np.asarray(Image.open(port_root / "resized" / "train2014" / f))
        b = np.asarray(Image.open(jax_root / "resized" / "train2014" / f))
        assert a.shape == (40, 40, 3) and np.array_equal(a, b), f


# ---------------------------------------------------------- int8 layer bench
def test_layer_bench_shapes_equal_jax(tools):
    assert tools["lb"].RESNET152_CONVS == tools["jax_lb"].RESNET152_CONVS
    assert sum(c[-1] for c in tools["lb"].RESNET152_CONVS) == 155


def _ordered_bf16(t):
    """bf16 bit patterns as integers ordered like the values (one ulp apart
    = 1)."""
    v = t.view(torch.int16).to(torch.int32)
    return torch.where(v < 0, -(v & 0x7FFF), v)


@pytest.mark.parametrize("name", ["conv1", "l1.c2", "l2.c2a", "l2.ds", "l4.c3"])
def test_layer_bench_conv_equals_jax(tools, name):
    """The bench's conv (models/infer.py::_conv_i8 at the static scale) on
    its own inputs at batch 1 against the JAX package's _conv_i8 (the stem
    with its 3/3 padding, 3x3 at strides 1 and 2, 1x1 at stride 2): the
    int32 accumulators equal, the bf16 outputs within one ulp (XLA may fuse
    the fp32 rescale and bias into one FMA)."""
    from adaptive_tpu.models import infer as J

    lb = tools["lb"]
    index = [c[0] for c in lb.RESNET152_CONVS].index(name)
    _, _, _, _, k, stride, _ = lb.RESNET152_CONVS[index]
    x, kernel, bias = lb.shape_inputs(index, 1)
    xt, p = lb.to_device(x, kernel, bias, "cpu")
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    assert np.array_equal(xt.float().numpy(), np.asarray(xj, np.float32))
    pad = [(3, 3), (3, 3)] if k == 7 else None
    pj = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    want = J._conv_i8(xj, pj, stride, jnp.bfloat16, lb.X_SCALE, pad)

    xq, _ = J._quant_x(xj, lb.X_SCALE)
    wq, _ = J._quant_w(pj["kernel"])
    acc_j = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), pad or [((k - 1) // 2,) * 2] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    acc = lb.accumulator(xt, p, stride, k)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), np.asarray(acc_j))

    got = lb.conv(xt, p, stride, k)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    w16 = torch.from_numpy(np.array(want).view(np.int16)).view(torch.bfloat16)
    assert int((_ordered_bf16(got) - _ordered_bf16(w16)).abs().max()) <= 1


def test_layer_bench_main_on_cpu(tools, tmp_path):
    """The command line on the CPU at batch 1: the JAX tool's table fields,
    the device named; the default device raises without a card."""
    out = tmp_path / "table.json"
    tools["lb"].main(["--device", "cpu", "--batch", "1", "--inner", "1", "--only",
                      "l4.c2b,l4.ds", "--json", str(out)])
    table = json.loads(out.read_text())
    assert table["device"] == "cpu" and table["batch"] == 1
    assert set(table["peak_tops"]) == {"32768x1024x1024", "8192x2048x2048"}
    assert [r["name"] for r in table["rows"]] == ["l4.c2b", "l4.ds"]
    for r in table["rows"]:
        assert set(r) == {"name", "count", "ms", "total_ms", "tops", "pct_peak", "gb_s"}
        assert r["ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tools["lb"].main(["--batch", "1", "--only", "l4.c2b"])


# ---------------------------------------------------------------- imports
def test_repo_tools_import_no_jax():
    """A fresh process that imports the three programs (and runs the METEOR
    tool and the bench's conv) loads neither jax nor adaptive_tpu."""
    code = textwrap.dedent("""
        import sys, tempfile, os
        sys.path[:0] = ["tools", "examples"]
        import torch_meteor_tables, torch_layer_bench, torch_make_synthetic_data
        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "p.txt")
            with open(src, "w") as f:
                f.write("couch ||| sofa\\n")
            torch_meteor_tables.main(["paraphrase", "--input", src, "-o", src + ".out"])
        x, k, b = torch_layer_bench.shape_inputs(23, 1)
        torch_layer_bench.conv(*torch_layer_bench.to_device(x, k, b, "cpu"), 2, 1)
        bad = [m for m in sys.modules
               if m in ("jax", "adaptive_tpu") or m.startswith(("jax.", "adaptive_tpu."))]
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
