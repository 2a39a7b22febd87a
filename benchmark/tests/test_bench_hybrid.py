"""The hybrid LM decoder's cell (granite_h_micro.greedy.b1024) run whole on
the CPU at tiny widths: the tiny copy of the benchmark (tiny.py) with the
language model's own tiny knobs written over its configuration. The cell
comes out correct, its readers load, each control of benchmark/
hybrid_controls.py makes it not correct, and its files load no JAX."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import HERE, ROOT, load_reader, per_layer_metrics, run_cell
from benchmark.hybrid_controls import adjuster
from benchmark.tests.tiny import tiny_base

CELL = "granite_h_micro.greedy.b1024"
SEEDS = (2 ** 31 + 12345, 11)
TINY_LM = {"hidden_size": 64, "shared_intermediate_size": 128, "intermediate_size": 128,
           "layer_types": ["mamba", "mamba", "attention", "mamba"], "num_hidden_layers": 4,
           "num_attention_heads": 4, "num_key_value_heads": 2, "mamba_n_heads": 4,
           "mamba_d_head": 16, "mamba_d_state": 16, "mamba_expand": 1, "mamba_chunk_size": 16,
           "vocab_length": 96, "vocab_size": 96}
TINY_MIX = {"batch": 4, "pool_batches": 2, "warmup": 1, "trace_batches": 1, "sample": 4}
# At these widths (bf16 on the CPU, six seeds) the program reads logit_gap 0
# (its captions repeat one token), replay_logit_gap 0.0052-0.0064 and
# encoder_gap 0.0075-0.0094 (the cell's ResNet-152 trunk is cut to ResNet-50
# at 64 px); the fp8 control replay_logit_gap 0.031-0.046 and encoder_gap
# 0.076-0.099, the step without D x replay_logit_gap 0.15-0.27. The tiny copy
# holds these numbers to:
TINY_LIMITS = {"logit_gap": 0.01, "replay_logit_gap": 0.02, "encoder_gap": 0.014}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    base = tmp_path_factory.mktemp("bench")
    spec = tiny_base(base)
    path = base / "configs" / "granite_h_micro.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY_LM)))
    path = base / "traffic" / "hybrid_greedy_b1024.json"
    mix = dict(json.loads(path.read_text()), **TINY_MIX, limits=TINY_LIMITS)
    path.write_text(json.dumps(mix))
    return base, spec


def run(tiny, seed, trace=False, adjust=None):
    base, spec = tiny
    return run_cell(spec, CELL, seed, 1.0, trace, device="cpu", base=base,
                    log=lambda *a, **k: None, adjust=adjust)


def test_the_cell_is_correct_at_tiny_widths(tiny):
    out = run(tiny, SEEDS[0], trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(TINY_LIMITS)
    assert "mfu.decode" in out["metrics"]  # the device readers find no card here
    for m in per_layer_metrics(tiny[1], CELL):
        assert callable(load_reader(m["name"]).read)
    plain = run(tiny, SEEDS[1])
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"captions_per_s", "setup_s"}


@pytest.mark.parametrize("mode", ["fp8", "no_dx"])
def test_each_control_is_not_correct(tiny, mode, monkeypatch):
    out = run(tiny, SEEDS[0], adjust=adjuster(mode, monkeypatch.setattr))
    assert not out["correct"], out["checks"]


def test_no_jax_in_the_cells_files():
    """The kind, the reference, the lib and the controls in a fresh
    process: no top-level name jax, jaxlib, flax or adaptive_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness as h\n"
        "import benchmark.kinds.offline_decode_hybrid, benchmark.lib.hybrid\n"
        "import benchmark.reference.granite_hybrid, benchmark.hybrid_controls\n"
        "import adaptive_tpu_torch.models.hybrid_lm, adaptive_tpu_torch.ops.ssm_step\n"
        "[h.load_reader(m['name']) for m in h.per_layer_metrics(\n"
        "  h.load_json(h.ROOT / 'BENCHMARK.json'), 'granite_h_micro.greedy.b1024')]\n"
        "print(h.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_is_the_tests_copy():
    assert ((HERE / "reference" / "granite_hybrid.py").read_bytes()
            == (ROOT / "tests" / "plain_granite_hybrid.py").read_bytes())
