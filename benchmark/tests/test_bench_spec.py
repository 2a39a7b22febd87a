"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import (
    HERE, ROOT, end_to_end_metrics, load_json, load_reader, per_layer_metrics, with_later,
)

SPEC = load_json(ROOT / "BENCHMARK.json")
WITH_LATER = with_later(SPEC)
LATER_CELLS = [w for w in WITH_LATER["workloads"] if w not in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per_tok", "embed")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"].startswith("benchmark/configs/")
    body = load_json(ROOT / cfg["file"])
    assert body["atten_model_name"] == cfg["name"]
    assert body["source"] == cfg["source"]
    for key in cfg["reduced"]:
        assert not any(w in key for w in WIDTH_WORDS) and not key.endswith(("_dim", "_rank"))
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


def _cell_files(spec, cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    assert (HERE / "kinds" / f"{traffic['kind']}.py").exists()
    assert traffic["limits"], "every cell compares at least one number"
    e2e = {m["name"] for m in end_to_end_metrics(spec, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert per_layer_metrics(spec, cell["name"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    _cell_files(SPEC, cell)


@pytest.mark.parametrize("cell", LATER_CELLS, ids=lambda w: w["name"])
def test_later_cell_files(cell):
    """A cell kept in later.json keeps BENCHMARK.json's form, its readers
    load, and its name is not in BENCHMARK.json."""
    assert cell["name"] not in {w["name"] for w in SPEC["workloads"]}
    _cell_files(WITH_LATER, cell)
    for m in per_layer_metrics(WITH_LATER, cell["name"]):
        assert callable(load_reader(m["name"]).read)


def test_names_units_and_pairs():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    """Its reader loads by name, and each cell it lists reports the
    end-to-end metric it moves."""
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["workloads"], "every per-layer metric lists its cells"
    assert callable(load_reader(metric["name"]).read)
    moves = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in {w["name"] for w in SPEC["workloads"]}
        assert cell in moves.get("workloads", [cell])
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert metric["layer"] in layers and "\n" not in metric["layer"]


def test_no_jax_in_a_run_process():
    """Every module the harness, the kinds, the readers and the reference
    import, in a fresh process: no top-level name jax, jaxlib, flax or
    adaptive_tpu (compared whole)."""
    code = (
        "import sys, glob, os; sys.path.insert(0, %r)\n"
        "import benchmark.harness as h\n"
        "import benchmark.kinds.offline_decode, benchmark.kinds.train_steps\n"
        "import benchmark.kinds.serve_open_loop, benchmark.reference.train\n"
        "import benchmark.lib.served, benchmark.lib.readings, benchmark.lib.stage_split\n"
        "import adaptive_tpu_torch.decoding, adaptive_tpu_torch.serving\n"
        "import adaptive_tpu_torch.training.step, adaptive_tpu_torch.data.loader\n"
        "[h.load_reader(os.path.basename(p)[:-3]) for p in glob.glob(%r)]\n"
        "print(h.forbidden_modules())\n" % (str(ROOT), str(HERE / "metrics" / "*.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("adaptive_tpu_torch", "adaptive_tpu", "jax", "flax"), (path, name)


def test_nothing_reads_the_jax_bench():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "adaptive_tpu",
                                              "bench", "chip_smoke"), (path, name)
