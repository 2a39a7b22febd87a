"""Whole runs of the cells on the CPU at tiny widths (benchmark/tests/
tiny.py), skipping only the harness's look for a card: each comes out
correct; a cell added as new files runs with no file edited; and each fault
a cell can have, planted in the program underneath the timed path, makes
`correct` false."""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import ROOT, run_cell
from benchmark.tests.tiny import tiny_base

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    base = tmp_path_factory.mktemp("bench")
    return base, tiny_base(base)


def run(tiny, cell, seconds=1.0, trace=False, spec=None):
    base, default = tiny
    return run_cell(spec or default, cell, SEED, seconds, trace, device="cpu", base=base,
                    log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", ["adaptive.greedy.b1024", "adaptive.train.finetune.b256",
                                  "baseline.train.frozen.b256", "adaptive.serve.b32"])
def test_cell_is_correct_at_tiny_widths(tiny, cell):
    out = run(tiny, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"


def test_end_to_end_metrics_of_a_plain_run(tiny):
    out = run(tiny, "adaptive.greedy.b1024")
    assert set(out["metrics"]) == {"captions_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_a_cell_added_as_files_runs(tiny):
    """A new mix is one traffic file and one entry of BENCHMARK.json."""
    base, spec = tiny
    mix = json.loads((base / "traffic" / "greedy_b1024.json").read_text())
    mix.update(batch=2, sample=2)
    (base / "traffic" / "greedy_b2.json").write_text(json.dumps(mix))
    spec = copy.deepcopy(spec)
    spec["workloads"].append({"name": "baseline.greedy.b2", "config": "baseline_attention",
                              "traffic": "greedy_b2", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("baseline.greedy.b2")
    out = run(tiny, "baseline.greedy.b2", spec=spec)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"captions_per_s", "setup_s"}


def _altered_token(monkeypatch):
    """Kernel 2's pick, or the head's argmax, moved to another token for
    row 0 at every step."""
    from adaptive_tpu_torch.models import decoders

    real = decoders.greedy_decode_step

    def altered(*a, **k):
        nxt, alpha, beta, st = real(*a, **k)
        nxt = nxt.clone()
        nxt[0] = (nxt[0] + 7) % 50 + 4
        return nxt, alpha, beta, st

    monkeypatch.setattr(decoders, "greedy_decode_step", altered)


@pytest.mark.parametrize("cell", ["adaptive.greedy.b1024", "adaptive.serve.b32"])
def test_an_altered_token_is_not_correct(tiny, monkeypatch, cell):
    _altered_token(monkeypatch)
    assert not run(tiny, cell)["correct"]


def _scaled_features(monkeypatch):
    """The encoder's outputs (V, v_g, h0, c0) 3% too large where the
    encoder produces them."""
    from adaptive_tpu_torch.models.factory import CaptionModel

    real = CaptionModel.encode_inference

    def scaled(self, prepared, images):
        return tuple(1.03 * t for t in real(self, prepared, images))

    monkeypatch.setattr(CaptionModel, "encode_inference", scaled)


@pytest.mark.parametrize("cell", ["adaptive.greedy.b1024", "adaptive.serve.b32"])
def test_an_altered_encoder_output_is_not_correct(tiny, monkeypatch, cell):
    _scaled_features(monkeypatch)
    out = run(tiny, cell)
    assert not out["correct"]
    assert out["checks"]["encoder_gap"]["value"] > out["checks"]["encoder_gap"]["limit"]


def _unchanged_state(monkeypatch):
    """An optimizer step that returns its state unchanged."""
    from adaptive_tpu_torch.training import optim

    monkeypatch.setattr(optim.DualOptimizer, "step", lambda self, name, closure=None: None)


def _half_batch(monkeypatch):
    """The loss over half of the batch, the mean taken over the rest."""
    from adaptive_tpu_torch.training import step

    real = step.masked_ce_sum

    def half(scores, captions, lengths):
        h = scores.shape[0] // 2
        return real(scores[:h], captions[:h], lengths[:h])

    monkeypatch.setattr(step, "masked_ce_sum", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch], ids=["unchanged", "half"])
@pytest.mark.parametrize("cell", ["adaptive.train.finetune.b256", "baseline.train.frozen.b256"])
def test_a_train_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not run(tiny, cell)["correct"]


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "adaptive.greedy.b1024", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr
