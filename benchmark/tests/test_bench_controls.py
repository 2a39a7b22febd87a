"""The controls that set each limit's upper reading (benchmark/controls.py),
at tiny widths on the CPU: with the control or a fault in the program's
place, each cell's run comes out not correct; with the program, correct.
On the card they run at the cells' own sizes (PERF.md gives the
readings)."""

from __future__ import annotations

import pytest
import torch

from benchmark.controls import adjuster
from benchmark.harness import run_cell
from benchmark.tests.tiny import tiny_base

SEEDS = (11, 2 ** 31 + 7, 99991)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    base = tmp_path_factory.mktemp("bench")
    return base, tiny_base(base)


def correct(tiny, cell, mode, seed):
    base, spec = tiny
    return run_cell(spec, cell, seed, 1.0, False, device="cpu", base=base,
                    log=lambda *a, **k: None, adjust=adjuster(mode))["correct"]


CASES = [("adaptive.greedy.b1024", "fp8"), ("adaptive.serve.b32", "fp8"),
         ("adaptive.greedy.b1024", "int8"), ("adaptive.serve.b32", "int8"),
         ("baseline.train.frozen.b256", "fp8"), ("baseline.train.frozen.b256", "half"),
         ("adaptive.train.finetune.b256", "fp8"), ("adaptive.train.finetune.b256", "half")]


@pytest.mark.parametrize("cell,mode", CASES)
def test_the_control_is_not_correct(tiny, cell, mode):
    assert not any(correct(tiny, cell, mode, s) for s in SEEDS)


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_the_program_is_correct(tiny, cell):
    assert all(correct(tiny, cell, "program", s) for s in SEEDS[:2])
