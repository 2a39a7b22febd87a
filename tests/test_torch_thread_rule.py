"""The thread rule of the port's test modules (tests/torch_port_util.py):
every port test module that runs torch on the CPU imports port_threads,
which under pytest-xdist gives torch each worker's share of the usable
cores, and default_threads runs a case at the count the rule found."""

import ast
import os
from pathlib import Path

import torch

from tests.torch_port_util import default_threads, port_threads  # noqa: F401

TESTS = Path(__file__).resolve().parent
# the card's tests (they skip on the CPU) and the JAX package's own
# tests of its torch checkpoint importer
EXEMPT = {"test_torch_cuda_kernels.py", "test_torch_import.py"}


def test_every_port_module_imports_the_rule():
    missing = []
    for path in sorted(TESTS.glob("test_torch_*.py")):
        if path.name in EXEMPT:
            continue
        names = {a.asname or a.name for n in ast.parse(path.read_text()).body
                 if isinstance(n, ast.ImportFrom)
                 and n.module in ("tests.torch_port_util", "torch_port_util")
                 for a in n.names}
        if "port_threads" not in names:
            missing.append(path.name)
    assert not missing, missing


def test_rule_then_default_count(port_threads, request):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    share = max(1, len(os.sched_getaffinity(0)) // int(workers)) if workers else port_threads
    assert torch.get_num_threads() == share
    request.getfixturevalue("default_threads")
    assert torch.get_num_threads() == port_threads
