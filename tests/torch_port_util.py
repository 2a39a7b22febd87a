"""Shared set-up of the PyTorch port's tests: the thread rule every port
test module imports, and the same weights and inputs in the JAX package and
in adaptive_tpu_torch. JAX is imported only by the helpers that use it, so a
module run without JAX (the card's tests) can import the rule."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from adaptive_tpu_torch.config import Config as PortConfig


@pytest.fixture(scope="module", autouse=True)
def port_threads():
    """The thread rule of the port's test modules (import it by name): under
    pytest-xdist, each worker runs torch's intra-op pool on its share of the
    cores this process may use, at least 1, so no worker's idle threads spin
    on cores that another worker's threads need; outside xdist torch keeps
    its default. Yields the count it found, torch's default, and restores it
    after the module, since a worker also runs the JAX package's tests."""
    found = torch.get_num_threads()
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
    try:
        yield found
    finally:
        torch.set_num_threads(found)


@pytest.fixture
def default_threads(port_threads):
    """One case at torch's default count instead of the rule's: for a case
    whose bounds were set at that count and fail at fewer threads (listed in
    ROADMAP.md §7 h)."""
    ruled = torch.get_num_threads()
    torch.set_num_threads(port_threads)
    try:
        yield
    finally:
        torch.set_num_threads(ruled)


def port_cf(jcf, **kw) -> PortConfig:
    """The port's Config with the JAX config's values of every field, then
    the overrides kw."""
    names = {f.name for f in dataclasses.fields(PortConfig)}
    vals = {n: getattr(jcf, n) for n in names if hasattr(jcf, n)}
    vals.update(kw)
    return PortConfig(**vals)


def np_tree(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a), tree)


_WEIGHTS = {}


def jax_weights(jcf, seed: int = 0):
    """(JAX CaptionModel, params, state) with numpy leaves, memoized per
    config and seed within the test process (callers must not mutate)."""
    import jax

    from adaptive_tpu.models.factory import build_model

    key = (repr(jcf), seed)
    if key not in _WEIGHTS:
        model = build_model(jcf)
        params, state = jax.jit(model.init)(jax.random.PRNGKey(seed))
        _WEIGHTS[key] = (model, np_tree(params), np_tree(state))
    return _WEIGHTS[key]


def random_weights(jcf, seed: int = 0):
    """(params, state) of the JAX model's tree structure and shapes, every
    leaf drawn from numpy (no JAX init program to compile)."""
    import jax

    from adaptive_tpu.models.factory import build_model

    shapes = jax.eval_shape(build_model(jcf).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape, dtype=np.float32), shapes)


def port_model_and_net(pcf, params, state):
    """The port's CPU model and an Encoder2Decoder holding the JAX weights."""
    from adaptive_tpu_torch.models.factory import build_model, load_jax_weights

    model = build_model(pcf, device="cpu")
    return model, load_jax_weights(model, params, state)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)
