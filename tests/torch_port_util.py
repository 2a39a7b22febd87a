"""Shared set-up of the PyTorch port's parity tests: the same weights and
inputs in the JAX package and in adaptive_tpu_torch."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from adaptive_tpu_torch.config import Config as PortConfig


def port_cf(jcf, **kw) -> PortConfig:
    """The port's Config with the JAX config's values of every field, then
    the overrides kw."""
    names = {f.name for f in dataclasses.fields(PortConfig)}
    vals = {n: getattr(jcf, n) for n in names if hasattr(jcf, n)}
    vals.update(kw)
    return PortConfig(**vals)


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


_WEIGHTS = {}


def jax_weights(jcf, seed: int = 0):
    """(JAX CaptionModel, params, state) with numpy leaves, memoized per
    config and seed within the test process (callers must not mutate)."""
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
