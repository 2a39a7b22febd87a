"""The device mesh over torch.distributed's ranks and its sharding rules
(counterpart of adaptive_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of devices
with ``('data', 'model')`` axes and lets GSPMD insert the collectives. Here
there is one process per card, launched by ``torchrun``, and the mesh spans
the ranks of the default process group:

* rank r sits at ``np.unravel_index(r, shape)``, the row-major order of JAX's
  ``np.asarray(devices).reshape(shape)``; on a (D, M) mesh that is
  (r // M, r % M);
* the **data group** holds the ranks that share every coordinate but the
  first (a batch is split over it; gradients and BN moments are summed over
  it), the **model group** those that share every coordinate but the second
  (the decode's embedding rows and vocab-head columns are split over it);
* the groups come from ``dist.new_group``, built once per world and shape and
  on every rank in the same order, with the default group's backend (gloo
  takes CUDA tensors too, so two ranks may share one card).

Where no process group is initialised the world is 1: a mesh can still be
laid out (``world_size=``), for its shape and rules, but it holds no group.
``param_sharding_rules`` and ``opt_state_sharding_rules`` name the port's
parameters (state_dict names) and the torch dim each splits on. The rules
are JAX's, read in JAX's layouts: the vocab head's ``nn.Linear.weight`` is
[vocab, H], so JAX's column rule on the [H, vocab] kernel is a row rule
here; ZeRO-1's rule tests JAX's leading dim, which is torch's dim 1 of a
linear or LSTM weight and dim 2 of a convolution's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """A mesh of the world's ranks. ``coords`` is this rank's place;
    ``data_group``/``model_group`` are None where no process group runs (or
    for an axis of size 1, whose collectives are the identity)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    coords: Tuple[int, ...]
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def data_rank(self) -> int:
        return self.coords[0]

    @property
    def model_size(self) -> int:
        return self.shape[1] if len(self.shape) > 1 else 1

    @property
    def model_rank(self) -> int:
        return self.coords[1] if len(self.coords) > 1 else 0

    @property
    def rows(self) -> Optional[Tuple[int, int]]:
        """(index, count): this rank's rows are block index of count equal
        blocks of the global batch (the random draws' contract,
        ops/preprocess.py, ops/dropout.py); None at data size 1."""
        return (self.data_rank, self.data_size) if self.data_size > 1 else None


def get_world_size() -> int:
    """The default process group's size; 1 where none is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def mesh_shape(n: int, shape: Sequence[int], axes: Sequence[str]) -> Tuple[int, ...]:
    """The shape with its -1 wildcard sized to n ranks; JAX's two ValueErrors
    (make_mesh, adaptive_tpu/parallel/mesh.py:26-49) word for word, with
    "device(s)" for ranks."""
    shape = list(shape)
    fixed = int(np.prod([s for s in shape if s != -1]))
    if fixed <= 0 or (any(s == -1 for s in shape) and n % fixed):
        raise ValueError(
            f"config mesh_shape {tuple(shape)} cannot tile {n} available "
            f"device(s): the fixed axes multiply to {fixed}. Set mesh_shape "
            f"so the product of fixed axes divides the device count (use -1 "
            f"for at most one wildcard axis), e.g. (-1, 1) for pure data "
            f"parallelism."
        )
    out = tuple(n // fixed if s == -1 else s for s in shape)
    if int(np.prod(out)) != n:
        raise ValueError(
            f"config mesh_shape {out} requires {int(np.prod(out))} "
            f"devices but {n} are available. Fix mesh_shape (axes "
            f"{tuple(axes)}) so its product equals the device count, or use -1 "
            f"for one axis to auto-size it."
        )
    return out


_GROUPS: Dict[Any, Tuple[Any, Any]] = {}


def _axis_groups(shape: Tuple[int, ...], rank: int, axis: int):
    """The group of the ranks that differ from `rank` only along `axis`; every
    such group is created, on every rank, in one order (dist.new_group's
    contract). None for an axis of size 1."""
    if axis >= len(shape) or shape[axis] == 1:
        return None
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    lines = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
    mine = None
    for line in lines:
        g = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = g
    return mine


def make_mesh(cf=None, world_size: Optional[int] = None, shape=None, axes=None,
              rank: Optional[int] = None) -> Mesh:
    """A Mesh from the config (mesh_shape with a -1 wildcard, mesh_axes) or
    explicit arguments, over the default process group's ranks, or over
    `world_size` ranks laid out only (then rank defaults to 0 and no group
    is made). Collective where a process group runs: every rank calls it
    with the same arguments; the groups are made once per world and shape."""
    axes = tuple(axes if axes is not None else (cf.mesh_axes if cf else ("data", "model")))
    shape = tuple(shape if shape is not None else (cf.mesh_shape if cf else (-1, 1)))
    live = world_size is None or world_size == get_world_size()
    n = get_world_size() if world_size is None else world_size
    out = mesh_shape(n, shape, axes)
    r = get_rank() if rank is None else rank
    coords = tuple(int(c) for c in np.unravel_index(r, out))
    if not (live and n > 1 and dist.is_initialized()):
        return Mesh(out, axes, r, coords)
    key = (id(dist.group.WORLD), out)
    if key not in _GROUPS:
        _GROUPS[key] = (_axis_groups(out, r, 0), _axis_groups(out, r, 1))
    data_group, model_group = _GROUPS[key]
    return Mesh(out, axes, r, coords, data_group, model_group)


def _rows(n: int, mesh: Mesh, key) -> slice:
    if n % mesh.data_size:
        raise ValueError(
            f"global batch dim {n} not divisible by the data axis {mesh.data_size} (key {key!r})")
    rows = n // mesh.data_size
    return slice(mesh.data_rank * rows, (mesh.data_rank + 1) * rows)


def place_batch(mesh: Optional[Mesh], batch: Dict[str, Any], device=None,
                local: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's rows of one host batch dict, as tensors on `device`. Two
    input contracts (JAX's place_batch):

    * local=True: `batch` holds only this rank's rows (the process-sharded
      loader, TrainBatches(process_index=..., process_count=...));
    * local=False: every rank holds the whole global batch and keeps its
      data rank's slice (ValueError where the batch does not divide).

    Without a mesh (or at data size 1) the whole batch is placed."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if mesh is not None and not local and mesh.data_size > 1:
            t = t[_rows(t.shape[0], mesh, k)]
        out[k] = t if device is None else t.to(device)
    return out


def shard_batch(mesh: Optional[Mesh], batch: Dict[str, Any], device=None):
    """The global batch's rows of this data rank (place_batch, local=False)."""
    return place_batch(mesh, batch, device)


# -------------------------------------------------------------- the rules
# JAX's leading dim in torch's layout, by jax_params layout
_LEAD_DIM = {"conv": 2, "linear": 1, "vector": 0}
_VOCAB_ROWS = ("decoder.embed.weight", "decoder.adaptive.mlp.weight", "decoder.adaptive.mlp.bias")


def param_sharding_rules(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim it splits on over the model axis, or
    None}: the embedding's rows [vocab, E], the vocab head's rows of its
    [vocab, H] weight (JAX's kernel columns) and its bias, each where the
    vocab dim divides the model axis; everything else replicated. `params`
    maps state_dict names to tensors (or anything with ``.shape``)."""
    tp = mesh.model_size
    return {name: 0 if tp > 1 and name in _VOCAB_ROWS and p.shape[0] % tp == 0 else None
            for name, p in params.items()}


def opt_state_sharding_rules(params: Dict[str, Any], mesh: Mesh, arch: str,
                             min_size: int = 8192) -> Dict[str, Optional[int]]:
    """ZeRO-1's rule (JAX's opt_state_sharding_rules): {parameter name: the
    torch dim its moments split on over the data axis, or None}. A moment
    splits where it is floating, has ndim >= 1 and >= min_size elements, and
    its leading dim in JAX's layout divides the data axis; scalars, counts
    and small tensors stay replicated."""
    from adaptive_tpu_torch.models.jax_params import param_keys

    n = mesh.data_size
    keys = param_keys(arch)
    out = {}
    for name, p in params.items():
        layout = keys[name][1]
        dim = _LEAD_DIM[layout] if p.ndim >= 1 else None
        ok = (n > 1 and dim is not None and p.dtype.is_floating_point
              and p.numel() >= min_size and p.shape[dim] % n == 0)
        out[name] = dim if ok else None
    return out


def gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (each rank's of one shape) concatenated along
    dim in group-rank order, JAX's tiled all_gather; the identity without a
    group."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum same-dtype tensors over the group in place, as one flat bucket
    (one all-reduce); nothing without a group."""
    if group is None or not tensors:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(list(tensors))
    dist.all_reduce(flat, group=group)
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, list(tensors))):
        t.copy_(r)


def init_distributed(cf=None, device="cuda") -> bool:
    """Start the default process group where cf.distributed_init is set or
    torchrun's WORLD_SIZE > 1 is in the environment; True where this call
    started it. The backend is nccl for a CUDA device and gloo for the CPU;
    on CUDA the rank's card is LOCAL_RANK. torchrun's environment gives the
    address, world and rank; without it the world is this one process, at a
    free port on localhost."""
    import os

    want = bool(cf is not None and cf.distributed_init)
    if not want and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if dist.is_initialized():
        return False
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
    return True
