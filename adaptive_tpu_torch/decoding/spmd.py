"""The fused decode over a mesh of ranks (counterpart of
adaptive_tpu/decoding/spmd.py).

JAX runs its Pallas decode under ``jax.shard_map``: each device decodes its
rows of the batch, and on a model axis > 1 the embedding rows and the
hoisted vocab head's columns are split over it. Here each rank is a process:

* data parallelism: every rank is handed the global batch, decodes its data
  rank's rows (the fused cell is row-parallel: kernels 1 and 3 run unchanged
  on them), and the outputs are all-gathered over the data group, so every
  rank returns the whole batch's;
* tensor parallelism (model axis > 1): ``prepared_specs`` keeps this rank's
  slice of the prepared weights, the embedding rows and the head's columns
  with their tensor-core tiles, and the decode steps take the model group
  (models/decoders.py: ``embed_lookup``, ``_shard_topk``: kernel 4 on the
  shard, the lists merged with the kernels' tie rule);
* a batch that does not divide the data axis is decoded whole on every rank
  (JAX's plain-body branch), still tensor-parallel over the model group.

There is no mesh with one rank, off the fused path or for another variant.
"""

from __future__ import annotations

from typing import Optional

from adaptive_tpu_torch.parallel.mesh import Mesh, gather, get_world_size, make_mesh


def decode_mesh(model, cf) -> Optional[Mesh]:
    """The mesh the fused decode runs over, or None (one process, the plain
    path, or a variant whose decode never reaches a kernel)."""
    if model.variant != "adaptive_attention" or not model.fused:
        return None
    if get_world_size() <= 1:
        return None
    mesh = make_mesh(cf)
    return mesh if mesh.size > 1 else None


def prepared_specs(prepared, mesh: Mesh):
    """This rank's slice of the prepared dict (JAX's in_specs for it, applied)
    and the decode steps' tensor-parallel arguments under "tp": (model group,
    head_tp), or None at model size 1. The embedding's rows and the mlp's
    columns split where their vocab dim divides the model axis, as
    parallel/mesh.py::param_sharding_rules has them; the prepared head's
    columns where the padded width divides it (head_tp), with the tiles of
    the shard for the tensor-core instance."""
    from adaptive_tpu_torch.ops import fused_step as fs

    tp = mesh.model_size
    if tp <= 1:
        return {**prepared, "tp": None}
    r = mesh.model_rank

    def part(t, dim):
        n = t.shape[dim] // tp
        return t.narrow(dim, r * n, n).contiguous()

    dec = dict(prepared["decoder"])
    if dec["embed"].shape[0] % tp == 0:
        dec["embed"] = part(dec["embed"], 0)
    mlp = dec["adaptive"]["mlp"]
    if mlp["kernel"].shape[1] % tp == 0:
        dec["adaptive"] = {**dec["adaptive"], "mlp": {"kernel": part(mlp["kernel"], 1),
                                                       "bias": part(mlp["bias"], 0)}}
    head = prepared["head"]
    head_tp = head is not None and head[0].shape[1] % tp == 0
    if head_tp:
        w = part(head[0], 1)
        w_t = (fs.head_kernel_tiles(w) if fs.head_instance(w.dtype, w.shape[0]) == "mma"
               else None)
        head = fs.PreparedHead(w, part(head[1], 0), w_t)
    return {**prepared, "decoder": dec, "head": head, "tp": (mesh.model_group, head_tp)}


def wrap_decode_body(body, mesh: Optional[Mesh]):
    """decode(prepared, images_u8) over the mesh. body(prepared, images_u8)
    decodes a batch into a NamedTuple of batch-leading tensors; `prepared`
    is this rank's (prepared_specs). Every rank passes the global batch: a
    batch that divides the data axis is split over it and the outputs are
    all-gathered over the data group; any other is decoded whole on every
    rank. Without a mesh, body itself."""
    if mesh is None:
        return body
    data_n, d = mesh.data_size, mesh.data_rank

    def decode_prepared(prepared, images_u8):
        B = images_u8.shape[0]
        if data_n == 1 or B % data_n:
            return body(prepared, images_u8)
        rows = B // data_n
        out = body(prepared, images_u8[d * rows:(d + 1) * rows])
        return type(out)(*(gather(t, mesh.data_group) for t in out))

    return decode_prepared
