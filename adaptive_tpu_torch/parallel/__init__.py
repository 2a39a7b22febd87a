from adaptive_tpu_torch.parallel.mesh import (
    Mesh,
    get_rank,
    get_world_size,
    init_distributed,
    make_mesh,
    opt_state_sharding_rules,
    param_sharding_rules,
    place_batch,
    shard_batch,
)

__all__ = [
    "Mesh",
    "get_rank",
    "get_world_size",
    "init_distributed",
    "make_mesh",
    "opt_state_sharding_rules",
    "param_sharding_rules",
    "place_batch",
    "shard_batch",
]
