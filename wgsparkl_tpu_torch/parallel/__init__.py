"""Multi-device stepping on torch.distributed (port of wgsparkl_tpu/parallel)."""

from wgsparkl_tpu_torch.parallel.comm import Comm
from wgsparkl_tpu_torch.parallel.domain import (
    gather_state,
    make_sharded_step,
    map_state,
    pad_particle_count,
    pad_state,
    shard_state,
    shard_state_spatial,
    spatial_config,
)

__all__ = [
    "Comm",
    "gather_state",
    "make_sharded_step",
    "map_state",
    "pad_particle_count",
    "pad_state",
    "shard_state",
    "shard_state_spatial",
    "spatial_config",
]
