"""Multi-chip scaling: device meshes + sharded scan engines.

This layer has no counterpart in the reference — BulkLMM.jl parallelizes with
Julia threads + BLAS thread pools on one host (reference src/bulkscan.jl:252,
268) and explicitly defers multi-machine distribution to future work
(reference README.md:66-72). Here the same scaling axes (traits, markers,
permutations) become named mesh axes over the device interconnect, sharded with
``jax.sharding.NamedSharding`` so XLA inserts the collectives.
"""

from .distributed import (
    bulkscan_distributed,
    bulkscan_perms_distributed,
    init_distributed,
    local_trait_slice,
    make_global_mesh,
    merge_perm_shards,
    merge_shards,
)
from .sharding import (
    bulkscan_perms_sharded,
    bulkscan_sharded,
    make_mesh,
    scan_perms_sharded,
    shard_rotated,
    train_step_sharded,
)

__all__ = [
    "bulkscan_distributed",
    "bulkscan_perms_distributed",
    "merge_perm_shards",
    "init_distributed",
    "local_trait_slice",
    "make_global_mesh",
    "merge_shards",
    "bulkscan_perms_sharded",
    "bulkscan_sharded",
    "make_mesh",
    "scan_perms_sharded",
    "shard_rotated",
    "train_step_sharded",
]
