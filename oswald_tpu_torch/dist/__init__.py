"""The distributed engine: torch.distributed ranks, one device each."""

from oswald_tpu_torch.dist.shard import (
    DistributedSearchEngine, process_group_slice, shard_bounds, shard_cells,
    shard_db,
)
from oswald_tpu_torch.dist.bootstrap import (bootstrap, shutdown,
                                             is_bootstrapped, world)

__all__ = ["DistributedSearchEngine", "process_group_slice", "shard_bounds",
           "shard_cells", "shard_db", "bootstrap", "shutdown",
           "is_bootstrapped", "world"]
