"""Data parallelism (port of ``lisec_tpu/parallel``): the mesh, the
launcher, the sharded feed, the collectives that make a batch reduction
global, and point-axis sharding of one cloud."""

from lisec_tpu_torch.parallel.mesh import (
    Mesh,
    ProcessShardDataset,
    all_gather,
    all_reduce_grads,
    current_mesh,
    global_mean,
    global_metrics,
    global_sum,
    initialize_distributed,
    make_mesh,
    mean_share,
    run_ranks,
    shard_batch,
    share,
    use_mesh,
    world_size,
)
from lisec_tpu_torch.parallel.point_sharded import (
    ball_query_sharded,
    fps_sharded,
)

__all__ = [
    "Mesh", "ProcessShardDataset", "all_gather", "all_reduce_grads",
    "current_mesh", "global_mean", "global_metrics",
    "global_sum", "initialize_distributed", "make_mesh", "mean_share",
    "run_ranks", "shard_batch", "share", "use_mesh", "world_size",
    "ball_query_sharded", "fps_sharded",
]
