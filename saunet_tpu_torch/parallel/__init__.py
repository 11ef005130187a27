"""Data-parallel training across processes (counterpart of
saunet_tpu/parallel/): the process group and batch layout (`mesh`), the
differentiable all-reduce (`collectives`), the explicit per-rank-loss step
(`shard_map_step`), the dry run (`dryrun`) and the rank launcher
(`launch`). The global-batch step is `train.make_train_step(mesh=...)`."""
from .collectives import all_reduce_sum, fold_in
from .mesh import (
    SPACE_AXIS_ITEM,
    DataMesh,
    barrier,
    init_data_parallel,
    shard_batch,
    shard_rows,
    validate_spatial_partition,
)

__all__ = ["DataMesh", "SPACE_AXIS_ITEM", "all_reduce_sum", "barrier",
           "fold_in", "init_data_parallel", "shard_batch", "shard_rows",
           "validate_spatial_partition"]
