"""Parallel training across processes (counterpart of
saunet_tpu/parallel/): the ('data', 'space') grid of process groups and
the batch layout (`mesh`), the differentiable all-reduce and row exchange
(`collectives`), the explicit per-rank-loss step (`shard_map_step`), the
dry run (`dryrun`) and the rank launcher (`launch`). The global-batch step
is `train.make_train_step(mesh=...)`."""
from .collectives import all_reduce_sum, exchange_rows, fold_in
from .mesh import (
    DataMesh,
    SpaceShard,
    barrier,
    init_data_parallel,
    rows,
    shard_batch,
    shard_rows,
    validate_spatial_partition,
)

__all__ = ["DataMesh", "SpaceShard", "all_reduce_sum", "barrier",
           "exchange_rows", "fold_in", "init_data_parallel", "rows",
           "shard_batch", "shard_rows", "validate_spatial_partition"]
