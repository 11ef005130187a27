"""The explicit-collective data-parallel train step (counterpart of
saunet_tpu/parallel/shard_map_step.py and its `syncbn_axis`).

`train.make_train_step(mesh=...)` is the default backend: the loss is the
global batch's. This is the other one, with the collectives placed by
hand as `make_shard_map_train_step` places them:

  * loss:        each rank's own (a mean of per-rank means);
  * gradients:   averaged over the ranks (DistributedDataParallel; the
                 counterpart of `lax.pmean(grads)`);
  * batch-norm:  statistics over every rank (`sync_batch_norm`, the
                 counterpart of `BatchNorm(axis_name='data')`);
  * metrics:     averaged over the ranks;
  * augmentation: the generator folded with the rank (`fold_in`), so the
                 ranks draw distinct augmentations.

On a batch that is the same on every rank it equals the global-batch step.
It is a 'data'-axis step, as the JAX one (its shard_map maps the batch over
'data' alone and `BatchNorm(axis_name='data')` reduces over 'data'): given
a grid with a 'space' axis it raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.norm import sync_batch_norm
from ..train.losses import DEFAULT_CLASS_WEIGHTS, dual_loss
from ..train.metrics import pixel_acc
from ..train.state import TrainState, ddp
from .collectives import all_reduce_sum, fold_in
from .mesh import DataMesh


def make_shard_map_train_step(model: nn.Module, tx: Callable,
                              mesh: DataMesh, num_class: int = 4,
                              class_weights=DEFAULT_CLASS_WEIGHTS,
                              augment_fn: Optional[Callable] = None):
    """`step(state, batch, gen=None) -> (state, metrics)` with
    `make_train_step`'s signature: `batch` is this rank's rows, the state
    from `create_train_state(..., mesh=mesh)`."""
    if mesh.space > 1:
        raise ValueError(
            f"make_shard_map_train_step: a ('data' {mesh.data}, 'space' "
            f"{mesh.space}) grid; the per-rank-loss step maps the batch "
            f"over 'data' alone, as the JAX shard_map step does (whole "
            f"images a rank, statistics over 'data'): use "
            f"train.make_train_step(mesh=...) for the 'space' axis")
    net = ddp(model, mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             gen: Optional[torch.Generator] = None):
        if state.model is not model or state.tx is not tx:
            raise ValueError("make_shard_map_train_step: state holds "
                             "another model or optimizer")
        batch = {k: v.to(state.device, non_blocking=True)
                 for k, v in batch.items()}
        if augment_fn is not None:
            batch = augment_fn(fold_in(gen, mesh.rank), batch)
        model.train()
        with sync_batch_norm(model, mesh.group):
            seg, edge = net(batch["image"].permute(0, 3, 1, 2))
        seg = seg.permute(0, 2, 3, 1)
        total, parts = dual_loss(seg, edge.permute(0, 2, 3, 1),
                                 batch["label"], batch["edge"],
                                 class_weights)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc, jaccard = pixel_acc(seg.argmax(dim=-1), batch["label"],
                                     num_class)
            names = ("loss", "ce", "dice", "edge")
            local = torch.cat([torch.stack([parts[k].detach() for k in names]
                                           + [acc]), jaccard])
            mean = all_reduce_sum(local, mesh.group) / mesh.world
        metrics = dict(zip(names, mean[:4]))
        metrics["acc"] = mean[4]
        metrics["jaccard"] = mean[5:]
        return state, metrics

    return step
