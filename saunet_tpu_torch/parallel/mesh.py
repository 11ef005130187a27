"""Data-parallel process groups and the batch layout over them
(counterpart of saunet_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'space') mesh over the devices of one
program. Here each device is a process (a rank, as `torchrun` starts them),
and the 'data' axis is the process group: `init_data_parallel` joins it and
returns a `DataMesh`, `shard_batch` gives a rank its contiguous rows of a
global batch, as `shard_batch` lays them out over 'data'. The 'space' axis
(the image H axis over devices, with a halo exchange for every convolution,
pooling, resize, BatchNorm and Canny's hysteresis) is not ported:
`SPACE_AXIS_ITEM` names where it is queued.

Backend: NCCL when every rank of a node has a card of its own; gloo for
CPU ranks and for ranks that share a card (NCCL refuses two ranks on one
device, and gloo runs `all_reduce` and `broadcast` on CUDA tensors by
staging them through the host). It is a transport choice: the compute stays
on the card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SPACE_AXIS_ITEM = ("the 'space' axis (spatial parallelism, halo exchanges), "
                   "queued as ROADMAP.md section 1 item 1")

#: Minimum rows of the deepest dense block each 'space' shard must own, and
#: that block's stride (the JAX package's envelope for its partitioner).
MIN_SPATIAL_SHARD_ROWS = 2
DEEPEST_DENSE_STRIDE = 16


def validate_spatial_partition(crop_size: int, space: int) -> None:
    """Reject 'space' sizes outside the JAX package's verified envelope
    (>= MIN_SPATIAL_SHARD_ROWS rows of the deepest dense block a shard),
    then any 'space' above 1: the port has no spatial partitioning yet."""
    if space <= 1:
        return
    rows = crop_size // DEEPEST_DENSE_STRIDE // space
    if rows < MIN_SPATIAL_SHARD_ROWS:
        raise ValueError(
            f"space={space} leaves {rows} row(s) of the deepest dense "
            f"block (H={crop_size // DEEPEST_DENSE_STRIDE}) per shard; "
            f"use space <= {crop_size // DEEPEST_DENSE_STRIDE // 2} at crop "
            f"{crop_size}")
    raise ValueError(f"--space {space}: the port trains over the 'data' "
                     f"axis only; {SPACE_AXIS_ITEM}")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the 'data' axis: `world` ranks in all, of which
    `local_world` on this node; `group` is the process group the steps
    reduce over and `device` the rank's device."""
    world: int
    rank: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: str
    group: object

    @property
    def nodes(self) -> int:
        return self.world // self.local_world


def choose_backend(device: torch.device, local_world: int,
                   cards: int) -> Tuple[str, str]:
    """(backend, reason) for ranks on `device`'s type, `local_world` of
    them on a node with `cards` cards."""
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), one each"
    return "gloo", (f"{local_world} ranks share {cards} card(s): NCCL refuses "
                    f"two ranks on one device; gloo stages the collectives "
                    f"through the host, the compute stays on the card")


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"{name} is not set: start the ranks with "
                               f"torchrun (torch.distributed.run)")
        return default
    return int(value)


def in_launched_rank() -> bool:
    """True in a process that a launcher started as a rank (RANK and
    WORLD_SIZE set, as torchrun sets them)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_data_parallel(device: Optional[torch.device | str] = None
                       ) -> DataMesh:
    """Join the process group described by RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT (torchrun's variables).

    device: None or 'cuda' takes card LOCAL_RANK % device_count (raises
    without a card); 'cpu' (or another explicit device) is used as given.
    Rank 0 prints the backend and why it was chosen."""
    rank = _env_int("RANK")
    world = _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    device = torch.device("cuda" if device is None else device)
    cards = 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the ranks on the CPU")
        cards = torch.cuda.device_count()
        if device.index is None:
            device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    backend, why = choose_backend(device, local_world, cards)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    if rank == 0:
        print(f"data parallel: {world} rank(s) on {world // local_world} "
              f"node(s), backend {backend} ({why})", flush=True)
    return DataMesh(world=world, rank=rank, local_rank=local_rank,
                    local_world=local_world, device=device, backend=backend,
                    group=dist.group.WORLD)


def shard_rows(n: int, mesh: DataMesh) -> slice:
    """This rank's contiguous block of a global batch of `n` rows."""
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{mesh.world} ranks")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(batch: Dict, mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host batch (numpy arrays or tensors,
    batch first), as tensors on the rank's device (through pinned memory
    to a card)."""
    rows = None
    out = {}
    for k, v in batch.items():
        rows = rows or shard_rows(len(v), mesh)
        t = v[rows]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
            if mesh.device.type == "cuda":
                t = t.pin_memory()
        out[k] = t.to(mesh.device, non_blocking=True)
    return out


def broadcast_module_(module: torch.nn.Module, mesh: DataMesh) -> None:
    """Copy rank 0's parameters and buffers into every rank's `module`:
    one broadcast of the flattened tensors of each dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src=0, group=mesh.group)
            for t, v in zip(tensors, flat.split([t.numel()
                                                 for t in tensors])):
                t.copy_(v.view_as(t))


def barrier(mesh_or_device) -> None:
    """Wait for every rank: a one-element all-reduce on the rank's device
    (works on NCCL and gloo alike). No-op without a process group."""
    if not dist.is_initialized():
        return
    device = getattr(mesh_or_device, "device", mesh_or_device)
    dist.all_reduce(torch.zeros(1, device=device))
