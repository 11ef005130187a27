"""Process groups of the ('data', 'space') grid and the batch layout over
them (counterpart of saunet_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'space') mesh over the devices of one
program. Here each device is a process (a rank, as `torchrun` starts them):
`init_data_parallel` joins the process group and returns a `DataMesh` of
`data` x `space` ranks, space the fast axis (rank = d * space + s, as
`Mesh(devices.reshape(data, space))` numbers them). 'data' splits the
batch; 'space' splits the image H axis, the conv-net counterpart of
sequence parallelism for 512^2 and larger inputs, where one device's
activations are the limit. `shard_batch` gives a rank its contiguous block
of a global batch's samples and, on the 'space' axis, its block of rows
(`rows`, the one row split every sharded op uses at every level).

Where the JAX package's partitioner inserts the halo exchanges, the port
places them by hand: `models.blocks.partition_space` makes every conv,
pool, resize, squeeze-and-excite mean and Canny read across the shard
borders through `SpaceShard.fetch` (parallel/collectives.py's row
exchange), and BatchNorm, the losses and the metrics reduce over the whole
grid (`group`).

Backend: NCCL when every rank of a node has a card of its own; gloo for
CPU ranks and for ranks that share a card (NCCL refuses two ranks on one
device, and gloo runs `all_reduce` and `broadcast` on CUDA tensors by
staging them through the host). It is a transport choice: the compute stays
on the card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import exchange_rows

#: Minimum rows of the deepest dense block each 'space' shard must own, and
#: that block's stride (the JAX package's envelope for its partitioner).
MIN_SPATIAL_SHARD_ROWS = 2
DEEPEST_DENSE_STRIDE = 16


def validate_spatial_partition(crop_size: int, space: int) -> None:
    """Reject 'space' sizes outside the JAX package's verified envelope:
    the deepest dense block must keep >= MIN_SPATIAL_SHARD_ROWS rows a
    shard (crop 256 -> space <= 8, crop 64 -> space <= 2). The port
    keeps the reference's envelope exactly."""
    if space <= 1:
        return
    rows_ = crop_size // DEEPEST_DENSE_STRIDE // space
    if rows_ < MIN_SPATIAL_SHARD_ROWS:
        raise ValueError(
            f"space={space} leaves {rows_} row(s) of the deepest dense "
            f"block (H={crop_size // DEEPEST_DENSE_STRIDE}) per shard; "
            f"use space <= {crop_size // DEEPEST_DENSE_STRIDE // 2} at crop "
            f"{crop_size}")


def rows(h: int, s: int, space: int) -> Tuple[int, int]:
    """The global rows [lo, hi) that 'space' rank `s` of `space` owns at a
    level of `h` rows: contiguous blocks, the larger ones last when `h`
    does not split evenly (7 rows over 2 ranks: 3 and 4)."""
    return h * s // space, h * (s + 1) // space


#: the levels a `SpaceShard` resolves: the input and its 2x, ..., 32x
#: downsamplings (SAUNet's deepest map is at H/32)
SPACE_LEVELS = 6


@dataclasses.dataclass(frozen=True)
class SpaceShard:
    """This rank's place on the 'space' axis during one forward: `index`
    of `size` ranks in `group`, and `height`, the global rows of the
    forward's input. Every level of the network has height >> k rows
    (k < SPACE_LEVELS), of which this rank holds `rows(level)`; `level`
    finds a tensor's level from the rows it holds."""
    group: object
    index: int
    size: int
    height: int

    def rows(self, h: int) -> Tuple[int, int]:
        return rows(h, self.index, self.size)

    def level(self, n: int) -> int:
        """The global rows of the level of which this rank holds `n`."""
        found = set()
        for k in range(SPACE_LEVELS):
            lo, hi = self.rows(self.height >> k)
            if hi - lo == n:
                found.add(self.height >> k)
        if len(found) != 1:
            raise ValueError(
                f"space rank {self.index} of {self.size}: {n} local rows "
                f"match levels {sorted(found)} of a {self.height}-row input")
        return found.pop()

    def fetch(self, x: torch.Tensor, h: int, ho: int,
              need: Callable[[int, int], Tuple[int, int]],
              dim: int = 2) -> torch.Tensor:
        """Rows [a, b) = need(lo, hi) of a level of `h` rows, of which `x`
        holds this rank's `rows(h)` along `dim`, where [lo, hi) are this
        rank's rows of the output level of `ho` rows; zero outside [0, h).
        Every rank of the group must call it with the same arguments but
        `x` (each rank's window is computed from `need` on every rank)."""
        windows = [need(*rows(ho, q, self.size)) for q in range(self.size)]
        return exchange_rows(x, [rows(h, q, self.size)
                                 for q in range(self.size)], windows,
                             self.index, self.group, dim)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the ('data', 'space') grid: `world` = data x
    `space` ranks in all, of which `local_world` on this node; `group`
    (every rank) is the group BatchNorm, the losses, the metrics and DDP
    reduce over, `space_group` the ranks that share this rank's samples
    and split their rows (None when `space` is 1), `data_group` the ranks
    that hold the same rows of other samples; `device` the rank's device.
    `with_space` lays a grid over the ranks of a mesh."""
    world: int
    rank: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: str
    group: object
    space: int = 1
    space_group: object = None
    data_group: object = None

    @property
    def nodes(self) -> int:
        return self.world // self.local_world

    @property
    def data(self) -> int:
        return self.world // self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    def rows(self, h: int) -> Tuple[int, int]:
        """This rank's global rows of a level of `h` rows."""
        return rows(h, self.space_index, self.space)

    def space_shard(self, height: int) -> Optional[SpaceShard]:
        """The 'space' axis of a forward whose input has `height` global
        rows, or None when the grid has no 'space' axis."""
        if self.space == 1:
            return None
        return SpaceShard(self.space_group, self.space_index, self.space,
                          height)

    def global_rows(self, n: int) -> int:
        """The sum of `n` over the ranks of this rank's 'space' group: the
        global height of a level of which each rank holds its rows (one
        all-reduce; `n` itself when `space` is 1)."""
        if self.space == 1:
            return n
        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, group=self.space_group)
        return int(t)

    def with_space(self, space: int) -> "DataMesh":
        """This mesh's ranks laid out as (world // space) x `space`: the
        'space' and 'data' groups are created on every rank, in the same
        order, so every rank of the mesh must call it."""
        if space == self.space:
            return self
        if space < 1 or self.world % space:
            raise ValueError(f"space={space} does not divide the "
                             f"{self.world} ranks")
        data = self.world // space
        space_group = data_group = None
        if space == 1:
            data_group = self.group
        elif data == 1:
            space_group = self.group
        else:
            for d in range(data):
                g = dist.new_group(list(range(d * space, (d + 1) * space)))
                if d == self.rank // space:
                    space_group = g
            for s in range(space):
                g = dist.new_group(list(range(s, self.world, space)))
                if s == self.rank % space:
                    data_group = g
        return dataclasses.replace(self, space=space,
                                   space_group=space_group,
                                   data_group=data_group)


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


def init_data_parallel(device: Optional[torch.device | str] = None,
                       space: int = 1) -> DataMesh:
    """Join the process group described by RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT (torchrun's variables)
    and lay the (WORLD_SIZE // space) x `space` grid over it.

    device: None or 'cuda' takes card LOCAL_RANK % device_count (raises
    without a card); 'cpu' (or another explicit device) is used as given.
    Rank 0 prints the grid, the backend and why it was chosen."""
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
    mesh = DataMesh(world=world, rank=rank, local_rank=local_rank,
                    local_world=local_world, device=device, backend=backend,
                    group=dist.group.WORLD).with_space(space)
    if rank == 0:
        print(f"data parallel: {world} rank(s) on {world // local_world} "
              f"node(s) as ('data' {mesh.data}, 'space' {space}), backend "
              f"{backend} ({why})", flush=True)
    return mesh


def shard_rows(n: int, mesh: DataMesh) -> slice:
    """This rank's contiguous block of a global batch of `n` samples (its
    block on the 'data' axis)."""
    if n % mesh.data:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{mesh.data} ranks")
    k = n // mesh.data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(batch: Dict, mesh: DataMesh,
                split_rows: bool = True) -> Dict[str, torch.Tensor]:
    """This rank's samples of a global host batch (numpy arrays or tensors,
    batch first), as tensors on the rank's device (through pinned memory
    to a card). With `split_rows` (and a 'space' axis) entries of rank 3
    or more (image, label, edge: (N, H, ...)) keep only this rank's
    `mesh.rows(H)`; rank-1 entries (`valid`) are split by sample alone."""
    samples = None
    out = {}
    for k, v in batch.items():
        samples = samples or shard_rows(len(v), mesh)
        t = v[samples]
        if split_rows and mesh.space > 1 and t.ndim >= 3:
            lo, hi = mesh.rows(t.shape[1])
            t = t[:, lo:hi]
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
