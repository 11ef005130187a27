"""The multi-rank dry run (counterpart of saunet_tpu/parallel/dryrun.py and
`__graft_entry__.dryrun_multichip`): one full SAUNet train step of the
global-batch step over n ranks, on tiny shapes, laid out as the JAX dry run
lays its mesh (`grid`): (n // 2) x 2 ('data' x 'space') when n is even
and at least 4, else n x 1.

    python -m saunet_tpu_torch.parallel.dryrun [n] [hw] [device]

The JAX dry run builds a virtual n-device CPU mesh in a scrubbed process;
here the ranks are processes (`launch.run_ranks`) on the card by default
(raising without one), or gloo ranks on the CPU when asked ('cpu'). Called
on every rank of a group that already exists, it runs on that group
instead.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from .launch import run_ranks
from .mesh import (
    DataMesh,
    init_data_parallel,
    shard_batch,
    validate_spatial_partition,
)


def grid(n: int):
    """The (data, space) layout of n ranks, as the JAX dry run's mesh."""
    space = 2 if n % 2 == 0 and n >= 4 else 1
    return n // space, space


def mesh_step(mesh: DataMesh, hw: int = 64) -> float:
    """Rank side: one global-batch train step (f32 SAUNet from seed 0,
    radam(1e-3), one sample a rank, as the JAX dry run takes) on this
    rank's rows, with the ranks laid out as `grid`; returns the loss,
    which is the global batch's."""
    from ..train import create_train_state, make_train_step, radam
    from .parity import build_model

    space = grid(mesh.world)[1]
    validate_spatial_partition(hw, space)
    mesh = mesh.with_space(space)
    model = build_model(0)
    tx = radam(1e-3)
    state = create_train_state(model, tx, mesh=mesh)
    step = make_train_step(model, tx, mesh=mesh)
    state, metrics = step(state, shard_batch(dry_batch(mesh.world, hw), mesh))
    return float(metrics["loss"])


def dry_batch(n: int, hw: int) -> dict:
    """The dry run's global batch of n samples at hw^2, numpy, seed 0."""
    rs = np.random.RandomState(0)
    return {"image": rs.randn(n, hw, hw, 3).astype(np.float32),
            "label": rs.randint(0, 4, size=(n, hw, hw)).astype(np.int32),
            "edge": (rs.rand(n, hw, hw, 1) > 0.8).astype(np.float32)}


def run_mesh_step(n: int, hw: int = 64, device: str = "cuda",
                  timeout: float = 600.0) -> float:
    """Run `mesh_step` on n ranks and return the loss after checking that
    it is finite and the same on every rank.

    From a process that is already a rank of an n-rank group, every rank
    calls this and the step runs in-process on that group, as the JAX dry
    run runs in-process on a live n-device CPU platform; otherwise n ranks
    are spawned. `validate_spatial_partition(hw, space)` runs first, as in
    the JAX dry run."""
    data, space = grid(n)
    validate_spatial_partition(hw, space)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"run_mesh_step({n}) in a group of "
                             f"{dist.get_world_size()} ranks")
        mesh = init_data_parallel(device)
        loss = mesh_step(mesh, hw)
        first = torch.tensor([loss], dtype=torch.float64, device=mesh.device)
        dist.broadcast(first, src=0, group=mesh.group)
        losses = [float(first), loss]
    else:
        # CPU ranks run one intra-op thread each: n pools of torch's
        # default size starve each other and gloo's waits
        losses = run_ranks(n, "saunet_tpu_torch.parallel.dryrun:mesh_step",
                           {"hw": hw}, device=device, timeout=timeout,
                           threads=1 if device == "cpu" else None)
    loss = losses[0]
    if not math.isfinite(loss) or any(x != loss for x in losses):
        raise RuntimeError(f"dry run on {n} ranks: losses {losses}")
    print(f"dryrun({n} ranks as ('data' {data}, 'space' {space}), {device}, "
          f"{hw}^2): loss={loss:.4f} ok", flush=True)
    return loss


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    run_mesh_step(int(argv[0]) if argv else 2,
                  int(argv[1]) if len(argv) > 1 else 64,
                  argv[2] if len(argv) > 2 else "cuda")


if __name__ == "__main__":
    main()
