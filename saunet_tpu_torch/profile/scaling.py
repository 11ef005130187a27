"""The collectives of the partitioned train step and their predicted cost
(counterpart of tools/predict_scaling.py).

The JAX tool compiles the step on a virtual mesh and reads the
collectives XLA inserted from the HLO. The port's collectives are calls:
`collectives_case` runs the global-batch train step (the dry run's: one
sample a rank at 64^2, seeded weights, radam(1e-3), no augmentation) on
the ranks of a ('data' 2) and a ('data' 2, 'space' 2) grid, and records
every all-reduce of its second step (the first runs on DDP's initial
buckets, which it then rebuilds) with its kind, reduction, dtype, shape,
bytes and group, in classes:

  gradients:     DDP's gradient buckets (through a comm hook, as
                 parallel/parity.py registers one);
  bn_stats:      the synced BatchNorm's (sum x, sum x^2, n) a layer
                 (`collectives.all_reduce_sum` from models/norm.py), in
                 the forward and in its backward;
  row_exchanges: the 'space' axis's row exchanges
                 (`collectives.exchange_rows`, forward and backward);
  loss_metrics:  the global batch's loss and metric sums (train/losses.py,
                 train/metrics.py);
  space_sums:    the 'space' group's other sums: the gray image's extrema
                 for Canny, the squeeze-and-excite means, the global row
                 count.

The gradient, statistic and loss classes do not depend on the image
size. The exchanges scale with the width and the samples a rank holds
(each is a few halo rows of every sample), the space sums with the
samples: `predict` scales them to 224^2 at 64 samples a rank and 512^2
at 8, and gives the comm ms a card would spend at data=4 and on the 2 x 2
grid, every collective a ring all-reduce over its group (2 (g - 1) / g of
its bytes through each card's link) at `link_gbps`, which the caller
gives: no default, and not a measured rate. Unoverlapped: a worst case.

    python -m saunet_tpu_torch.cli.profile --what scaling --link_gbps R
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Dict, List

import torch.distributed as dist

from ..parallel.collectives import exchange_rows
from ..parallel.launch import run_ranks
from ..parallel.mesh import (
    DataMesh,
    barrier,
    shard_batch,
    validate_spatial_partition,
)
from . import common

TOOL = "tools/predict_scaling.py"
CHILD_HW = 64
#: the train step's compute dtype, as the port trains (the exchanged
#: activations are in it; gradients and statistics stay f32)
DTYPE = "bfloat16"
#: the geometries the prediction scales to: (width, samples a rank)
TARGETS = {"224^2 b64": (224, 64), "512^2 b8": (512, 8)}
#: the grids measured, in one spawn of four ranks: name -> (ranks, space)
GRIDS = {"data2": (2, 1), "data2_space2": (4, 2)}
CLASSES = ("gradients", "bn_stats", "row_exchanges", "loss_metrics",
           "space_sums")
#: the JAX tool's split: geometry-independent and geometry-scaling bytes
JAX_NAMES = {"gradients": "geometry-independent bytes/step",
             "bn_stats": "geometry-independent bytes/step",
             "loss_metrics": "geometry-independent bytes/step",
             "row_exchanges": "geometry-scaling bytes",
             "space_sums": "geometry-scaling bytes"}

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (file in the package, function) that calls dist.all_reduce -> class
_SITES = {("parallel/collectives.py", "reduce"): "row_exchanges",
          ("ops/edge.py", "image_to_gray255"): "space_sums",
          ("parallel/mesh.py", "global_rows"): "space_sums",
          ("parallel/parity.py", "hook"): "gradients"}
#: the file that calls `all_reduce_sum` -> class
_SUM_CALLERS = {"models/norm.py": "bn_stats",
                "train/losses.py": "loss_metrics",
                "train/metrics.py": "loss_metrics",
                "models/blocks.py": "space_sums"}


def _where(frame) -> str:
    """`frame`'s file relative to the package, '/'-separated ('' outside
    it)."""
    path = os.path.abspath(frame.f_code.co_filename)
    if not path.startswith(_PACKAGE + os.sep):
        return ""
    return os.path.relpath(path, _PACKAGE).replace(os.sep, "/")


def _classify(frame):
    """(class, direction) of the dist.all_reduce that `frame` makes."""
    where, fn = _where(frame), frame.f_code.co_name
    if where == "parallel/collectives.py" and fn in ("forward", "backward"):
        ctx = frame.f_locals["ctx"]  # _AllReduceSum's
        if fn == "forward":
            caller = frame.f_back
            while caller is not None and _where(caller) in (
                    "", "parallel/collectives.py"):
                caller = caller.f_back
            cls = _SUM_CALLERS.get(_where(caller) if caller else "")
            if cls is None:
                raise RuntimeError(f"all_reduce_sum from an unclassified "
                                   f"caller: {caller and _where(caller)}")
            ctx.collective_class = cls
        return ctx.collective_class, fn
    cls = _SITES.get((where, fn))
    if cls is None:
        raise RuntimeError(f"unclassified all_reduce from {where}:{fn}")
    if cls == "row_exchanges":
        return cls, ("backward" if frame.f_back.f_code.co_name
                     == "scatter_add" else "forward")
    return cls, "backward" if cls == "gradients" else "forward"


@contextlib.contextmanager
def recording_collectives():
    """Within the block every `torch.distributed.all_reduce` is recorded,
    classified by its call site, in the list yielded; an all-reduce from
    a site of no class raises."""
    records: List[dict] = []
    real = dist.all_reduce

    def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None,
                   async_op=False):
        cls, direction = _classify(sys._getframe(1))
        records.append({
            "class": cls, "direction": direction, "kind": "all_reduce",
            "op": "sum" if op == dist.ReduceOp.SUM else "max",
            "dtype": str(tensor.dtype).removeprefix("torch."),
            "shape": list(tensor.shape),
            "bytes": tensor.numel() * tensor.element_size(),
            "group": dist.get_world_size(group)})
        return real(tensor, op=op, group=group, async_op=async_op)

    dist.all_reduce = all_reduce
    try:
        yield records
    finally:
        dist.all_reduce = real


def collectives_case(mesh: DataMesh, hw: int = CHILD_HW,
                     space: int = 1) -> dict:
    """Rank side: two global-batch train steps on the (world / space) x
    space grid, the second recorded: its collectives, the row exchanges
    `exchange_rows` counted, and the samples this rank held."""
    from ..parallel.dryrun import dry_batch
    from ..parallel.parity import build_model, timed_allreduce_hook
    from ..train import create_train_state, make_train_step, radam

    validate_spatial_partition(hw, space)
    mesh = mesh.with_space(space)
    model = build_model(0, DTYPE)
    tx = radam(1e-3)
    state = create_train_state(model, tx, mesh=mesh)
    step = make_train_step(model, tx, mesh=mesh)
    step.net.register_comm_hook(mesh.group, timed_allreduce_hook([]))
    rows = shard_batch(dry_batch(mesh.world, hw), mesh)
    step(state, rows)
    calls, nbytes = exchange_rows.calls, exchange_rows.bytes
    with recording_collectives() as records:
        _, metrics = step(state, rows)
        loss = float(metrics["loss"])
    return {"grid": {"data": mesh.data, "space": mesh.space}, "hw": hw,
            "dtype": DTYPE, "samples_per_rank": int(rows["image"].shape[0]),
            "collectives": records, "loss": loss,
            "exchange_rows": {"calls": exchange_rows.calls - calls,
                              "bytes": exchange_rows.bytes - nbytes}}


def grids_case(mesh: DataMesh, hw: int = CHILD_HW) -> dict:
    """Rank side of `run` on four ranks: `collectives_case` on the ('data'
    2) grid of ranks 0 and 1 (the others wait), then on the 2 x 2 grid of
    all four: {grid: this rank's inventory, or None}."""
    pair = dist.new_group([0, 1])  # every rank creates it
    out = {}
    for grid, (ranks, space) in GRIDS.items():
        sub = dataclasses.replace(mesh, group=pair, world=2, local_world=2) \
            if ranks == 2 else mesh
        out[grid] = (collectives_case(sub, hw, space)
                     if mesh.rank < ranks else None)
        barrier(mesh)
    return out


def by_class(records: List[dict]) -> Dict[str, dict]:
    """{class: {count, bytes, group}} of one step's records (every class
    named, empty ones at 0)."""
    out = {c: {"count": 0, "bytes": 0, "group": None} for c in CLASSES}
    for r in records:
        c = out[r["class"]]
        c["count"] += 1
        c["bytes"] += r["bytes"]
        c["group"] = r["group"]
    return out


def _ring(g: int) -> float:
    return 2 * (g - 1) / g if g else 0.0


def predict(inventories: Dict[str, dict], link_gbps: float) -> dict:
    """The comm ms a card spends a step at data=4 (the 'data' 2 grid's
    collectives over 4 ranks) and on the 2 x 2 grid, at each TARGETS
    geometry: {grid: {target: {class: {count, bytes}}, comm_ms}}."""
    out = {}
    for grid, inv in (("data=4", inventories["data2"]),
                      ("2x2", inventories["data2_space2"])):
        classes = by_class(inv["collectives"])
        out[grid] = {}
        for target, (width, samples) in TARGETS.items():
            per_sample = samples / inv["samples_per_rank"]
            scale = {"row_exchanges": per_sample * width / inv["hw"],
                     "space_sums": per_sample}
            pred, ms = {}, 0.0
            for c, v in classes.items():
                nbytes = v["bytes"] * scale.get(c, 1.0)
                group = 4 if grid == "data=4" else v["group"]
                pred[c] = {"count": v["count"], "bytes": nbytes}
                if v["count"]:
                    ms += _ring(group) * nbytes / (link_gbps * 1e9) * 1e3
            out[grid][target] = {"classes": pred, "comm_ms": ms}
    return out


def run(device=None, hw: int = CHILD_HW, link_gbps: float = None) -> dict:
    if not link_gbps or link_gbps <= 0:
        raise ValueError("scaling needs the link rate (GB/s), a positive "
                         "number: it has no default")
    device = common.device_of(device)
    results = run_ranks(4, "saunet_tpu_torch.profile.scaling:grids_case",
                        {"hw": hw}, device=device.type,
                        threads=1 if device.type == "cpu" else None,
                        timeout=900)
    inventories = {}
    for grid, (ranks, _) in GRIDS.items():
        totals = {sum(r["bytes"] for r in res[grid]["collectives"])
                  for res in results[:ranks]}
        if len(totals) != 1:
            raise RuntimeError(f"{grid}: ranks moved different bytes "
                               f"{sorted(totals)}")
        inventories[grid] = results[0][grid]
    rows = []
    for grid, inv in inventories.items():
        for c, v in by_class(inv["collectives"]).items():
            rows.append(common.row(f"{grid}/{c}", None, JAX_NAMES[c],
                                   count=v["count"], bytes=v["bytes"],
                                   mib=v["bytes"] / 2**20))
    predicted = predict(inventories, link_gbps)
    for grid, targets in predicted.items():
        for target, p in targets.items():
            rows.append(common.row(f"{grid} {target} comm", p["comm_ms"],
                                   "per-chip comm @",
                                   link_gbps=link_gbps))
    return common.report("scaling", device, TOOL, rows, hw=hw, dtype=DTYPE,
                         link_gbps=link_gbps, inventories=inventories,
                         predicted=predicted)
