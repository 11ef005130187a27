"""Rank-side cases of the parallel checks. Each runs on one rank of a
`launch.run_ranks` call and returns, on the CPU, what the parent holds
against the one-process steps: tests/test_torch_parallel.py and
tests/test_torch_space.py on the CPU (gloo ranks) and chip_smoke.py's
data-parallel and 'space' phases on the card.

`weights` is the path of a model state_dict (`torch.save`d by the parent)
or an int seed for `init_random_`; `batch` is the GLOBAL batch as numpy
arrays, of which each rank takes its rows (`shard_batch`). `space` lays
the ranks out as (world // space) x space (`DataMesh.with_space`).
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.augment import make_augment_fn
from ..models import build_unet
from ..models.blocks import (
    Conv2d,
    ConvTranspose2d,
    SEModule,
    max_pool_2x2,
    partition_space,
    pool_2x2,
)
from ..models.densenet import DenseBlock, rematerialised
from ..models.init import init_random_
from ..models.norm import sync_batch_norm
from ..models.saunet import canny_rows
from ..ops.cuda import canny_edges_cuda, launches, zero_launches
from ..ops.edge import image_to_gray255
from ..ops.resize import resize_bilinear
from ..train import (
    create_train_state,
    intersection_and_union,
    make_eval_step,
    make_train_step,
    radam,
)
from .collectives import all_reduce_sum, exchange_rows
from .mesh import DataMesh, shard_batch, shard_rows
from .shard_map_step import make_shard_map_train_step

Weights = Union[str, int]


def build_model(weights: Weights, dtype: str = "float32",
                **kwargs) -> nn.Module:
    """A SAUNet (`build_unet(dtype=dtype, **kwargs)`) holding `weights`."""
    model = build_unet(dtype=dtype, **kwargs)
    if isinstance(weights, str):
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True))
    else:
        init_random_(model, torch.Generator().manual_seed(weights))
    return model


#: the per-rank batch of chip_smoke's torchrun `cli.train` run, at which
#: `timed_case` also holds each kernel against its plain version
CLI_ROWS = 4

#: kernel -> (module, name) through which the steps call its wrapper: K1
#: in the SAUNet forward, K5 in the augmentation, K3 in the fused encoder
KERNEL_SITES = {
    "canny": ("saunet_tpu_torch.models.saunet", "canny_edges_cuda"),
    "warp": ("saunet_tpu_torch.data.augment", "warp_image_label"),
    "dense_block": ("saunet_tpu_torch.models.fused_encoder", "dense_block"),
}


def _detached(tree):
    if isinstance(tree, tuple):
        return tuple(_detached(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


@contextlib.contextmanager
def recording_kernel_calls():
    """While the block runs, record a copy of the arguments and the result
    of every call the steps make to the K1, K5 and K3 wrappers, in
    {kernel: [(args, kwargs, result)]}; each wrapper is still called once
    a call."""
    seen = {name: [] for name in KERNEL_SITES}
    patched = []

    def recorder(fn, calls):
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((_detached(args), kwargs, _detached(out)))
            return out
        return record

    for name, (module, attr) in KERNEL_SITES.items():
        module = importlib.import_module(module)
        patched.append((module, attr, getattr(module, attr)))
        setattr(module, attr, recorder(patched[-1][2], seen[name]))
    try:
        yield seen
    finally:
        for module, attr, fn in patched:
            setattr(module, attr, fn)


def _kernel_and_plain(name: str):
    from ..ops.cuda import (
        canny_edges_cuda,
        dense_block,
        dense_block_plain,
        warp_image_label,
        warp_image_label_plain,
    )
    from ..ops.edge import canny_edges

    return {"canny": (canny_edges_cuda, canny_edges),
            "warp": (warp_image_label, warp_image_label_plain),
            "dense_block": (dense_block, dense_block_plain)}[name]


def _disagreement(name: str, out, ref) -> dict:
    if name == "canny":
        return {"flips": int((out != ref).sum())}
    if name == "warp":
        return {"max_abs_err": float((out[0] - ref[0]).abs().max()),
                "scale": float(ref[0].abs().max()),
                "label_mismatches": int((out[1] != ref[1]).sum())}
    err = (out.float() - ref.float()).abs()
    return {"max_abs_err": float(err.max()),
            "median_abs_err": float(err.median()),
            "scale": float(ref.float().abs().max())}


def kernel_parity(seen: dict, rows: Optional[int] = None) -> dict:
    """Each recorded kernel result against the kernel's plain version on the
    same inputs: {kernel: [{shape, and canny: flips (pixels that differ);
    warp: max |image difference|, scale = max |plain image|, label
    mismatches; dense_block: max and median |difference|, scale = max
    |plain|}]}. With `rows`, the kernel is called again on the first `rows`
    samples of each recorded input, and that result is held against the
    plain version of the same rows."""
    out = {}
    with torch.inference_mode():
        for name, calls in seen.items():
            kernel, plain = _kernel_and_plain(name)
            out[name] = []
            for args, kwargs, result in calls:
                if rows is not None:
                    args = tuple(a[:rows] if isinstance(a, torch.Tensor)
                                 else a for a in args)
                    result = kernel(*args, **kwargs)
                ref = plain(*args, **kwargs)
                out[name].append({"shape": list(args[0].shape),
                                  **_disagreement(name, result, ref)})
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def bn_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def param_digest(model: nn.Module) -> torch.Tensor:
    """(sum, sum of squares) of every parameter: equal on two ranks whose
    parameters are equal."""
    with torch.no_grad():
        return torch.stack([torch.stack([p.sum(), p.square().sum()])
                            for p in model.parameters()]).cpu()


def _first_step(mesh: DataMesh, weights: Weights,
                batch: Dict[str, np.ndarray], lr: float, dtype: str,
                augment_seed: Optional[int], fix_bn: bool = False,
                shard_map: bool = False, hook=None, space: int = 1,
                model_kwargs: Optional[dict] = None):
    """Build the model (`build_model(weights, dtype, **model_kwargs)`),
    state and step, and take one step on this rank's rows: (result, state,
    step, rows, gen). `hook`: a DDP comm hook for the global-batch step's
    gradient buckets."""
    mesh = mesh.with_space(space)
    model = build_model(weights, dtype, **(model_kwargs or {}))
    tx = radam(lr)
    state = create_train_state(model, tx, mesh=mesh)
    augment = make_augment_fn() if augment_seed is not None else None
    if shard_map:
        step = make_shard_map_train_step(model, tx, mesh, augment_fn=augment)
    else:
        step = make_train_step(model, tx, augment_fn=augment, fix_bn=fix_bn,
                               mesh=mesh)
        if hook is not None:
            step.net.register_comm_hook(mesh.group, hook)
    rows = shard_batch(batch, mesh, split_rows=augment is None)
    gen = (torch.Generator(device=mesh.device).manual_seed(augment_seed)
           if augment is not None else None)
    zero_launches()
    state, metrics = step(state, rows, gen)
    _sync(mesh.device)
    out = {"metrics": _cpu(metrics), "launches": launches(),
           "buffers": bn_buffers(model), "digest": param_digest(model)}
    if mesh.rank == 0:
        out["params"] = {k: v.detach().cpu()
                         for k, v in model.named_parameters()}
    return out, state, step, rows, gen


def train_case(mesh: DataMesh, weights: Weights, batch: Dict[str, np.ndarray],
               lr: float = 1e-3, dtype: str = "float32", fix_bn: bool = False,
               augment_seed: Optional[int] = None,
               shard_map: bool = False, space: int = 1,
               model_kwargs: Optional[dict] = None) -> dict:
    """One step of the global-batch step (or, `shard_map`, of the
    per-rank-loss step) from `weights` on this rank's rows of `batch`
    (`model_kwargs`: the SAUNet's layout options, e.g. encoder_concat and
    remat): its metrics, launches, BatchNorm running statistics, a digest
    of the parameters and, on rank 0, the parameters."""
    return _first_step(mesh, weights, batch, lr, dtype, augment_seed,
                       fix_bn=fix_bn, shard_map=shard_map, space=space,
                       model_kwargs=model_kwargs)[0]


def iou_counts(preds: np.ndarray, labels: np.ndarray, valid: np.ndarray,
               num_class: int = 4):
    """Histogram intersection and union summed over the rows where
    `valid` is set."""
    inter, union = np.zeros(num_class), np.zeros(num_class)
    for j in np.flatnonzero(valid):
        i_, u_ = intersection_and_union(preds[j], labels[j], num_class)
        inter += i_
        union += u_
    return inter, union


def eval_case(mesh: DataMesh, weights: Weights, batch: Dict[str, np.ndarray],
              dtype: str = "float32", num_class: int = 4,
              space: int = 1) -> dict:
    """The mesh eval step on this rank's rows of `batch` (with its `valid`
    entry): this rank's preds, the global metrics, the launches, and the
    histogram IoU counts of this rank's real rows."""
    mesh = mesh.with_space(space)
    model = build_model(weights, dtype)
    state = create_train_state(model, radam(0.0), mesh=mesh)
    rows = shard_batch(batch, mesh)
    zero_launches()
    _, preds, metrics = make_eval_step(model, num_class=num_class,
                                       mesh=mesh)(state, rows)
    _sync(mesh.device)
    counts = launches()
    preds = preds.cpu().numpy()
    inter, union = iou_counts(preds, rows["label"].cpu().numpy(),
                              rows["valid"].cpu().numpy(), num_class)
    return {"preds": preds, "metrics": _cpu(metrics), "launches": counts,
            "inter": inter, "union": union}


def augment_case(mesh: DataMesh, batch: Dict[str, np.ndarray],
                 seed: int) -> dict:
    """This rank's rows of the global batch's augmentation, drawn from a
    generator seeded with `seed` on the rank's device."""
    rows = shard_batch(batch, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    out = make_augment_fn()(gen, rows, shard=(mesh.rank, mesh.world))
    return {"rows": (shard_rows(len(batch["label"]), mesh).start,
                     len(rows["label"])), **_cpu(out)}


#: the op oracles of the 'space' axis: name -> input channels; `space_op`
#: builds each from a fixed seed, the same on every rank and in the parent
SPACE_OPS = {"conv3x3_twice": 3, "conv0": 3, "conv_transpose": 3,
             "max_pool": 3, "avg_pool": 3, "resize_x2": 3, "resize_x4": 3,
             "resize_x16": 3, "se": 16}


def space_op(name: str):
    """op(x, space) -> y for NCHW f32 `x` (its rows on the 'space' axis,
    or the whole tensor with `space` None)."""
    g = torch.Generator().manual_seed(sorted(SPACE_OPS).index(name))

    def seeded(module):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        return module

    def resize(factor):
        def op(x, space):
            h = x.shape[2] if space is None else space.level(x.shape[2])
            return resize_bilinear(x, (h * factor, x.shape[3] * factor),
                                   space)
        return op

    if name == "conv3x3_twice":
        c1, c2 = seeded(Conv2d(3, 8, 3)), seeded(Conv2d(8, 4, 3))

        def op(x, space):
            c1.space = c2.space = space
            return c2(torch.relu(c1(x)))
        return op
    if name in ("conv0", "conv_transpose", "se"):
        m = seeded({"conv0": lambda: Conv2d(3, 8, 7, stride=2, padding=3,
                                            bias=False),
                    "conv_transpose": lambda: ConvTranspose2d(3, 4),
                    "se": lambda: SEModule(16, 4)}[name]())

        def op(x, space):
            for part in m.modules():
                if hasattr(type(part), "space"):
                    part.space = space
            return m(x)
        return op
    if name == "max_pool":
        return lambda x, space: max_pool_2x2(x, space)
    if name == "avg_pool":
        return lambda x, space: pool_2x2(x, torch.nn.functional.avg_pool2d,
                                         space)
    return resize(int(name.split("_x")[1]))


def _rows_of(t: np.ndarray, mesh: DataMesh, dim: int) -> torch.Tensor:
    """This rank's samples and rows (along `dim`) of a global array."""
    t = t[shard_rows(len(t), mesh)]
    lo, hi = mesh.rows(t.shape[dim])
    return torch.from_numpy(np.ascontiguousarray(
        np.take(t, np.arange(lo, hi), axis=dim)))


def space_ops_case(mesh: DataMesh, inputs: Dict[str, np.ndarray],
                   cotangents: Dict[str, np.ndarray], space: int,
                   image: Optional[np.ndarray] = None) -> dict:
    """Each op of SPACE_OPS on this rank's rows of `inputs[name]` (global
    NCHW) on the grid: its rows of the output and of the input gradient
    for the cotangent `cotangents[name]` (global, the output's shape);
    and, with `image` (global NHWC), the rows of its Canny (real
    thresholds 10 and 100) through the rank's gray and band. Also the
    number of row exchanges this ran."""
    mesh = mesh.with_space(space)
    out = {}
    calls = exchange_rows.calls
    for name, x in inputs.items():
        xr = _rows_of(x, mesh, 2).requires_grad_()
        shard = mesh.space_shard(x.shape[2])
        y = space_op(name)(xr, shard)
        (y * _rows_of(cotangents[name], mesh, 2)).sum().backward()
        out[name] = (y.detach(), xr.grad)
    if image is not None:
        shard = mesh.space_shard(image.shape[1])
        gray = image_to_gray255(_rows_of(image, mesh, 1), shard.group)
        out["canny"] = canny_rows(gray, shard, lambda band: canny_edges_cuda(
            band, 10.0, 100.0))
    out["exchanges"] = exchange_rows.calls - calls
    return out


def dense_block_case(mesh: DataMesh, x: np.ndarray, layers: int,
                     seed: int, space: int, concat_mode: str = "chain",
                     remat: bool = False) -> dict:
    """A train-mode DenseBlock(x.shape[1], layers, concat_mode) from
    `seed` (rematerialised with `remat`) on this rank's rows of `x` (global
    NCHW) on the grid, BatchNorm synced over it, loss = sum(out^2) /
    out.numel() of the whole output: this rank's rows of the output, the
    parameter gradients averaged over the ranks (as DDP averages them: the
    true gradient) and the running statistics."""
    mesh = mesh.with_space(space)
    block = init_random_(DenseBlock(x.shape[1], layers, concat_mode),
                         torch.Generator().manual_seed(seed)).train()
    xr = _rows_of(x, mesh, 2)
    with sync_batch_norm(block, mesh.group), \
            partition_space(block, mesh, x.shape[2]):
        y = rematerialised(block, xr) if remat else block(xr)
    loss = all_reduce_sum(torch.sum(y * y), mesh.group) / y.new_tensor(
        float(np.prod(x.shape[:1]) * y.shape[1] * np.prod(x.shape[2:])))
    loss.backward()
    grads = {}
    for k, p in block.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g, group=mesh.group)
        grads[k] = g / mesh.world
    return {"out": y.detach(), "loss": float(loss.detach()), "grads": grads,
            "buffers": bn_buffers(block)}


def dryrun_case(mesh: DataMesh, hw: int) -> float:
    """`dryrun.run_mesh_step` on the group these ranks are in."""
    from .dryrun import run_mesh_step

    return run_mesh_step(mesh.world, hw, device=str(mesh.device))


def run_cases(mesh: DataMesh, cases: Dict[str, tuple]) -> dict:
    """{name: (function name in this module, or 'module:function' in the
    package, kwargs)} -> {name: result}, run in order on the ranks, each
    case's seconds printed."""
    out = {}
    for name, (fn, kwargs) in cases.items():
        if ":" in fn:
            module, attr = fn.split(":")
            fn = getattr(importlib.import_module(module), attr)
        else:
            fn = globals()[fn]
        t0 = time.perf_counter()
        out[name] = fn(mesh, **kwargs)
        print(f"case {name}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def cli_case(mesh: DataMesh, argv: list) -> dict:
    """`cli.train.main(argv)` on this rank (in the group already joined);
    returns the paths this rank passed to `torch.save`."""
    from ..cli.train import main

    saved = []
    save = torch.save

    def recording_save(obj, f, *args, **kwargs):
        saved.append(str(f))
        return save(obj, f, *args, **kwargs)

    torch.save = recording_save
    try:
        main(argv)
    finally:
        torch.save = save
    return {"saved": saved}


def timed_allreduce_hook(spans: list):
    """DDP's default gradient hook (divide by the world, all-reduce), with
    the host clock at each bucket's launch and completion, and the
    bucket's bytes, in `spans`."""
    def hook(group, bucket):
        t0 = time.perf_counter()
        buf = bucket.buffer().div_(dist.get_world_size(group))
        nbytes = buf.numel() * buf.element_size()

        def done(fut):
            spans.append((t0, time.perf_counter(), nbytes))
            return fut.value()[0]

        return dist.all_reduce(buf, group=group,
                               async_op=True).get_future().then(done)
    return hook


def _nccl_device_ms(step_fn) -> float:
    """Device milliseconds of the NCCL kernels of one `step_fn()`
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "nccl" in e.name.lower()) / 1e3


def timed_case(mesh: DataMesh, weights: Weights,
               batch: Dict[str, np.ndarray],
               eval_batch: Optional[Dict[str, np.ndarray]] = None,
               augment_seed: int = 8, dtype: str = "bfloat16",
               lr: float = 1e-4, timed_steps: int = 3,
               plain_turns: int = 0, space: int = 1,
               eval_dtype: Optional[str] = None) -> dict:
    """The data-parallel and 'space' phases' rank side on the card, on the
    (world // space) x space grid, TF32 off: the mesh eval step on this
    rank's rows of `eval_batch` (launches, IoU counts) from `weights` in
    `eval_dtype` (default `dtype`); then the global-batch step with
    augmentation, its first
    step's metrics, launches, BatchNorm statistics and parameter digest
    (and rank 0's parameters). Every K1, K3 and K5 call of the eval and of
    the first step is recorded and held against the kernel's plain version
    on the same inputs (`parity`), and again on their first CLI_ROWS
    samples (`parity_rows`); then
    `timed_steps` more steps on the host clock (median ms), the peak
    memory, and the gradient all-reduce time per step: the host window
    from the first bucket's launch to the last bucket's completion, the
    buckets' bytes and, under NCCL, the NCCL kernels' device time; the
    row exchanges (count and bytes) of each timed step, and one more step
    with every exchange timed alone (`exchange_trace`: buffer shape,
    bytes, seconds).
    With `plain_turns`, the one-process `make_train_step` on another copy
    of the model is timed against the mesh step in turns, with and
    without synced BatchNorm (plain, synced, mesh, mesh, synced, plain,
    ...): the synced BatchNorm's cost is synced - plain, DDP's own cost
    mesh - synced."""
    out = {"backend": mesh.backend, "device": str(mesh.device)}
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if eval_batch is not None:
        with recording_kernel_calls() as seen:
            out["eval"] = eval_case(mesh, weights, eval_batch,
                                    eval_dtype or dtype, space=space)
        out["eval"].update(parity=kernel_parity(seen),
                           parity_rows=kernel_parity(seen, CLI_ROWS))
        del seen
        if cuda:
            torch.cuda.empty_cache()
    spans: list = []
    with recording_kernel_calls() as seen:
        first, state, step, rows, gen = _first_step(
            mesh, weights, batch, lr, dtype, augment_seed,
            hook=timed_allreduce_hook(spans), space=space)
    out.update(first, parity=kernel_parity(seen),
               parity_rows=kernel_parity(seen, CLI_ROWS))
    del seen

    def one():
        nonlocal state
        state, m = step(state, rows, gen)
        float(m["loss"])
        _sync(mesh.device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    times, windows, exchanges, bucket_bytes = [], [], [], []
    for _ in range(timed_steps):
        spans.clear()
        calls, nbytes = exchange_rows.calls, exchange_rows.bytes
        t0 = time.perf_counter()
        one()
        times.append((time.perf_counter() - t0) * 1e3)
        windows.append((max(b for _, b, _ in spans)
                        - min(a for a, _, _ in spans)) * 1e3)
        bucket_bytes.append(sum(n for _, _, n in spans))
        exchanges.append((exchange_rows.calls - calls,
                          exchange_rows.bytes - nbytes))
    if space > 1:
        exchange_rows.trace = []
        one()
        out["exchange_trace"], exchange_rows.trace = exchange_rows.trace, None
    out.update(step_ms=times, allreduce_window_ms=windows,
               buckets=len(spans), bucket_bytes=bucket_bytes,
               exchanges=exchanges,
               peak_memory_bytes=(torch.cuda.max_memory_allocated(
                   mesh.device) if cuda else None))
    if mesh.backend == "nccl":
        out["nccl_device_ms"] = _nccl_device_ms(one)
    if plain_turns:
        pmodel = build_model(weights, dtype)
        ptx = radam(lr)
        pstate = create_train_state(pmodel, ptx, mesh.device)
        pstep = make_train_step(pmodel, ptx, augment_fn=make_augment_fn())
        pgen = torch.Generator(device=mesh.device).manual_seed(augment_seed)

        def plain():
            nonlocal pstate
            pstate, m = pstep(pstate, rows, pgen)
            float(m["loss"])
            _sync(mesh.device)

        def synced():
            with sync_batch_norm(pmodel, mesh.group):
                plain()

        runs = {"plain": plain, "synced": synced, "mesh": one}
        plain()  # warm-up
        synced()
        turns = {name: [] for name in runs}
        for i in range(plain_turns):
            for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                t0 = time.perf_counter()
                runs[name]()
                turns[name].append((time.perf_counter() - t0) * 1e3)
        out["turns_ms"] = turns
    return out
