"""Train state and the train, eval and infer steps (counterpart of
saunet_tpu/train/state.py).

`TrainState` holds the model, the optimizer (with its state) and the step
count; the steps update it in place and return it, where the JAX steps
return a new pytree. `InferState` (model + device, plus the dense-block
operands folded once) serves; `serve_volume` serves one volume from the
host and back, as `cli/test_and_pack.py` serves a study. Layouts at the
steps are the JAX package's: NHWC images in, (N, H, W) predictions out,
NHWC probabilities, edge and attention maps. Every entry point runs on
the card unless the caller names another device.

Data parallel (`mesh`, a parallel.DataMesh): `create_train_state` puts the
model on the rank's device and copies rank 0's weights to every rank;
`make_train_step(mesh=...)` is the JAX package's global-batch step as its
('data',) mesh runs it. Each rank holds a block of rows of the global batch
(`parallel.shard_batch`), BatchNorm takes its statistics over every rank,
the loss and the metrics are those of the global batch, the augmentation
is drawn for the global batch, and DistributedDataParallel averages the
gradients. `make_eval_step(mesh=...)` runs each rank's rows and reduces
the masked loss and the metrics' counts over the ranks.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import normalize_for_eval
from ..models.blocks import partition_space
from ..models.fused_encoder import encoder_apply_fused, fold_encoder
from ..models.norm import sync_batch_norm
from ..parallel.mesh import DataMesh, broadcast_module_
from ..utils.profiling import annotate
from . import infer_graph
from .losses import DEFAULT_CLASS_WEIGHTS, dual_loss
from .metrics import pixel_acc


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """`device`, or the first CUDA device when None; raises when the card
    that is asked for (or defaulted to) is missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return device


class InferState:
    """A model in eval mode on `device` (default: the card), with its
    dense-block kernel operands folded once, and the infer step's CUDA
    graphs of it (`train/infer_graph.py`: `graphs` by key, their memory
    pool and capture stream). The folded operands and the graphs hold the
    model as it was: re-create the state after changing weights or the
    model's settings."""

    def __init__(self, model, device: Optional[torch.device | str] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.folded = fold_encoder(self.model.encoder, model.dtype)
        self.graphs: dict = {}
        self.graph_pool = self.capture_stream = None


class TrainState:
    """The model (on its device), the optimizer made by `tx` from it, the
    number of steps taken, and the dense-block operands folded for the eval
    step (refolded when the step count moves)."""

    def __init__(self, model: nn.Module, tx: Callable, device: torch.device,
                 step: int = 0):
        self.device = device
        self.model = model
        self.tx = tx
        self.optimizer = tx(model)
        self.step = step
        self._folded = None

    def folded_encoder(self):
        if self._folded is None or self._folded[0] != self.step:
            self._folded = (self.step, fold_encoder(self.model.encoder,
                                                    self.model.dtype))
        return self._folded[1]


def create_train_state(model: nn.Module, tx: Callable,
                       device: Optional[torch.device | str] = None,
                       mesh: Optional[DataMesh] = None) -> TrainState:
    """Move `model` to `device` (default: the card; with `mesh`, the
    rank's device, and rank 0's weights copied to every rank) and build
    its optimizer with `tx` (train/optim.py)."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"create_train_state: device {device} is not "
                             f"the rank's {mesh.device}")
        model = model.to(mesh.device)
        broadcast_module_(model, mesh)
        return TrainState(model, tx, mesh.device)
    device = resolve_device(device)
    return TrainState(model.to(device), tx, device)


def _check_state(state, model, what: str) -> None:
    # as in the JAX steps, `model` is the computation and `state` holds its
    # weights
    if state.model is not model:
        raise ValueError(f"{what}: state holds another model")


def _batch_on(batch: Dict[str, torch.Tensor], device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def ddp(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """`model` in DistributedDataParallel over `mesh` (gradients averaged
    over the ranks; buffers not broadcast: synced BatchNorm keeps the
    running statistics equal on every rank)."""
    from torch.nn.parallel import DistributedDataParallel

    ids = [mesh.device] if mesh.device.type == "cuda" else None
    with warnings.catch_warnings():
        # newer torch calls broadcast_buffers deprecated in favour of an
        # argument older ones lack; its meaning is unchanged
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(model, device_ids=ids,
                                       process_group=mesh.group,
                                       broadcast_buffers=False)


def make_train_step(model: nn.Module, tx: Callable, num_class: int = 4,
                    class_weights=DEFAULT_CLASS_WEIGHTS,
                    augment_fn: Optional[Callable] = None,
                    fix_bn: bool = False, mesh: Optional[DataMesh] = None):
    """`step(state, batch, gen=None) -> (state, metrics)`: optional
    augmentation `augment_fn(gen, batch)`, the forward in train mode, the
    dual loss, backward and the optimizer update, and the metrics `loss`,
    `ce`, `dice`, `edge`, `acc` and `jaccard` (of the forward before the
    update), as tensors on the state's device.

    batch: {image (N, H, W, 3), label (N, H, W), edge (N, H, W, 1)}, or the
    augmentation's input {image (N, H, W), label} with `augment_fn`.
    `fix_bn` keeps every BatchNorm in eval mode (running statistics
    untouched) while all parameters, the BN affine included, still get
    gradients: the reference's --fix_bn.

    mesh: the global-batch step over the ranks (module docstring); `batch`
    is then this rank's samples (`parallel.shard_batch`), `gen` in the
    same state on every rank, and the metrics are the global batch's. On a
    'space' axis the batch holds the rank's rows of its samples
    (`shard_batch`'s default), or, with `augment_fn`, its samples whole
    (`split_rows=False`: the warp reads the whole source image), of which
    the augmentation keeps the rank's rows. The state must come from
    `create_train_state(..., mesh=mesh)`."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    group = None if mesh is None else mesh.group
    net = model if mesh is None else ddp(model, mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             gen: Optional[torch.Generator] = None):
        _check_state(state, model, "make_train_step")
        if state.tx is not tx:
            raise ValueError("make_train_step: state holds another "
                             "optimizer")
        batch = _batch_on(batch, state.device)
        height = batch["image"].shape[1]
        if augment_fn is not None:
            batch = (augment_fn(gen, batch) if mesh is None else
                     augment_fn(gen, batch,
                                shard=(mesh.data_index, mesh.data),
                                rows=(mesh.rows(height) if mesh.space > 1
                                      else None)))
        elif mesh is not None:
            height = mesh.global_rows(height)
        model.train()
        if fix_bn:
            for m in bns:
                m.eval()
        with sync_batch_norm(model, group), \
                partition_space(model, mesh, height):
            seg, edge = net(batch["image"].permute(0, 3, 1, 2))
        seg = seg.permute(0, 2, 3, 1)
        total, parts = dual_loss(seg, edge.permute(0, 2, 3, 1),
                                 batch["label"], batch["edge"],
                                 class_weights, group=group)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc, jaccard = pixel_acc(seg.argmax(dim=-1), batch["label"],
                                     num_class, group=group)
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["acc"] = acc
        metrics["jaccard"] = jaccard
        return state, metrics

    step.net = net  # the DDP wrapper on a mesh (for comm hooks)
    return step


def use_fused_encoder(model: nn.Module, images: torch.Tensor) -> bool:
    """The dense-block kernel encoder serves a bf16 model on a CUDA tensor
    (counterpart of `_use_fused_encoder`: the kernel takes bf16 only) whose
    `act` is ReLU, the kernel's; any other model or device runs the plain
    forward."""
    return (images.is_cuda and getattr(model, "dtype", None) == torch.bfloat16
            and getattr(model, "act", F.relu) is F.relu)


def _forward_eval(model, folded, images: torch.Tensor, fused: bool,
                  return_att: bool = False):
    """Eval forward of NHWC images: (logits NCHW, edge NCHW[, atts])."""
    x = images.permute(0, 3, 1, 2)
    if not fused:
        return model(x, return_att=return_att)
    with annotate("saunet.encoder"):
        _, *taps = encoder_apply_fused(model.encoder, folded, images,
                                       model.dtype)
    return model.decode([t.permute(0, 3, 1, 2) for t in taps], x,
                        return_att=return_att)


def make_eval_step(model: nn.Module, num_class: int = 4,
                   class_weights=DEFAULT_CLASS_WEIGHTS,
                   with_probs: bool = False,
                   mesh: Optional[DataMesh] = None):
    """`step(state, batch) -> (probs | None, preds, metrics)` in eval mode:
    the dual loss (masked by the optional (N,) `valid` entry, so a padded
    last batch reports the loss of its real samples only), `acc` and
    `jaccard`. The encoder runs on the dense-block kernel for a bf16 model
    on the card (`use_fused_encoder`).

    mesh: `batch` is this rank's rows of a global batch (its rows of its
    samples on a 'space' axis); probs and preds are this rank's, the loss
    and the metrics the global batch's (eval BatchNorm reads the running
    statistics, so BatchNorm needs no collective; the 'space' axis's
    exchanges still run). A 'space' axis runs the plain encoder."""
    group = None if mesh is None else mesh.group
    space = mesh is not None and mesh.space > 1

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _check_state(state, model, "make_eval_step")
        batch = _batch_on(batch, state.device)
        images = batch["image"]
        fused = use_fused_encoder(model, images) and not space
        height = images.shape[1] if mesh is None else \
            mesh.global_rows(images.shape[1])
        model.eval()
        with torch.inference_mode(), partition_space(model, mesh, height):
            seg, edge = _forward_eval(
                model, state.folded_encoder() if fused else None, images,
                fused)
            seg = seg.permute(0, 2, 3, 1)
            total, parts = dual_loss(seg, edge.permute(0, 2, 3, 1),
                                     batch["label"], batch["edge"],
                                     class_weights,
                                     sample_mask=batch.get("valid"),
                                     group=group)
            preds = seg.argmax(dim=-1)
            acc, jaccard = pixel_acc(preds, batch["label"], num_class,
                                     group=group)
            probs = torch.softmax(seg, dim=-1) if with_probs else None
        metrics = dict(parts)
        metrics["acc"] = acc
        metrics["jaccard"] = jaccard
        return probs, preds, metrics

    return step


def make_infer_step(model, with_probs: bool = False, with_edge: bool = False,
                    with_att: bool = False):
    """Inference: `step(state, images)` -> (probs, preds, edge), plus the 7
    attention/gate maps as a fourth element when `with_att` is set.

    images: (N, H, W, 3). preds: (N, H, W) int64. probs (N, H, W, C) and
    edge (N, H, W, 1) are None unless `with_probs` / `with_edge` is set.
    The encoder runs on the dense-block kernel for a bf16 model on the card
    (`use_fused_encoder`); any other model or device takes the plain
    forward.

    On the card the step replays a CUDA graph of itself, captured for each
    padded batch shape on the state (`train/infer_graph.py`: eager at a
    shape's first call, captured at its second, replayed from its third),
    and returns fresh tensors every call. It runs eager on the CPU, while
    any module of the model is in training mode, and while any module has
    a forward hook or pre-hook, or a global one is set: a replay runs no
    Python and would skip them. The step counts its calls in `.eager_calls`,
    `.captures` and `.replays`."""
    modules = list(model.modules())
    outputs = (with_probs, with_edge, with_att)

    def forward(state: InferState, x: torch.Tensor):
        m = state.model
        fused = use_fused_encoder(m, x)
        out = _forward_eval(m, state.folded if fused else None, x, fused,
                            with_att)
        with annotate("saunet.head"):
            seg, edge_full = out[0], out[1]
            preds = seg.argmax(dim=1)
            probs = (torch.softmax(seg, dim=1).permute(0, 2, 3, 1)
                     if with_probs else None)
            edge = edge_full.permute(0, 2, 3, 1) if with_edge else None
            if with_att:
                return probs, preds, edge, [a.permute(0, 2, 3, 1)
                                            for a in out[2]]
            return probs, preds, edge

    def step(state: InferState, images: torch.Tensor):
        _check_state(state, model, "make_infer_step")
        with annotate("saunet.step"), torch.inference_mode():
            x = images.to(state.device)
            if not infer_graph.graphable(x, modules):
                step.eager_calls += 1
                return forward(state, x)
            return infer_graph.call(step, state,
                                    infer_graph.key(x, outputs), forward, x)

    step.eager_calls = step.captures = step.replays = 0
    return step


def serve_volume(state: InferState, infer: Callable, slices: np.ndarray,
                 z_bucket: int):
    """One volume served as `cli/test_and_pack.py` serves a study: the
    (Z, H, W) float32 `slices` padded with zero slices to a multiple of
    `z_bucket` on the host, then copied to the state's device, z-scored
    (`normalize_for_eval`), run through `infer` (a `make_infer_step`
    step) and its labels of the Z real slices brought back to the host.
    Returns (labels (Z, H, W) int64, the step's outputs, seconds from
    handing the padded array over to having the labels).

    Spans: `saunet.serve` (the timed section) over `saunet.copy_in`,
    `saunet.normalize`, the step's `saunet.step` and
    `saunet.labels_out`."""
    z = slices.shape[0]
    padded = np.zeros((-(-z // z_bucket) * z_bucket,) + slices.shape[1:],
                      np.float32)
    padded[:z] = slices
    with annotate("saunet.serve"):
        tic = time.perf_counter()
        with annotate("saunet.copy_in"):
            x = torch.from_numpy(padded).to(state.device)
        with annotate("saunet.normalize"):
            batch = normalize_for_eval(x)
        out = infer(state, batch)
        with annotate("saunet.labels_out"):
            labels = out[1][:z].cpu().numpy()  # waits for the device
        seconds = time.perf_counter() - tic
    return labels, out, seconds
