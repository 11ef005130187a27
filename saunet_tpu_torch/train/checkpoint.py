"""Checkpoint and resume (counterpart of saunet_tpu/train/checkpoint.py).

`save_checkpoint` writes the whole train state, `state_<tag>.pt` (model
state_dict, optimizer state_dict, step, history), plus `history_<tag>.json`,
so `restore_checkpoint` resumes exactly. `restore_params_only` takes the
model weights alone from such a file, from a bare `torch.save`d model
state_dict, or from a JAX package checkpoint (`state_<tag>.msgpack`, read
by `load_jax_variables` without flax): the reference's `--weights_unet`
warm start, and what `test_and_pack --checkpoint` and `saliency
--checkpoint` read. `restore_checkpoint` takes up either kind of file: a
JAX checkpoint's params, batch_stats, optax state and step become the
port's weights, optimizer moments and step (`optim.load_jax_opt_state`),
so a run started on the TPU goes on exactly. `BestIoUPolicy` is the
reference's rule for when to save.
Under a process group rank 0 alone writes, and every rank reads.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.jax_weights import from_jax_variables
from ..parallel.mesh import barrier
from ..utils import msgpack
from .optim import load_jax_opt_state
from .state import TrainState


def save_checkpoint(ckpt_dir: str, tag: str, state: TrainState,
                    history: Dict) -> str:
    """Write `state_<tag>.pt` and `history_<tag>.json`; returns the .pt
    path. Under a process group only rank 0 writes (the ranks hold equal
    states), and every rank waits until it has written."""
    path = os.path.join(ckpt_dir, f"state_{tag}.pt")
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step),
                    "history": _jsonable(history)}, path)
        with open(os.path.join(ckpt_dir, f"history_{tag}.json"), "w") as f:
            json.dump(_jsonable(history), f)
    barrier(state.device)
    return path


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _is_jax_checkpoint(path: str) -> bool:
    return path.endswith(".msgpack")


def _numpy_tree(tree, copy: bool = True):
    """A msgpack tree with numpy leaves (bfloat16 leaves widened to
    float32), copied out of the file's buffer unless `copy` is False."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.array(tree) if copy else np.asarray(tree)


def _load_jax_train_state(path: str) -> dict:
    raw = msgpack.load(path)
    if not isinstance(raw, dict) or not {"params", "batch_stats"} <= set(raw):
        raise KeyError(f"{path}: not a JAX train-state checkpoint (no "
                       f"params and batch_stats)")
    return raw


def load_jax_variables(path: str) -> Dict[str, dict]:
    """{'params', 'batch_stats'} of a JAX package checkpoint (flax's
    msgpack of its TrainState), as nested dicts of numpy arrays, copied out
    of the file's buffer (bfloat16 leaves widened to float32); the
    checkpoint's `opt_state` and `step` are skipped."""
    raw = _load_jax_train_state(path)
    return {k: _numpy_tree(raw[k]) for k in ("params", "batch_stats")}


def restore_jax_train_state(raw: dict, state: TrainState) -> TrainState:
    """Load a JAX package train state, as `utils.msgpack.load` reads it
    from a checkpoint (params, batch_stats, opt_state, step), into
    `state`: the weights, the optimizer's moments on their parameters'
    device (`optim.load_jax_opt_state`: the optax state must be of
    `state.optimizer`'s kind, its counts equal to the step) and the step.
    Returns `state`."""
    if not {"params", "batch_stats", "opt_state", "step"} <= set(raw):
        raise KeyError(f"not a JAX train state: keys {sorted(raw)}")
    # the layout map copies every leaf out of the file's buffer
    weights = from_jax_variables({k: _numpy_tree(raw[k], copy=False)
                                  for k in ("params", "batch_stats")})
    step = int(np.asarray(raw["step"]))
    load_jax_opt_state(state.optimizer, state.model,
                       _numpy_tree(raw["opt_state"], copy=False), step)
    state.model.load_state_dict(weights)
    state.step = step
    state._folded = None
    return state


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the model, optimizer and step of `path`, a port checkpoint
    (`.pt`) or a JAX package checkpoint (`.msgpack`:
    `restore_jax_train_state`), into `state`; returns it."""
    if _is_jax_checkpoint(path):
        return restore_jax_train_state(_load_jax_train_state(path), state)
    ckpt = _load(path)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state._folded = None
    return state


def restore_params_only(path: str, model: nn.Module) -> nn.Module:
    """Load only the weights (parameters and BN statistics) of a train
    checkpoint, of a bare model state_dict, or of a JAX package checkpoint
    (a `.msgpack` file) into `model`; returns it."""
    if _is_jax_checkpoint(path):
        model.load_state_dict(from_jax_variables(load_jax_variables(path)))
        return model
    ckpt = _load(path)
    is_train_state = (set(ckpt) == {"model", "optimizer", "step", "history"}
                      and isinstance(ckpt["model"], dict))
    model.load_state_dict(ckpt["model"] if is_train_state else ckpt)
    return model


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return np.asarray(x).tolist()
    return x


class BestIoUPolicy:
    """The reference's checkpoint decision rule: track the best per-class
    IoU (3 classes) and the best mean IoU; checkpoint on any improvement
    after `warmup` epochs, plus every `period` epochs and at the final
    epoch."""

    def __init__(self, warmup: int = 15, period: int = 50):
        self.warmup = warmup
        self.period = period
        self.best: Dict[str, float] = {
            "mIoU_1": 0.0, "mIoU_2": 0.0, "mIoU_3": 0.0, "mIoU": 0.0}
        self.best_epoch: Dict[str, int] = {
            "epoch_1": 0, "epoch_2": 0, "epoch_3": 0, "epoch": 0}

    def update(self, epoch: int, iou: np.ndarray, num_epoch: int) -> bool:
        """iou: per-class IoU (classes 1..3). True when a checkpoint should
        be written."""
        improved = False
        for i, v in enumerate(iou, start=1):
            if v > self.best[f"mIoU_{i}"]:
                self.best[f"mIoU_{i}"] = float(v)
                self.best_epoch[f"epoch_{i}"] = epoch
                improved = True
        mean = float(np.mean(iou))
        if mean > self.best["mIoU"]:
            self.best["mIoU"] = mean
            self.best_epoch["epoch"] = epoch
            improved = True

        if epoch % self.period == 0 or epoch == num_epoch:
            return True
        if epoch < self.warmup:
            return False
        return improved
