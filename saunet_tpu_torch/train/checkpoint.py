"""Checkpoint and resume (counterpart of saunet_tpu/train/checkpoint.py).

`save_checkpoint` writes the whole train state, `state_<tag>.pt` (model
state_dict, optimizer state_dict, step, history), plus `history_<tag>.json`,
so `restore_checkpoint` resumes exactly. `restore_params_only` takes the
model weights alone from such a file or from a bare `torch.save`d model
state_dict: the reference's `--weights_unet` warm start, and what
`test_and_pack --checkpoint` reads. Reading the JAX package's `.msgpack`
checkpoints is not ported yet. `BestIoUPolicy` is the reference's rule for
when to save.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from .state import TrainState


def save_checkpoint(ckpt_dir: str, tag: str, state: TrainState,
                    history: Dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"state_{tag}.pt")
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step),
                "history": _jsonable(history)}, path)
    with open(os.path.join(ckpt_dir, f"history_{tag}.json"), "w") as f:
        json.dump(_jsonable(history), f)
    return path


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the model, optimizer and step of `path` into `state`; returns
    it."""
    ckpt = _load(path)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state._folded = None
    return state


def restore_params_only(path: str, model: nn.Module) -> nn.Module:
    """Load only the weights (parameters and BN statistics) of a train
    checkpoint, or of a bare model state_dict, into `model`; returns it."""
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
