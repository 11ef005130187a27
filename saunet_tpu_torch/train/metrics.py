"""Segmentation metrics (counterpart of saunet_tpu/train/metrics.py).

`pixel_acc` runs on the step's tensors, on their device (with `group`, on
the counts summed over its ranks: the metrics of the global batch); the
others are host-side numpy, accumulated by the eval loop.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..parallel.collectives import all_reduce_sum


def pixel_acc(preds: torch.Tensor, labels: torch.Tensor,
              num_class: int, group=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """preds/labels (N, H, W) int -> (foreground accuracy over label >= 1,
    per-class Jaccard of classes 1..num_class-1), f32 tensors."""
    labels = labels.long()
    preds = preds.long()
    valid = labels >= 1
    acc_sum = (valid & (preds == labels)).sum().float()
    pixel_sum = valid.sum().float()

    cls = torch.arange(1, num_class, device=labels.device)[:, None, None,
                                                         None]
    v = labels[None] == cls
    p = preds[None] == cls
    anb = (v & p).sum(dim=(1, 2, 3)).float()
    denom = (v.sum(dim=(1, 2, 3)) + p.sum(dim=(1, 2, 3))).float() - anb
    if group is not None:
        sums = all_reduce_sum(torch.cat([torch.stack([acc_sum, pixel_sum]),
                                         anb, denom]), group)
        acc_sum, pixel_sum = sums[0], sums[1]
        anb, denom = sums[2:].chunk(2)
    acc = acc_sum / (pixel_sum + 1e-10)
    return acc, anb / (denom + 1e-10)


def intersection_and_union(pred: np.ndarray, label: np.ndarray,
                           num_class: int) -> Tuple[np.ndarray, np.ndarray]:
    """Histogram intersection and union per class."""
    pred = np.asarray(pred).astype(np.int64) + 1
    label = np.asarray(label).astype(np.int64) + 1
    pred = pred * (label > 0)

    intersection = pred * (pred == label)
    area_inter, _ = np.histogram(intersection, bins=num_class,
                                 range=(1, num_class))
    area_pred, _ = np.histogram(pred, bins=num_class, range=(1, num_class))
    area_lab, _ = np.histogram(label, bins=num_class, range=(1, num_class))
    return area_inter, area_pred + area_lab - area_inter


def accuracy(preds: np.ndarray, label: np.ndarray):
    """Valid-pixel accuracy over label >= 0: (accuracy, valid pixel count)."""
    valid = label >= 0
    acc_sum = np.sum(valid * (preds == label))
    valid_sum = np.sum(valid)
    return float(acc_sum) / (float(valid_sum) + 1e-10), valid_sum


def dice_coefficient(pred: np.ndarray, label: np.ndarray,
                     num_class: int) -> np.ndarray:
    """Per-class Dice for classes 1..num_class-1."""
    dices = []
    for c in range(1, num_class):
        p = pred == c
        lab = label == c
        inter = np.sum(p & lab)
        denom = p.sum() + lab.sum()
        dices.append(2.0 * inter / denom if denom > 0 else 1.0)
    return np.asarray(dices)
