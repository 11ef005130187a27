"""Dual-task loss: class-weighted cross-entropy + soft Dice + edge BCE
(counterpart of saunet_tpu/train/losses.py::dual_loss and its parts).

Layouts are the JAX package's: logits (N, H, W, C), edge probabilities
(N, H, W, 1), labels (N, H, W) int. All reductions run in f32 whatever the
model's compute dtype. `sample_mask` (N,) {0, 1} removes padded samples
from every reduction. The lane-packed `dual_loss_packed` is a TPU layout of
the same math and is not ported. The reference's dormant losses
(`image_based_cross_entropy`, `label_smooth_softmax_ce`,
`edge_attention_loss`) are here for inventory parity; no step uses them.

`group` (a process group, or None) makes each loss the loss of the global
batch whose rows the ranks of `group` hold: every sum in a ratio or a mean
is all-reduced (differentiably) before the division, as the JAX step's
global arrays are reduced under SPMD jit. Without a group each function
computes what it computes on one process.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..parallel.collectives import all_reduce_sum

DEFAULT_CLASS_WEIGHTS = (1.0, 4.0, 5.0, 1.0)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights=DEFAULT_CLASS_WEIGHTS,
                           sample_mask: Optional[torch.Tensor] = None,
                           group=None) -> torch.Tensor:
    """Weighted mean of the pixel NLL, normalised by the sum of the pixel
    weights (torch's `CrossEntropyLoss(weight=...)` semantics)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[labels]
    if sample_mask is not None:
        w = w * sample_mask.float()[:, None, None]
    if group is not None:
        num, den = all_reduce_sum(
            torch.stack([torch.sum(w * nll), torch.sum(w)]), group)
        return num / den
    return torch.sum(w * nll) / torch.sum(w)


def dice_loss(labels: torch.Tensor, logits: torch.Tensor, eps: float = 1e-7,
              sample_mask: Optional[torch.Tensor] = None,
              group=None) -> torch.Tensor:
    """1 - soft Dice over softmax probabilities, reduced over (N, H, W)
    jointly and averaged over classes."""
    logits = logits.float()
    probas = torch.softmax(logits, dim=-1)
    one_hot = torch.nn.functional.one_hot(
        labels.long(), logits.shape[-1]).float()
    if sample_mask is not None:
        m = sample_mask.float()[:, None, None, None]
        probas = probas * m
        one_hot = one_hot * m
    dims = (0, 1, 2)
    intersection = torch.sum(probas * one_hot, dim=dims)
    cardinality = torch.sum(probas + one_hot, dim=dims)
    if group is not None:
        intersection, cardinality = all_reduce_sum(
            torch.stack([intersection, cardinality]), group)
    return 1.0 - torch.mean(2.0 * intersection / (cardinality + eps))


def edge_bce(edge_probs: torch.Tensor, edge_targets: torch.Tensor,
             eps: float = 1e-7,
             sample_mask: Optional[torch.Tensor] = None,
             group=None) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities clipped to [eps, 1-eps]."""
    p = torch.clamp(edge_probs.float(), eps, 1.0 - eps)
    t = edge_targets.float()
    ll = t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)
    if group is not None:
        if sample_mask is None:
            count = ll.new_tensor(float(ll.numel()))
        else:
            m = sample_mask.float().reshape((-1,) + (1,) * (ll.dim() - 1))
            ll = ll * m
            count = torch.sum(sample_mask.float()) * float(ll[0].numel())
        total, count = all_reduce_sum(torch.stack([torch.sum(ll), count]),
                                      group)
        return -total / count
    if sample_mask is None:
        return -torch.mean(ll)
    m = sample_mask.float().reshape((-1,) + (1,) * (ll.dim() - 1))
    px = float(ll[0].numel())
    return -torch.sum(ll * m) / (torch.sum(sample_mask.float()) * px)


def dual_loss(seg_logits: torch.Tensor, edge_probs: torch.Tensor,
              seg_targets: torch.Tensor, edge_targets: torch.Tensor,
              class_weights=DEFAULT_CLASS_WEIGHTS,
              sample_mask: Optional[torch.Tensor] = None, group=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {'loss', 'ce', 'dice', 'edge'}); total = dice + ce + edge."""
    if edge_targets.dim() == edge_probs.dim() - 1:
        edge_targets = edge_targets[..., None]
    ce = weighted_cross_entropy(seg_logits, seg_targets, class_weights,
                                sample_mask=sample_mask, group=group)
    dice = dice_loss(seg_targets, seg_logits, sample_mask=sample_mask,
                     group=group)
    edge = edge_bce(edge_probs, edge_targets, sample_mask=sample_mask,
                    group=group)
    total = dice + ce + edge
    return total, {"loss": total, "ce": ce, "dice": dice, "edge": edge}


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def image_based_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                              upper_bound: float = 1.0, norm: bool = False,
                              batch_weights: bool = False) -> torch.Tensor:
    """Histogram-weighted CE (the reference's dormant
    ImageBasedCrossEntropyLoss2d): per-image (or, with `batch_weights`,
    per-batch) class frequencies reweight the NLL, rare classes counting
    more; per-image weighted means of the NLL, summed over the images."""
    nll = _nll(logits, labels)
    one_hot = torch.nn.functional.one_hot(labels.long(),
                                          logits.shape[-1]).float()
    dims = (0, 1, 2) if batch_weights else (1, 2)
    hist = one_hot.sum(dim=dims)
    hist = hist / hist.sum(dim=-1, keepdim=True)
    if norm:
        w = torch.where(hist > 0, upper_bound / hist.clamp(min=1e-12),
                        torch.zeros_like(hist)) + 1.0
    else:
        w = torch.where(hist > 0, upper_bound * (1.0 - hist),
                        torch.zeros_like(hist)) + 1.0
    if batch_weights:
        pix_w = w[labels.long()]
    else:
        pix_w = torch.gather(w[:, None, None, :].expand(*labels.shape, -1),
                             -1, labels.long()[..., None])[..., 0]
    per_img = ((pix_w * nll).sum(dim=(1, 2))
               / pix_w.sum(dim=(1, 2)).clamp(min=1e-12))
    return per_img.sum()


def label_smooth_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                            lb_pos: float = 0.9, lb_neg: float = 0.005,
                            reduction: str = "mean",
                            lb_ignore: int = -1) -> torch.Tensor:
    """Label-smoothed softmax CE (the reference's dormant
    LabelSmoothSoftmaxCE): targets lb_pos on the label and lb_neg
    elsewhere; pixels labelled `lb_ignore` count nothing. `reduction`
    'mean' (over the counted pixels), 'sum' or anything else (per pixel)."""
    logs = torch.log_softmax(logits.float(), dim=-1)
    ignore = labels == lb_ignore
    safe = torch.where(ignore, torch.zeros_like(labels), labels).long()
    one_hot = torch.nn.functional.one_hot(safe, logits.shape[-1]).float()
    smoothed = lb_pos * one_hot + lb_neg * (1.0 - one_hot)
    loss = -(logs * smoothed).sum(dim=-1)
    loss = torch.where(ignore, torch.zeros_like(loss), loss)
    if reduction == "mean":
        return loss.sum() / (~ignore).sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    return loss


def edge_attention_loss(seg_logits: torch.Tensor, seg_targets: torch.Tensor,
                        edge_probs: torch.Tensor, threshold: float = 0.8,
                        class_weights=DEFAULT_CLASS_WEIGHTS) -> torch.Tensor:
    """Class-weighted CE over the pixels whose predicted edge probability
    (the largest over the last axis) exceeds `threshold`: the reference's
    dormant edge-attention term."""
    nll = _nll(seg_logits, seg_targets)
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=seg_logits.device)[seg_targets.long()]
    mask = (edge_probs.amax(dim=-1) > threshold).float()
    return (w * nll * mask).sum() / (w * mask).sum().clamp(min=1.0)
