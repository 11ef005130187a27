"""BatchNorm with flax's semantics (counterpart of saunet_tpu/models/norm.py,
flax 0.12 `nn.BatchNorm`).

flax's `nn.BatchNorm(dtype=bf16)` keeps f32 parameters and statistics,
normalises in f32 and returns the compute dtype. `BatchNorm2d` does the
same: it runs in f32 whatever the input type and casts back to it.

In train mode it normalises with the batch mean and the biased batch
variance, and updates the running statistics with that same biased
variance: `ra = 0.9 * ra + 0.1 * batch` (flax momentum 0.9). torch's own
BatchNorm2d normalises with the biased variance too but updates
`running_var` with the unbiased one, so the update is done here. The batch
statistics come from torch's batch norm (two-pass/Welford, not flax's
`E[x^2] - E[x]^2`): the two agree to f32 rounding unless a channel's mean
dwarfs its spread.

Synced BatchNorm (the counterpart of `cfg.MODEL.BN_AXIS_NAME`): inside
`sync_batch_norm(model, group)` a train-mode BatchNorm takes its
statistics over every rank of `group`. One differentiable all-reduce of the
stacked f32 (sum x, sum x^2, n) a layer gives the global mean and
var = max(0, E[x^2] - E[x]^2), flax's fast variance under `pmean`; the
running statistics update with them as above. Without a group nothing of
this runs. `batch_stats` is that computation on its own, with or without a
group: the fused dense block (ops/dense_block_train.py) takes its
statistics from it and folds them in with `update_running`.

A rematerialised block (models/densenet.py, `remat`) runs its forward
again during the backward; inside `frozen_running_stats` the running
statistics stay as the first forward left them, so they move once a step,
as under flax's `nn.remat`.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from ..utils.config import BN_EPS, BN_MOMENTUM


def batch_stats(x: torch.Tensor, group=None):
    """flax's batch statistics of NCHW `x`: the f32 per-channel mean and
    the fast variance max(0, E[x^2] - E[x]^2) over (N, H, W) and, with a
    process group, over its ranks (one differentiable all-reduce of the
    stacked (sum x, sum x^2, n))."""
    xf = x.float()
    c = xf.shape[1]
    dims = (0, 2, 3)
    n = xf.new_full((c,), float(xf.numel() // c))
    sums = all_reduce_sum(
        torch.stack([xf.sum(dims), (xf * xf).sum(dims), n]), group)
    mean = sums[0] / sums[2]
    return mean, torch.clamp(sums[1] / sums[2] - mean * mean, min=0.0)


class BatchNorm2d(nn.BatchNorm2d):
    #: the process group whose ranks share the batch statistics (set by
    #: `sync_batch_norm`); None: this process's batch alone
    group = None
    #: True inside `frozen_running_stats`: the running statistics stay
    frozen = False

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        if self.group is not None:
            return self._forward_synced(xf).to(x.dtype)
        # momentum 1 leaves exactly this batch's mean and unbiased variance
        # in the scratch buffers
        mean = torch.zeros_like(self.running_mean)
        var_unbiased = torch.ones_like(self.running_var)
        y = F.batch_norm(xf, mean, var_unbiased, self.weight, self.bias,
                         True, 1.0, self.eps)
        n = xf.numel() // xf.shape[1]
        with torch.no_grad():
            self.update_running(mean, var_unbiased * ((n - 1) / n))
        return y.to(x.dtype)

    def _forward_synced(self, xf: torch.Tensor) -> torch.Tensor:
        mean, var = batch_stats(xf, self.group)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = ((xf - mean[None, :, None, None]) * scale[None, :, None, None]
             + self.bias[None, :, None, None])
        with torch.no_grad():
            self.update_running(mean, var)
        return y

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold a batch's mean and biased variance into the running
        statistics (flax's EMA), unless they are frozen."""
        if self.frozen:
            return
        m = self.momentum
        if m is None:  # cumulative average, as in torch's BatchNorm2d
            m = 1.0 / float(self.num_batches_tracked + 1)
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        self.num_batches_tracked.add_(1)


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, group):
    """Within the block, every `BatchNorm2d` of `model` in train mode takes
    its statistics over the ranks of `group` (the counterpart of
    `syncbn_axis`); `group` None changes nothing (an enclosing block's
    group stays)."""
    if group is None:
        yield model
        return
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.group = group
    try:
        yield model
    finally:
        for m in bns:
            m.group = None


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block no `BatchNorm2d` of `module` updates its running
    statistics; they normalise as before."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.frozen = True
    try:
        yield module
    finally:
        for m in bns:
            m.frozen = False
