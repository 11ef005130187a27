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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.config import BN_EPS, BN_MOMENTUM


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        # momentum 1 leaves exactly this batch's mean and unbiased variance
        # in the scratch buffers
        mean = torch.zeros_like(self.running_mean)
        var_unbiased = torch.ones_like(self.running_var)
        y = F.batch_norm(xf, mean, var_unbiased, self.weight, self.bias,
                         True, 1.0, self.eps)
        n = xf.numel() // xf.shape[1]
        with torch.no_grad():
            var = var_unbiased * ((n - 1) / n)
            m = self.momentum
            if m is None:  # cumulative average, as in torch's BatchNorm2d
                m = 1.0 / float(self.num_batches_tracked + 1)
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)
