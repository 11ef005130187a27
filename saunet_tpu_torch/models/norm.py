"""BatchNorm with flax's dtype semantics (counterpart of
saunet_tpu/models/norm.py).

flax's `nn.BatchNorm(dtype=bf16)` keeps f32 parameters and statistics,
normalises in f32 and returns the compute dtype. `BatchNorm2d` does the
same: it runs in f32 whatever the input type and casts back to it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.config import BN_EPS, BN_MOMENTUM


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)
