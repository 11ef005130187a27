"""Selectable global pooling over H and W of an NHWC tensor (counterpart
of saunet_tpu/ops/pooling.py): 'avg', 'max', 'avgmax' (the mean of both)
and 'catavgmax' (both, concatenated on channels)."""
from __future__ import annotations

import torch


def adaptive_pool2d(x: torch.Tensor, pool_type: str = "avg",
                    keepdims: bool = True) -> torch.Tensor:
    """Global pooling over H, W of an NHWC tensor."""
    def mean():
        return x.mean(dim=(1, 2), keepdim=keepdims)

    def amax():
        return x.amax(dim=(1, 2), keepdim=keepdims)

    if pool_type == "avg":
        return mean()
    if pool_type == "max":
        return amax()
    if pool_type == "avgmax":
        return 0.5 * (mean() + amax())
    if pool_type == "catavgmax":
        return torch.cat([mean(), amax()], dim=-1)
    raise ValueError(f"Invalid pool type: {pool_type}")


def pooling_factor(pool_type: str = "avg") -> int:
    """Channel multiplier of the pooling output (catavgmax doubles)."""
    return 2 if pool_type == "catavgmax" else 1
