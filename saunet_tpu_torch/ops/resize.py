"""Bilinear resize with align_corners=True (counterpart of
saunet_tpu/ops/resize.py, which builds the same operator from
interpolation matrices and bit-matches this one in f32)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize NCHW `x` to spatial size `out_hw`."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)
