"""Bilinear resize with align_corners=True (counterpart of
saunet_tpu/ops/resize.py, which builds the same operator from
interpolation matrices and bit-matches this one in f32), and the
nearest-neighbour resize of label maps.

On the 'space' axis (`space`, a parallel.mesh.SpaceShard) the source row
of output row i is i * (h - 1) / (H - 1) in global rows, which does not
line up with the shards: each rank fetches the source rows its output rows
read and interpolates them by their global coordinates.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _source_rows(h: int, ho: int, lo: int, hi: int):
    """For output rows [lo, hi) of ho, resized from h rows: the f32 source
    coordinates (torch's align_corners arithmetic: a float32 scale times
    the row index), the rows below and above each, and the weight of the
    row above."""
    scale = np.float32(h - 1) / np.float32(ho - 1) if ho > 1 else 0.0
    src = torch.tensor(scale, dtype=torch.float32) * torch.arange(
        lo, hi, dtype=torch.float32)
    i0 = src.long()
    i1 = torch.clamp(i0 + 1, max=h - 1)
    return i0, i1, (src - i0).clamp(0.0, 1.0)


def resize_bilinear(x: torch.Tensor, out_hw, space=None) -> torch.Tensor:
    """Resize NCHW `x` to spatial size `out_hw` (global rows on the
    'space' axis)."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if space is None:
        if tuple(x.shape[-2:]) == out_hw:
            return x
        return F.interpolate(x, size=out_hw, mode="bilinear",
                             align_corners=True)
    h, ho = space.level(x.shape[2]), out_hw[0]
    if (h, x.shape[3]) == out_hw:
        return x

    def need(lo, hi):
        i0, i1, _ = _source_rows(h, ho, lo, hi)
        return int(i0[0]), int(i1[-1]) + 1

    lo, hi = space.rows(ho)
    a = need(lo, hi)[0]
    window = space.fetch(x, h, ho, need).float()
    if window.shape[3] != out_hw[1]:
        # along W alone: H is resized by its own size, an exact copy
        window = F.interpolate(window, size=(window.shape[2], out_hw[1]),
                               mode="bilinear", align_corners=True)
    i0, i1, w1 = _source_rows(h, ho, lo, hi)
    w1 = w1.to(x.device)[:, None]
    out = (window.index_select(2, (i0 - a).to(x.device)) * (1.0 - w1)
           + window.index_select(2, (i1 - a).to(x.device)) * w1)
    return out.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of a label map, NHWC, HWC or HW (the JAX
    package's layouts): output row i takes source row min(i * h // H,
    h - 1), and columns likewise."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    ndim = x.dim()
    if ndim == 2:
        x = x[None, :, :, None]
    elif ndim == 3:
        x = x[None]
    h, w = x.shape[1:3]
    rows = torch.clamp(torch.arange(out_h, device=x.device) * h // out_h,
                       max=h - 1)
    cols = torch.clamp(torch.arange(out_w, device=x.device) * w // out_w,
                       max=w - 1)
    out = x[:, rows][:, :, cols]
    return out[0, ..., 0] if ndim == 2 else out[0] if ndim == 3 else out
