"""Canny-style edge operator and grayscale rescale, plain PyTorch.

Counterpart of saunet_tpu/ops/edge.py. `canny_edges` is the plain version of
the Canny kernel (csrc/canny.cu, wrapped by ops/cuda/canny.py): it is written
as saunet_tpu/ops/pallas/canny.py::_canny_math's shifted adds, in the same
order of operations, so that the kernel can match it bit for bit.

    Sobel 3x3 (zero boundary) -> L1 magnitude -> direction-quantised
    non-maximum suppression -> double threshold -> `hysteresis_iters`
    rounds of 8-neighbour dilation clipped to the weak pixels -> x255.

Layouts are the JAX package's: gray is NHW1 (or NHW), images NHWC.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

TAN225 = 0.4142135623730951
TAN675 = 2.414213562373095


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(N, H, W) shifted by (dy, dx) with zero fill: out[y, x] =
    x[y - dy, x - dx]."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def canny_edges(gray: torch.Tensor, low: float = 10.0, high: float = 100.0,
                hysteresis_iters: int = 8) -> torch.Tensor:
    """NHW1 (or NHW) grayscale in [0, 255] -> {0, 255} NHW1 f32."""
    g = (gray[..., 0] if gray.dim() == 4 else gray).float()
    n = _shift(g, 1, 0)      # g[y-1, x]
    s = _shift(g, -1, 0)     # g[y+1, x]
    e = _shift(g, 0, -1)     # g[y, x+1]
    w_ = _shift(g, 0, 1)     # g[y, x-1]
    ne = _shift(g, 1, -1)
    nw = _shift(g, 1, 1)
    se = _shift(g, -1, -1)
    sw = _shift(g, -1, 1)

    gx = (ne + 2.0 * e + se) - (nw + 2.0 * w_ + sw)
    gy = (sw + 2.0 * s + se) - (nw + 2.0 * n + ne)
    mag = gx.abs() + gy.abs()

    ax, ay = gx.abs(), gy.abs()
    horiz = ay <= TAN225 * ax
    vert = ay >= TAN675 * ax
    same_sign = (gx * gy) >= 0

    keep_h = (mag >= _shift(mag, 0, 1)) & (mag >= _shift(mag, 0, -1))
    keep_v = (mag >= _shift(mag, 1, 0)) & (mag >= _shift(mag, -1, 0))
    keep_d1 = (mag >= _shift(mag, 1, 1)) & (mag >= _shift(mag, -1, -1))
    keep_d2 = (mag >= _shift(mag, 1, -1)) & (mag >= _shift(mag, -1, 1))
    keep = torch.where(horiz, keep_h,
                       torch.where(vert, keep_v,
                                   torch.where(same_sign, keep_d1, keep_d2)))
    nms = mag * keep.float()

    strong = (nms > high).float()
    weak = (nms > low).float()
    for _ in range(hysteresis_iters):
        grown = F.max_pool2d(strong[:, None], 3, stride=1, padding=1)[:, 0]
        strong = torch.maximum(strong, grown * weak)
    return (strong * 255.0)[..., None]


def image_to_gray255(x: torch.Tensor, group=None) -> torch.Tensor:
    """NHWC image -> NHW1 grayscale rescaled to [0, 255] per sample. With
    `group` (the 'space' ranks holding rows of the same images) each
    sample's minimum and maximum are taken over every rank's rows (one
    all-reduce; not differentiable: the gray feeds Canny alone)."""
    xf = x.float()
    g = xf.sum(dim=-1, keepdim=True) / xf.shape[-1]
    lo = g.amin(dim=(1, 2, 3), keepdim=True)
    hi = g.amax(dim=(1, 2, 3), keepdim=True)
    if group is not None:
        ext = torch.stack([hi, -lo]).detach()
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
        hi, lo = ext[0], -ext[1]
    return (g - lo) / (hi - lo + 1e-8) * 255.0
