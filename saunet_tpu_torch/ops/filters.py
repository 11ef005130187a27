"""Small image filters, NHWC (counterpart of saunet_tpu/ops/filters.py).

The reference stubs most of these; the JAX package implements them, and so
does the port: a 'SAME' conv, central differences, the triangle blur
(convTri) and the blurred gradient's magnitude and unit normal. Layouts are
the JAX package's: NHWC images, HWIO kernels. Nothing in the model or the
steps uses them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor,
                feature_group_count: int = 1) -> torch.Tensor:
    """Stride-1 'SAME' conv (zero padding, the extra row or column after);
    x NHWC, kernel HWIO."""
    kh, kw = kernel.shape[:2]
    xp = F.pad(x.permute(0, 3, 1, 2),
               ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    y = F.conv2d(xp, kernel.permute(3, 2, 0, 1).to(x.dtype),
                 groups=feature_group_count)
    return y.permute(0, 2, 3, 1)


def _edge_pad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One replicated row (dim 1) or column (dim 2) on either side."""
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([first, x, last], dim=dim)


def gradient_central_diff(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d/dx, d/dy) central differences of NHWC x, edges replicated."""
    pw, ph = _edge_pad(x, 2), _edge_pad(x, 1)
    return (pw[:, :, 2:] - pw[:, :, :-2]) * 0.5, \
        (ph[:, 2:] - ph[:, :-2]) * 0.5


def triangle_kernel(r: int) -> np.ndarray:
    """1D triangle filter of radius r, normalised (Piotr Dollar's
    convTri)."""
    k = np.concatenate([np.arange(1, r + 2), np.arange(r, 0, -1)]
                       ).astype(np.float32)
    return k / k.sum()


def conv_tri(x: torch.Tensor, r: int) -> torch.Tensor:
    """Separable triangle blur of NHWC x (vertical, then horizontal;
    'SAME', zero padding)."""
    if r <= 0:
        return x
    k = torch.from_numpy(triangle_kernel(r)).to(x.device)
    c = x.shape[-1]
    kv = k.reshape(-1, 1, 1, 1).expand(-1, 1, 1, c)
    kh = k.reshape(1, -1, 1, 1).expand(1, -1, 1, c)
    return conv2d_same(conv2d_same(x, kv, c), kh, c)


def gradient_magnitude_and_normal(x: torch.Tensor, blur_radius: int = 4):
    """(magnitude, unit normal (..., 2) as (dx, dy) / magnitude) of the
    gradient of NHWC x after a triangle blur."""
    dx, dy = gradient_central_diff(conv_tri(x, blur_radius))
    mag = torch.sqrt(dx * dx + dy * dy + 1e-12)
    return mag, torch.stack([dx / mag, dy / mag], dim=-1)
