"""Cardiac-like phantom slices made in bulk from the seed (the geometry
and intensities of the port's `data/phantom.py::make_phantom`, drawn
for every slice at once on the device instead of one slice at a time).

An elliptical left-ventricle disc inside a myocardium ring and a right-
ventricle blob beside it, class intensities plus Gaussian noise, each
slice z-scored; labels as ACDC's (0 background, 1 RV, 2 myocardium, 3 LV).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def make(n: int, hw: int, seed: int, device) -> tuple:
    """(images (n, hw, hw) float32, labels (n, hw, hw) int32), numpy on the
    host, from `seed` (the same seed gives the same slices)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((n, 8), generator=gen, device=device)
    noise = torch.randn((n, hw, hw), generator=gen, device=device)

    def span(col, lo, hi):
        return (lo + (hi - lo) * u[:, col])[:, None, None]

    grid = torch.arange(hw, dtype=torch.float32, device=device)
    yy, xx = grid[None, :, None], grid[None, None, :]
    cy = hw / 2 + span(0, -hw / 8, hw / 8)
    cx = hw / 2 + span(1, -hw / 8, hw / 8)
    r_lv = hw * span(2, 0.10, 0.16)
    r_myo = r_lv + hw * span(3, 0.05, 0.09)
    ecc = span(4, 0.8, 1.25)
    d = torch.sqrt(((yy - cy) * ecc) ** 2 + (xx - cx) ** 2)
    lv = d < r_lv
    myo = (d >= r_lv) & (d < r_myo)
    ang = span(5, 0.0, 2 * math.pi)
    rv_cy = cy + torch.sin(ang) * r_myo * 1.6
    rv_cx = cx + torch.cos(ang) * r_myo * 1.6
    r_rv = hw * span(6, 0.08, 0.13)
    d_rv = torch.sqrt((yy - rv_cy) ** 2 + ((xx - rv_cx) * 1.2) ** 2)
    rv = (d_rv < r_rv) & ~lv & ~myo

    label = torch.zeros((n, hw, hw), dtype=torch.int32, device=device)
    label[rv], label[myo], label[lv] = 1, 2, 3
    level = torch.tensor([0.2, 0.75, 0.45, 0.95], device=device)
    img = level[label.long()] + noise * 0.08
    mu = img.mean(dim=(1, 2), keepdim=True)
    sd = img.std(dim=(1, 2), keepdim=True, correction=0)
    img = (img - mu) / (sd + 1e-6)
    return (np.ascontiguousarray(img.cpu().numpy(), dtype=np.float32),
            np.ascontiguousarray(label.cpu().numpy(), dtype=np.int32))
