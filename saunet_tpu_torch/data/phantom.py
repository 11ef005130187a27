"""Synthetic cardiac-like blob phantoms with known masks (counterpart of
saunet_tpu/data/phantom.py; numpy only, the same RandomState call order, so
the same seed gives the same slices bit for bit).

An elliptical "LV" disc inside a "myocardium" ring, plus a crescent-ish
"RV" blob, with class-correlated intensities and additive noise, labelled
as ACDC is (0 background, 1 RV, 2 myocardium, 3 LV).
"""
from __future__ import annotations

import numpy as np


def make_phantom(rs: np.random.RandomState, hw: int = 64):
    """One (image, label) pair: image float32 (hw, hw) z-scored,
    label int32 (hw, hw) in {0..3}."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    cy = hw / 2 + rs.uniform(-hw / 8, hw / 8)
    cx = hw / 2 + rs.uniform(-hw / 8, hw / 8)
    # LV disc + myocardium ring
    r_lv = hw * rs.uniform(0.10, 0.16)
    r_myo = r_lv + hw * rs.uniform(0.05, 0.09)
    ecc = rs.uniform(0.8, 1.25)
    d = np.sqrt(((yy - cy) * ecc) ** 2 + (xx - cx) ** 2)
    lv = d < r_lv
    myo = (d >= r_lv) & (d < r_myo)
    # RV: blob offset to the side of the ring, clipped to not overlap
    ang = rs.uniform(0, 2 * np.pi)
    rv_cy = cy + np.sin(ang) * r_myo * 1.6
    rv_cx = cx + np.cos(ang) * r_myo * 1.6
    r_rv = hw * rs.uniform(0.08, 0.13)
    d_rv = np.sqrt((yy - rv_cy) ** 2 + ((xx - rv_cx) * 1.2) ** 2)
    rv = (d_rv < r_rv) & ~lv & ~myo

    label = np.zeros((hw, hw), np.int32)
    label[rv] = 1
    label[myo] = 2
    label[lv] = 3

    img = np.full((hw, hw), 0.2, np.float32)
    img[rv] = 0.75
    img[myo] = 0.45
    img[lv] = 0.95
    img += rs.randn(hw, hw).astype(np.float32) * 0.08
    img = (img - img.mean()) / (img.std() + 1e-6)
    return img, label


def make_phantom_set(n: int, hw: int = 64, seed: int = 0):
    """(images (n,hw,hw) f32, labels (n,hw,hw) i32), deterministic in
    seed."""
    rs = np.random.RandomState(seed)
    imgs = np.empty((n, hw, hw), np.float32)
    labs = np.empty((n, hw, hw), np.int32)
    for i in range(n):
        imgs[i], labs[i] = make_phantom(rs, hw)
    return imgs, labs
