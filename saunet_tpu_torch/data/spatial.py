"""N-d spatial utilities for the host pipeline.

Capability parity with the reference's DKFZ-style utility modules
(the reference's data/u.py and the reference's data/
crop_and_pad_augmentations.py — the unused-by-drivers rows of SURVEY.md
§2.2): segmentation-safe resizing, n-d pad to shape, center/random n-d crop,
2D/3D rotation matrices, one-hot conversion, bounding boxes from masks.

These handle the ragged per-volume geometry on the host (numpy); fixed-shape
per-batch work belongs in data/augment.py and data/transforms.py on device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def one_hot(seg: np.ndarray, classes: Optional[Sequence[int]] = None
            ) -> np.ndarray:
    """(..., ) int mask -> (C, ...) float one-hot (u.py convert_seg... role)."""
    if classes is None:
        classes = np.unique(seg)
    out = np.zeros((len(classes),) + seg.shape, dtype=np.float32)
    for i, c in enumerate(classes):
        out[i] = seg == c
    return out


def resize_segmentation(seg: np.ndarray, new_shape: Tuple[int, ...],
                        order: int = 1) -> np.ndarray:
    """Resize an int segmentation without inventing labels
    (u.py:575-596): order 0 -> plain nearest; order>0 -> per-class one-hot
    linear interpolation thresholded at 0.5."""
    if order == 0:
        zoom = [n / o for n, o in zip(new_shape, seg.shape)]
        return ndimage.zoom(seg, zoom, order=0, mode="constant",
                            prefilter=False).astype(seg.dtype)
    classes = np.unique(seg)
    out = np.zeros(new_shape, dtype=seg.dtype)
    zoom = [n / o for n, o in zip(new_shape, seg.shape)]
    for c in classes:
        mask = (seg == c).astype(np.float32)
        up = ndimage.zoom(mask, zoom, order=order, mode="constant",
                          prefilter=False)
        out[up >= 0.5] = c
    return out


def pad_nd_image(image: np.ndarray,
                 new_shape: Optional[Sequence[int]] = None,
                 mode: str = "constant",
                 shape_must_be_divisible_by: Optional[Sequence[int]] = None,
                 return_slicer: bool = False, **kwargs):
    """Pad (centered) to `new_shape` and/or to divisibility
    (u.py:652-716 capability). Returns the padded array and optionally the
    slicer that undoes the pad."""
    old = np.asarray(image.shape)
    if new_shape is None:
        target = old.copy()
    else:
        target = old.copy()
        target[-len(new_shape):] = np.maximum(
            old[-len(new_shape):], np.asarray(new_shape))
    if shape_must_be_divisible_by is not None:
        div = np.ones_like(target)
        div[-len(shape_must_be_divisible_by):] = shape_must_be_divisible_by
        target = ((target + div - 1) // div) * div

    diff = target - old
    below = diff // 2
    above = diff - below
    pad_width = [(int(b), int(a)) for b, a in zip(below, above)]
    padded = np.pad(image, pad_width, mode=mode, **kwargs)
    if not return_slicer:
        return padded
    slicer = tuple(slice(int(b), int(b + o)) for b, o in zip(below, old))
    return padded, slicer


def center_crop_nd(data: np.ndarray, crop_size: Sequence[int]) -> np.ndarray:
    """Center crop the trailing dims (crop_and_pad_augmentations.py crop
    with 'center'); pads with zeros when smaller."""
    return _crop_nd(data, crop_size, mode="center")


def random_crop_nd(data: np.ndarray, crop_size: Sequence[int],
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    return _crop_nd(data, crop_size, mode="random",
                    rng=rng or np.random.RandomState())


def _crop_nd(data, crop_size, mode, rng=None):
    nd = len(crop_size)
    shape = data.shape
    lead = shape[:-nd]
    spatial = np.asarray(shape[-nd:])
    crop = np.asarray(crop_size)

    padded = pad_nd_image(data, new_shape=np.maximum(spatial, crop))
    spatial_p = np.asarray(padded.shape[-nd:])
    if mode == "center":
        start = (spatial_p - crop) // 2
    else:
        start = np.asarray([rng.randint(0, int(s - c) + 1)
                            for s, c in zip(spatial_p, crop)])
    slicer = tuple(slice(None) for _ in lead) + tuple(
        slice(int(s), int(s + c)) for s, c in zip(start, crop))
    return padded[slicer]


def rotation_matrix_2d(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


def rotation_matrix_3d(angle_x: float, angle_y: float, angle_z: float
                       ) -> np.ndarray:
    """Composed Rz @ Ry @ Rx (u.py rotation helpers)."""
    cx, sx = np.cos(angle_x), np.sin(angle_x)
    cy, sy = np.cos(angle_y), np.sin(angle_y)
    cz, sz = np.cos(angle_z), np.sin(angle_z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def bounding_box_from_mask(mask: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """Per-axis (lo, hi) extent of the nonzero region (u.py bbox role)."""
    nz = np.nonzero(mask)
    if len(nz[0]) == 0:
        return tuple((0, 0) for _ in range(mask.ndim))
    return tuple((int(a.min()), int(a.max()) + 1) for a in nz)
