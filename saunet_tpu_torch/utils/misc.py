"""Small conversion and visualisation helpers (counterpart of
saunet_tpu/utils/misc.py)."""
from __future__ import annotations

import numpy as np
import torch


def as_numpy(obj):
    """Recursively convert tensors (on any device) and nested dicts, lists
    and tuples of them to numpy."""
    if isinstance(obj, dict):
        return {k: as_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(as_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


# Default 4-class palette: background, RV, myocardium, LV.
DEFAULT_COLORS = np.array(
    [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], dtype=np.uint8)


def color_encode(label_map, colors: np.ndarray = DEFAULT_COLORS
                 ) -> np.ndarray:
    """An int label image (H, W) -> RGB uint8 (H, W, 3); labels outside
    the palette stay black."""
    label_map = as_numpy(label_map).astype(np.int64)
    out = np.zeros(label_map.shape + (3,), dtype=np.uint8)
    for idx in np.unique(label_map):
        if 0 <= idx < len(colors):
            out[label_map == idx] = colors[idx]
    return out
