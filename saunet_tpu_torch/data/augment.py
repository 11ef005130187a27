"""Eval-time normalisation (counterpart of
saunet_tpu/data/augment.py::normalize_for_eval). The on-device training
augmentation is not ported yet."""
from __future__ import annotations

import torch


def normalize_for_eval(imgs: torch.Tensor) -> torch.Tensor:
    """(N, H, W) or (N, H, W, 1) slices -> (N, H, W, 3): per-slice z-score
    with the biased std and +1e-10, triplicated to 3 channels."""
    if imgs.dim() == 4:
        imgs = imgs[..., 0]
    imgs = imgs.float()
    mu = imgs.mean(dim=(1, 2), keepdim=True)
    sd = imgs.std(dim=(1, 2), keepdim=True, correction=0)
    out = (imgs - mu) / (sd + 1e-10)
    return out[..., None].expand(*out.shape, 3).contiguous()
