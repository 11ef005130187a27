"""Training augmentation on the device, and the eval normalisation
(counterpart of saunet_tpu/data/augment.py).

`make_augment_fn(...)` returns `augment(gen, batch)`: per sample a flip H
(p 0.5), a flip V (p 0.5), a rotation U(-pi, pi), an elastic field (p 0.5,
alpha 500, sigma 20) composed into ONE map of source coordinates; then one
warp of the image (bilinear) and the label (nearest) with zero fill, through
the warp kernel (ops/cuda/warp.py; its plain version on the CPU); then gamma
in (0.5, 2) with the reference's branch rule, the per-sample z-score and the
triplicated channels; and the edge ground truth of the warped label.

The random draws come from the `torch.Generator` passed in (on the CPU or
on the batch's device). `coords_from_draws` is the pure map from the draws
to the coordinates, so a test can feed it the JAX package's draws: the two
frameworks' generators give different numbers from one seed.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.warp import resample, warp_image_label

ELASTIC_ALPHA = 500.0
ELASTIC_SIGMA = 20.0
GAMMA_RANGE = (0.5, 2.0)
ELASTIC_STRIDE = 4


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _gaussian_filter2d(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable zero-padded gaussian blur of (N, H, W)."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma)).to(field.device)
    r = (k.shape[0] - 1) // 2
    x = F.conv2d(field[:, None], k.view(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


@functools.lru_cache(maxsize=None)
def _disk_kernel() -> np.ndarray:
    """5x5 Euclidean disk of radius 2 (13 taps)."""
    yy, xx = np.mgrid[-2:3, -2:3]
    return (yy * yy + xx * xx <= 4).astype(np.float32)


def edge_ground_truth(labels: torch.Tensor,
                      num_classes: int = 4) -> torch.Tensor:
    """(N, H, W) int labels -> (N, H, W, 1) {0, 1} f32 edge map: a pixel is
    an edge pixel iff, for some foreground class, the radius-2 disk around
    it holds both that class and another (zero padding at the border)."""
    disk = torch.from_numpy(_disk_kernel()).to(labels.device)
    taps = float(_disk_kernel().sum())
    fg = F.one_hot(labels.long(), num_classes)[..., 1:].permute(0, 3, 1, 2)
    c = fg.shape[1]
    s = F.conv2d(fg.float(), disk.expand(c, 1, 5, 5), padding=2, groups=c)
    edge = ((s > 0.5) & ~(s > taps - 0.5)).any(dim=1, keepdim=True)
    return edge.permute(0, 2, 3, 1).float()


def coords_from_draws(flip_h, flip_v, angle, do_el, field_x, field_y,
                      u_gamma, use_low, h: int, w: int):
    """Per-sample source coordinates and gamma from the random draws.

    flip_h, flip_v, use_low: (N,) bool; angle (N,) f32 in [-pi, pi);
    do_el (N,) {0, 1} f32; field_x, field_y: (N, ceil(h/4), ceil(w/4))
    uniform [0, 1) draws of the elastic field, or None for no elastic
    deformation; u_gamma (N,) uniform [0, 1).

    The field is mapped to [-1, 1), blurred with sigma 20/4 on the stride-4
    grid, upsampled bilinearly (half-pixel centres, edge-clamped: what
    `jax.image.resize(..., "linear")` does when it upsamples) and scaled by
    alpha * do_el / 4. The inverse map is src = F(R(p + d(p))) about the
    image centre. Returns sy, sx (N, h, w) f32 and gamma (N,) f32."""
    n = angle.shape[0]
    dev = angle.device
    if field_x is not None:
        amp = (ELASTIC_ALPHA * do_el.float() / ELASTIC_STRIDE)[:, None, None]
        sigma = ELASTIC_SIGMA / ELASTIC_STRIDE

        def displacement(field):
            smooth = _gaussian_filter2d(field.float() * 2.0 - 1.0, sigma)
            up = F.interpolate(smooth[:, None], size=(h, w), mode="bilinear",
                               align_corners=False)[:, 0]
            return up * amp

        dx, dy = displacement(field_x), displacement(field_y)
    else:
        dx = dy = torch.zeros((n, h, w), device=dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    py = yy + dy - cy
    px = xx + dx - cx
    ca = torch.cos(angle.float())[:, None, None]
    sa = torch.sin(angle.float())[:, None, None]
    ry = ca * py - sa * px
    rx = sa * py + ca * px
    ry = torch.where(flip_v[:, None, None], -ry, ry)
    rx = torch.where(flip_h[:, None, None], -rx, rx)
    u = u_gamma.float()
    lo, hi = GAMMA_RANGE
    gamma = torch.where(use_low, u * (1.0 - lo) + lo, u * (hi - 1.0) + 1.0)
    return ry + cy, rx + cx, gamma


def draw(gen: torch.Generator, n: int, h: int, w: int, enable_deform: bool,
         device) -> dict:
    """The random draws of `coords_from_draws` for n samples, from `gen`
    (made on its own device, then moved to `device`)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    hl = -(-h // ELASTIC_STRIDE)
    wl = -(-w // ELASTIC_STRIDE)
    d = {"flip_h": rand(n) < 0.5, "flip_v": rand(n) < 0.5,
         "angle": rand(n) * (2 * math.pi) - math.pi,
         "do_el": (rand(n) < 0.5).float(),
         "field_x": rand(n, hl, wl) if enable_deform else None,
         "field_y": rand(n, hl, wl) if enable_deform else None,
         "use_low": rand(n) < 0.5, "u_gamma": rand(n)}
    return {k: None if v is None else v.to(device) for k, v in d.items()}


def augment_with_coords(imgs: torch.Tensor, labels: torch.Tensor,
                        sy: torch.Tensor, sx: torch.Tensor,
                        gamma: torch.Tensor,
                        num_classes: int = 4) -> Dict[str, torch.Tensor]:
    """Everything after the draws: warp, gamma, z-score, channels, edge."""
    if num_classes <= 4:
        img_w, lab_a = warp_image_label(imgs, labels, sy, sx)
    else:  # the JAX package's unpacked samplers (its packed warp holds
        # 2-bit labels): f32 taps, labels rounded half to even
        img_w, lab_a = resample(imgs.float(), labels.int(), sy, sx)

    mn = img_w.amin(dim=(1, 2), keepdim=True)
    rng = img_w.amax(dim=(1, 2), keepdim=True) - mn
    img_g = torch.pow((img_w - mn) / (rng + 1e-7),
                      gamma[:, None, None]) * rng + mn

    mu = img_g.mean(dim=(1, 2), keepdim=True)
    sd = img_g.std(dim=(1, 2), keepdim=True, correction=0)
    img_a = (img_g - mu) / (sd + 1e-10)
    return {"image": img_a[..., None].expand(*img_a.shape, 3).contiguous(),
            "label": lab_a,
            "edge": edge_ground_truth(lab_a, num_classes)}


def make_augment_fn(num_classes: int = 4, enable_deform: bool = True):
    """(gen, {image (N, H, W[, 1]), label (N, H, W)}[, shard, rows]) ->
    {image (N, H, W, 3) f32, label (N, H, W) int32, edge (N, H, W, 1) f32},
    on the batch's device.

    shard (index, count): the batch is block `index` of `count` equal
    blocks of a global batch (a rank's samples in the data-parallel step).
    The draws are made for the whole global batch, as one process would
    make them, and this block's rows of them are used: every rank's
    generator is in the same state, so the ranks together augment the
    global batch exactly as one process does.

    rows (lo, hi): keep only these image rows of the output (a rank's rows
    on the 'space' axis). The warp reads the whole source image, and the
    gamma, the z-score and the edge ground truth read the whole warped
    image, so every rank of a 'space' group augments its samples whole
    and keeps its rows: exactly the one-process rows."""

    def augment(gen: Optional[torch.Generator],
                batch: Dict[str, torch.Tensor],
                shard: Optional[Tuple[int, int]] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
        if gen is None:
            raise ValueError("augment needs a torch.Generator")
        imgs, labels = batch["image"], batch["label"]
        if imgs.dim() == 4:
            imgs = imgs[..., 0]
        n, h, w = imgs.shape
        index, count = shard or (0, 1)
        d = draw(gen, n * count, h, w, enable_deform, imgs.device)
        if count > 1:
            samples = slice(index * n, (index + 1) * n)
            d = {k: None if v is None else v[samples] for k, v in d.items()}
        sy, sx, gamma = coords_from_draws(h=h, w=w, **d)
        out = augment_with_coords(imgs.float(), labels.to(torch.int32),
                                  sy, sx, gamma, num_classes)
        if rows is not None:
            out = {k: v[:, rows[0]:rows[1]].contiguous()
                   for k, v in out.items()}
        return out

    return augment


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
