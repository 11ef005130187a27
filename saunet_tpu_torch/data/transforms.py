"""Paired (image, mask) transforms on the device (counterpart of
saunet_tpu/data/transforms.py, the reference's whole augmentation
inventory).

The JAX transforms are `(rng, img, mask) -> (img, mask)` on one (H, W) or
(H, W, C) image, vmapped over a batch. Here a transform takes the batch:
img (N, H, W) or (N, H, W, C) f32, mask (N, H, W) int, one independent draw
a sample. Each splits into `draw(gen, img, mask)`, the random draws of
every sample from a `torch.Generator` (a dict of (N,) tensors on the
image's device), and `apply(draws, img, mask)`, the pure map from the
draws, so that a test can feed it the JAX package's draws (the two
frameworks' generators give different numbers from one seed); calling it
does both. Output shapes are static, as in JAX.

The geometric transforms sample the inputs at a grid of source coordinates
through `resample` (ops/cuda/warp.py: the resample kernel on the card, its
plain version on the CPU): bilinear image, nearest mask rounded half to
even, zero fill, onto a grid of the output's own shape.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops.cuda.warp import resample

Pair = Tuple[torch.Tensor, torch.Tensor]
Draws = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=gen.device)
    return (u * (hi - lo) + lo).to(device)


def _randint(gen: torch.Generator, n: int, lo: int, hi: int,
             device) -> torch.Tensor:
    """Integers in [lo, hi] (both ends), int32."""
    return torch.randint(lo, hi + 1, (n,), generator=gen,
                         device=gen.device).to(device, torch.int32)


def _per_sample(v: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """(N,) f32 -> (N, 1, ...) of `ndim` axes, to broadcast over each
    sample of an (N, H, W) grid (or of an `ndim`-axis image)."""
    return v.float().reshape((-1,) + (1,) * (ndim - 1))


def _grid(n: int, h: int, w: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The (N, h, w) f32 row and column index grids."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(n, h, w), xx.expand(n, h, w)


def _resample(img: torch.Tensor, mask: torch.Tensor, sy: torch.Tensor,
              sx: torch.Tensor) -> Pair:
    n = mask.shape[0]
    ho, wo = sy.shape[-2:]
    sy = sy.expand(n, ho, wo).contiguous()
    sx = sx.expand(n, ho, wo).contiguous()
    return resample(img.float(), mask.to(torch.int32), sy, sx)


def _select(do: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per sample: a where `do`, else b."""
    return torch.where(do.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


class Transform:
    """A paired transform over a batch; subclasses define `draw` (nothing
    to draw by default) and `apply`."""

    def draw(self, gen: torch.Generator, img: torch.Tensor,
             mask: torch.Tensor) -> Draws:
        return {}

    def apply(self, d: Draws, img: torch.Tensor, mask: torch.Tensor) -> Pair:
        raise NotImplementedError

    def __call__(self, gen: torch.Generator, img: torch.Tensor,
                 mask: torch.Tensor) -> Pair:
        return self.apply(self.draw(gen, img, mask), img, mask)


class Compose(Transform):
    """Chain paired transforms, each drawing from the one generator in
    turn. `apply` takes the list of each transform's draws."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def apply(self, draws: List[Draws], img, mask) -> Pair:
        for t, d in zip(self.transforms, draws, strict=True):
            img, mask = t.apply(d, img, mask)
        return img, mask

    def __call__(self, gen, img, mask) -> Pair:
        for t in self.transforms:
            img, mask = t(gen, img, mask)
        return img, mask


class _Flip(Transform):
    def __init__(self, p: float, dim: int):
        self.p, self.dim = p, dim

    def draw(self, gen, img, mask) -> Draws:
        n = mask.shape[0]
        return {"do": torch.rand(n, generator=gen, device=gen.device)
                .to(mask.device) < self.p}

    def apply(self, d, img, mask) -> Pair:
        do = d["do"].to(img.device)
        return (_select(do, torch.flip(img, (self.dim,)), img),
                _select(do, torch.flip(mask, (self.dim,)), mask))


def random_horizontally_flip(p: float = 0.5) -> Transform:
    """Flip W with probability p; draws `do` (N,) bool."""
    return _Flip(p, 2)


def random_vertically_flip(p: float = 0.5) -> Transform:
    """Flip H with probability p; draws `do` (N,) bool."""
    return _Flip(p, 1)


class _Rotate(Transform):
    def __init__(self, degree: float):
        self.degree = degree

    def draw(self, gen, img, mask) -> Draws:
        return {"angle": _uniform(gen, mask.shape[0], -self.degree,
                                  self.degree, mask.device)}

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        a = _per_sample(d["angle"]) * math.pi / 180.0
        yy, xx = _grid(n, h, w, mask.device)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        py, px = yy - cy, xx - cx
        ca, sa = torch.cos(a), torch.sin(a)
        return _resample(img, mask, ca * py - sa * px + cy,
                         sa * py + ca * px + cx)


def random_rotate(degree: float) -> Transform:
    """Rotation about the image centre by U(-degree, degree) degrees
    (`angle`), bilinear image, nearest mask, zero fill."""
    return _Rotate(degree)


class _Translate(Transform):
    def __init__(self, offset: Tuple[int, int]):
        self.offset = offset

    def draw(self, gen, img, mask) -> Draws:
        n, (oy, ox) = mask.shape[0], self.offset
        return {"dy": _randint(gen, n, -oy, oy, mask.device),
                "dx": _randint(gen, n, -ox, ox, mask.device)}

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        yy, xx = _grid(n, h, w, mask.device)
        return _resample(img, mask, yy - _per_sample(d["dy"]),
                         xx - _per_sample(d["dx"]))


def random_translate(offset: Tuple[int, int]) -> Transform:
    """Shift by whole pixels, up to +-offset (`dy`, `dx`), zero fill."""
    return _Translate(offset)


class _Crop(Transform):
    """A (size, size) window at y0, x0: the centre, or drawn (`y0`, `x0`
    in [0, max(h - size, 0)]); zero fill where the input is smaller."""

    def __init__(self, size: int, random: bool):
        self.size, self.random = size, random

    def draw(self, gen, img, mask) -> Draws:
        if not self.random:
            return {}
        n, h, w = mask.shape
        return {"y0": _randint(gen, n, 0, max(h - self.size, 0),
                               mask.device),
                "x0": _randint(gen, n, 0, max(w - self.size, 0),
                               mask.device)}

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        yy, xx = _grid(n, self.size, self.size, mask.device)
        if self.random:
            return _resample(img, mask, yy + _per_sample(d["y0"]),
                             xx + _per_sample(d["x0"]))
        return _resample(img, mask, yy + (h - self.size) // 2,
                         xx + (w - self.size) // 2)


def center_crop(size: int) -> Transform:
    return _Crop(size, random=False)


def random_crop(size: int) -> Transform:
    """Random (size, size) crop; zero padding where the input is
    smaller."""
    return _Crop(size, random=True)


class _FreeScale(Transform):
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        oh, ow = self.size
        yy, xx = _grid(n, oh, ow, mask.device)
        return _resample(img, mask, yy * (h - 1) / max(oh - 1, 1),
                         xx * (w - 1) / max(ow - 1, 1))


def free_scale(size: Tuple[int, int]) -> Transform:
    """Resize to a fixed (h, w), aspect-free."""
    return _FreeScale(size)


class _ScaleShorterSide(Transform):
    def __init__(self, size: int, out_hw: Tuple[int, int]):
        self.size, self.out_hw = size, out_hw

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        # f32 division, as the JAX transform's
        factor = (torch.tensor(float(self.size), dtype=torch.float32)
                  / torch.tensor(float(min(h, w)), dtype=torch.float32)
                  ).to(mask.device)
        yy, xx = _grid(n, *self.out_hw, mask.device)
        return _resample(img, mask, yy / factor, xx / factor)


def scale_shorter_side(size: int, out_hw: Tuple[int, int]) -> Transform:
    """Scale so that the shorter side is `size`, onto a static `out_hw`
    (padded or cropped)."""
    return _ScaleShorterSide(size, out_hw)


class _RandomSizedCrop(Transform):
    def __init__(self, size: int, scale, ratio):
        self.size, self.scale, self.ratio = size, scale, ratio

    def draw(self, gen, img, mask) -> Draws:
        n, dev = mask.shape[0], mask.device
        return {"area": _uniform(gen, n, *self.scale, dev),
                "aspect": _uniform(gen, n, *self.ratio, dev),
                "uy": _uniform(gen, n, 0.0, 1.0, dev),
                "ux": _uniform(gen, n, 0.0, 1.0, dev)}

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        area = (h * w) * _per_sample(d["area"])
        aspect = _per_sample(d["aspect"])
        ch = torch.clamp(torch.sqrt(area * aspect), 8.0, h)
        cw = torch.clamp(torch.sqrt(area / aspect), 8.0, w)
        y0 = _per_sample(d["uy"]) * (h - ch)
        x0 = _per_sample(d["ux"]) * (w - cw)
        yy, xx = _grid(n, self.size, self.size, mask.device)
        return _resample(img, mask, y0 + yy * (ch - 1) / (self.size - 1),
                         x0 + xx * (cw - 1) / (self.size - 1))


def random_sized_crop(size: int, scale=(0.45, 1.0), ratio=(0.5, 2.0)
                      ) -> Transform:
    """A crop of U(scale) of the area and U(ratio) aspect (`area`,
    `aspect`), placed by `uy`, `ux` in [0, 1), resized to (size, size)."""
    return _RandomSizedCrop(size, scale, ratio)


class _RandomSized(Transform):
    def __init__(self, size: int, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.crop = random_crop(size)

    def draw(self, gen, img, mask) -> Draws:
        d = {"factor": _uniform(gen, mask.shape[0], self.lo, self.hi,
                                mask.device)}
        d.update(self.crop.draw(gen, img, mask))  # the shape is kept
        return d

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        yy, xx = _grid(n, h, w, mask.device)
        factor = _per_sample(d["factor"])
        img2, mask2 = _resample(img, mask, yy / factor, xx / factor)
        return self.crop.apply(d, img2, mask2)


def random_sized(size: int, lo: float = 0.5, hi: float = 2.0) -> Transform:
    """Isotropic rescale by U(lo, hi) (`factor`) about the origin, then a
    random (size, size) crop (`y0`, `x0`)."""
    return _RandomSized(size, lo, hi)


class _RandomErasing(Transform):
    def __init__(self, p, sl, sh, r1, fill):
        self.p, self.sl, self.sh, self.r1, self.fill = p, sl, sh, r1, fill

    def draw(self, gen, img, mask) -> Draws:
        n, dev = mask.shape[0], mask.device
        return {"do": torch.rand(n, generator=gen, device=gen.device)
                .to(dev) < self.p,
                "area": _uniform(gen, n, self.sl, self.sh, dev),
                "ratio": _uniform(gen, n, self.r1, 1.0 / self.r1, dev),
                "uy": _uniform(gen, n, 0.0, 1.0, dev),
                "ux": _uniform(gen, n, 0.0, 1.0, dev)}

    def apply(self, d, img, mask) -> Pair:
        n, h, w = mask.shape
        area = (h * w) * _per_sample(d["area"])
        ratio = _per_sample(d["ratio"])
        eh = torch.clamp(torch.sqrt(area * ratio), 1, h - 1)
        ew = torch.clamp(torch.sqrt(area / ratio), 1, w - 1)
        y0 = _per_sample(d["uy"]) * (h - eh)
        x0 = _per_sample(d["ux"]) * (w - ew)
        yy, xx = _grid(n, h, w, mask.device)
        inside = ((yy >= y0) & (yy < y0 + eh) & (xx >= x0) & (xx < x0 + ew)
                  & d["do"].to(mask.device)[:, None, None])
        if img.dim() == 4:
            inside = inside[..., None]
        return torch.where(inside, torch.full_like(img, self.fill), img), mask


def random_erasing(p: float = 0.5, sl: float = 0.02, sh: float = 0.4,
                   r1: float = 0.3, fill: float = 0.0) -> Transform:
    """Erase one rectangle of the image (the mask is kept) with
    probability p (`do`): U(sl, sh) of the area (`area`), aspect
    U(r1, 1/r1) (`ratio`), clipped to the image, placed by `uy`, `ux`."""
    return _RandomErasing(p, sl, sh, r1, fill)


class _Colour(Transform):
    """A colour adjustment drawing one U(lo, hi) value a sample (`f`);
    `rgb_only`: the identity, drawing nothing, unless img is
    (N, H, W, 3)."""

    def __init__(self, lo: float, hi: float, fn, rgb_only: bool = False):
        self.lo, self.hi, self.fn, self.rgb_only = lo, hi, fn, rgb_only

    def _identity(self, img) -> bool:
        return self.rgb_only and not (img.dim() == 4 and img.shape[-1] == 3)

    def draw(self, gen, img, mask) -> Draws:
        if self._identity(img):
            return {}
        return {"f": _uniform(gen, mask.shape[0], self.lo, self.hi,
                              img.device)}

    def apply(self, d, img, mask) -> Pair:
        if self._identity(img):
            return img, mask
        return self.fn(img, _per_sample(d["f"], img.dim())), mask


def _gamma(img, gamma):
    dims = tuple(range(1, img.dim()))
    mn = img.amin(dim=dims, keepdim=True)
    rg = img.amax(dim=dims, keepdim=True) - mn
    return torch.pow((img - mn) / (rg + 1e-7), gamma) * rg + mn


def _contrast(img, f):
    mean = img.mean(dim=tuple(range(1, img.dim())), keepdim=True)
    return (img - mean) * f + mean


def _saturation(img, f):
    gray = img.mean(dim=-1, keepdim=True)
    return gray + (img - gray) * f


def _hue(img, u):
    theta = u.reshape(-1) * 2 * math.pi
    c, s = torch.cos(theta), torch.sin(theta)
    m = torch.stack([
        torch.stack([0.299 + 0.701 * c + 0.168 * s,
                     0.587 - 0.587 * c + 0.330 * s,
                     0.114 - 0.114 * c - 0.497 * s], -1),
        torch.stack([0.299 - 0.299 * c - 0.328 * s,
                     0.587 + 0.413 * c + 0.035 * s,
                     0.114 - 0.114 * c + 0.292 * s], -1),
        torch.stack([0.299 - 0.300 * c + 1.250 * s,
                     0.587 - 0.588 * c - 1.050 * s,
                     0.114 + 0.886 * c - 0.203 * s], -1)], 1)
    return torch.einsum("nhwc,ndc->nhwd", img, m)


def adjust_gamma(gamma_delta: float) -> Transform:
    """gamma U(1, 1 + delta) on each image normalised to [0, 1] by its
    min and range."""
    return _Colour(1.0, 1.0 + gamma_delta, _gamma)


def adjust_brightness(bf: float) -> Transform:
    return _Colour(1.0 - bf / 255.0, 1.0 + bf / 255.0, lambda x, f: x * f)


def adjust_contrast(cf: float) -> Transform:
    return _Colour(1.0 - cf, 1.0 + cf, _contrast)


def adjust_saturation(sf: float) -> Transform:
    """Blend with the channel mean (RGB images; identity otherwise)."""
    return _Colour(1.0 - sf, 1.0 + sf, _saturation, rgb_only=True)


def adjust_hue(hf: float) -> Transform:
    """Rotate the channels by theta = U(-hf, hf) * 2 pi (the YIQ
    approximation; RGB images, identity otherwise)."""
    return _Colour(-hf, hf, _hue, rgb_only=True)
