"""Per-image gather and augmentation warp: csrc/warp.cu and its plain
versions.

Counterpart of tools/exp_gather.py::probe (the K5 gather kernels k_lane,
k_sub, k_flat) and of the warp they were probed for,
saunet_tpu/data/augment.py::_warp_image_label_packed. Each wrapper takes its
plain version for a tensor on the CPU, launches the kernel for a CUDA
tensor, or raises, and counts its launches.

`warp_image_label` computes the warp directly, four output pixels a
thread, instead of the TPU's packed single gather; the numerics are the
reference's (bf16 taps, f32 combine, zero fill; see csrc/warp.cu).

`resample` is the paired transforms' resample
(saunet_tpu/data/transforms.py::_resample): the same per-image gather onto
a coordinate grid of another shape, with the unpacked samplers' numerics
(f32 taps, the mask rounded half to even), whose plain versions are
`sample_bilinear_plain` and `sample_nearest_plain`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

GATHER_MODES = {"lane": 0, "sublane": 1, "flat": 2}


def gather_image_plain(img: torch.Tensor, idx: torch.Tensor,
                       mode: str) -> torch.Tensor:
    """`torch.gather` on the view that `mode` names; indices in range."""
    n, h, w = img.shape
    idx = idx.long()
    if mode == "lane":
        return torch.gather(img, 2, idx)
    if mode == "sublane":
        return torch.gather(img, 1, idx)
    if mode == "flat":
        return torch.gather(img.reshape(n, h * w), 1,
                            idx.reshape(n, h * w)).reshape(n, h, w)
    raise ValueError(f"gather mode must be one of {sorted(GATHER_MODES)}, "
                     f"got {mode!r}")


def _check_cuda(what: str, **tensors) -> Tuple[int, int, int]:
    shape = device = None
    for name, t in tensors.items():
        if not t.is_cuda or device not in (None, t.device):
            raise ValueError(f"{what}: no kernel for {name} on {t.device}")
        device = t.device
        if t.dim() != 3 or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be (N, H, W) like the "
                             f"others, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        shape = tuple(t.shape)
    return shape


def gather_image(img: torch.Tensor, idx: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """img (N, H, W) f32, idx (N, H, W) int32 -> (N, H, W) f32: per image,
    img[y, idx] (lane), img[idx, x] (sublane) or img.flat[idx] (flat)."""
    if mode not in GATHER_MODES:
        raise ValueError(f"gather mode must be one of "
                         f"{sorted(GATHER_MODES)}, got {mode!r}")
    if img.device.type == "cpu":
        return gather_image_plain(img, idx, mode)
    n, h, w = _check_cuda("gather kernel", img=img, idx=idx)
    if img.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"gather kernel: expected f32 image and int32 "
                         f"indices, got {img.dtype} and {idx.dtype}")
    lib = build.load("warp")
    out = torch.empty_like(img)
    if img.numel():
        with torch.cuda.device(img.device):
            build.check(lib.gather_image_forward(
                img.data_ptr(), idx.data_ptr(), out.data_ptr(), n, h, w,
                GATHER_MODES[mode], torch.cuda.current_stream().cuda_stream),
                "gather kernel")
        gather_image.launches += 1
    return out


gather_image.launches = 0


def warp_image_label_plain(img: torch.Tensor, label: torch.Tensor,
                           sy: torch.Tensor, sx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warp in torch ops, in the kernel's order of operations."""
    n, h, w = img.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    inside = (sy > -1) & (sy < h) & (sx > -1) & (sx < w)
    img_bf = img.to(torch.bfloat16).float().reshape(n, h * w)
    lab = label.to(torch.int32).reshape(n, h * w)
    yi, xi = y0.long(), x0.long()

    def taps(dy, dx):
        yy, xx = yi + dy, xi + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        o = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, -1)
        v = torch.gather(img_bf, 1, o).reshape(n, h, w)
        lv = torch.gather(lab, 1, o).reshape(n, h, w)
        return (torch.where(ok, v, torch.zeros_like(v)),
                torch.where(ok, lv, torch.zeros_like(lv)))

    (v00, l00), (v01, l01), (v10, l10), (v11, l11) = (
        taps(0, 0), taps(0, 1), taps(1, 0), taps(1, 1))
    img_w = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
             + fy * ((1 - fx) * v10 + fx * v11))
    img_w = torch.where(inside, img_w, torch.zeros_like(img_w))
    lower, upper = fy >= 0.5, fx >= 0.5
    lab_w = torch.where(lower, torch.where(upper, l11, l10),
                        torch.where(upper, l01, l00))
    lab_w = torch.where(inside, lab_w, torch.zeros_like(lab_w))
    return img_w, lab_w


def warp_image_label(img: torch.Tensor, label: torch.Tensor,
                     sy: torch.Tensor, sx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (N, H, W) f32, label (N, H, W) int, sy/sx (N, H, W) f32 source
    coordinates -> (warped image f32, warped label int32)."""
    if img.device.type == "cpu":
        return warp_image_label_plain(img, label, sy, sx)
    n, h, w = _check_cuda("warp kernel", img=img, label=label, sy=sy, sx=sx)
    for name, t in (("img", img), ("sy", sy), ("sx", sx)):
        if t.dtype != torch.float32:
            raise ValueError(f"warp kernel: {name} must be f32, got "
                             f"{t.dtype}")
    if label.dtype != torch.int32:
        raise ValueError(f"warp kernel: label must be int32, got "
                         f"{label.dtype}")
    lib = build.load("warp")
    out_img = torch.empty_like(img)
    out_lab = torch.empty_like(label)
    if img.numel():
        with torch.cuda.device(img.device):
            build.check(lib.warp_forward(
                img.data_ptr(), label.data_ptr(), sy.data_ptr(),
                sx.data_ptr(), out_img.data_ptr(), out_lab.data_ptr(), n, h,
                w, torch.cuda.current_stream().cuda_stream), "warp kernel")
        warp_image_label.launches += 1
    return out_img, out_lab


warp_image_label.launches = 0


def sample_bilinear_plain(imgs: torch.Tensor, sy: torch.Tensor,
                          sx: torch.Tensor) -> torch.Tensor:
    """imgs (N, H, W) f32; sy/sx (N, Ho, Wo) source coordinates; zero
    outside. The JAX package's unpacked sampler (f32 taps)."""
    n, h, w = imgs.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    flat = imgs.reshape(n, h * w)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        v = torch.gather(flat, 1, idx.reshape(n, -1)).reshape(yi.shape)
        return torch.where(inside, v, torch.zeros_like(v))

    return ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
            + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))


def sample_nearest_plain(labels: torch.Tensor, sy: torch.Tensor,
                         sx: torch.Tensor) -> torch.Tensor:
    """Nearest tap (round half to even, as jnp.round), 0 outside."""
    n, h, w = labels.shape
    yi, xi = torch.round(sy), torch.round(sx)
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
    v = torch.gather(labels.reshape(n, h * w), 1,
                     idx.reshape(n, -1)).reshape(yi.shape)
    return torch.where(inside, v, torch.zeros_like(v))


def resample_plain(img: torch.Tensor, mask: torch.Tensor, sy: torch.Tensor,
                   sx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resample in torch ops: each channel of an (N, H, W, C) image
    sampled as its own (N, H, W) image."""
    if img.dim() == 4:
        out = torch.stack([sample_bilinear_plain(img[..., c], sy, sx)
                           for c in range(img.shape[-1])], dim=-1)
    else:
        out = sample_bilinear_plain(img, sy, sx)
    return out, sample_nearest_plain(mask, sy, sx)


def resample(img: torch.Tensor, mask: torch.Tensor, sy: torch.Tensor,
             sx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (N, H, W) or (N, H, W, C) f32, mask (N, H, W) int32, sy/sx
    (N, Ho, Wo) f32 source coordinates -> (image (N, Ho, Wo[, C]) f32,
    mask (N, Ho, Wo) int32): bilinear image, nearest mask, zero fill. An
    image with channels runs as N * C planes under one launch, each
    sample's coordinates read once for its C planes and its mask."""
    if img.device.type == "cpu":
        return resample_plain(img, mask, sy, sx)
    if img.dim() not in (3, 4):
        raise ValueError(f"resample kernel: image must be (N, H, W) or "
                         f"(N, H, W, C), got {tuple(img.shape)}")
    planes = img.permute(0, 3, 1, 2) if img.dim() == 4 else img[:, None]
    n, c, h, w = planes.shape
    if tuple(mask.shape) != (n, h, w):
        raise ValueError(f"resample kernel: mask {tuple(mask.shape)} does "
                         f"not match the image {tuple(img.shape)}")
    _, ho, wo = _check_cuda("resample kernel", sy=sy, sx=sx)
    if sy.shape[0] != n:
        raise ValueError(f"resample kernel: {sy.shape[0]} coordinate "
                         f"grids for {n} samples")
    for name, t in (("img", img), ("mask", mask)):
        if t.device != sy.device:
            raise ValueError(f"resample kernel: {name} on {t.device}, "
                             f"coordinates on {sy.device}")
    for name, t in (("img", img), ("sy", sy), ("sx", sx)):
        if t.dtype != torch.float32:
            raise ValueError(f"resample kernel: {name} must be f32, got "
                             f"{t.dtype}")
    if mask.dtype != torch.int32:
        raise ValueError(f"resample kernel: mask must be int32, got "
                         f"{mask.dtype}")
    if not planes.numel():
        raise ValueError(f"resample kernel: empty image "
                         f"{tuple(img.shape)}")
    planes, mask = planes.contiguous(), mask.contiguous()
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=sy.device)
    out_mask = torch.empty((n, ho, wo), dtype=torch.int32, device=sy.device)
    if out_mask.numel():
        lib = build.load("warp")
        with torch.cuda.device(sy.device):
            build.check(lib.resample_forward(
                planes.data_ptr(), mask.data_ptr(), sy.data_ptr(),
                sx.data_ptr(), out.data_ptr(), out_mask.data_ptr(), n, c, h,
                w, ho, wo, torch.cuda.current_stream().cuda_stream),
                "resample kernel")
        resample.launches += 1
    return (out.permute(0, 2, 3, 1).contiguous() if img.dim() == 4
            else out[:, 0]), out_mask


resample.launches = 0
