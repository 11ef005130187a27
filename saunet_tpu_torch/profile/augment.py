"""The augmentation by stage (counterpart of tools/profile_augment.py),
each stage of data/augment.py timed alone, then the whole
`make_augment_fn` with and without the elastic deformation:

  coords:       the draws and `coords_from_draws`, with the elastic
                field (its blur and upsampling) and without;
  warp:         image (bilinear) and labels (nearest) in one launch of the
                warp kernel (K5), where the JAX tool times two gathers;
  edge GT:      `edge_ground_truth` of the warped labels;
  gamma_zscore: the gamma, the per-sample z-score and the 3 channels, as
                `augment_with_coords` computes them.
"""
from __future__ import annotations

import torch

from ..data import augment as A
from ..ops.cuda.warp import warp_image_label
from . import common

TOOL = "tools/profile_augment.py"
STEPS = 20


def gamma_zscore(img_w: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """`augment_with_coords`'s gamma, z-score and channels of warped
    images (N, H, W) -> (N, H, W, 3)."""
    mn = img_w.amin(dim=(1, 2), keepdim=True)
    rng = img_w.amax(dim=(1, 2), keepdim=True) - mn
    img_g = torch.pow((img_w - mn) / (rng + 1e-7),
                      gamma[:, None, None]) * rng + mn
    mu = img_g.mean(dim=(1, 2), keepdim=True)
    sd = img_g.std(dim=(1, 2), keepdim=True, correction=0)
    img_a = (img_g - mu) / (sd + 1e-10)
    return img_a[..., None].expand(*img_a.shape, 3).contiguous()


def run(device=None, batch: int = common.PROF_BATCH, hw: int = common.PROF_HW,
        steps: int = STEPS) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    imgs = torch.randn((batch, hw, hw), generator=gen).to(device)
    labels = torch.randint(0, 4, (batch, hw, hw), generator=gen,
                           dtype=torch.int32).to(device)
    dgen = torch.Generator(device=device).manual_seed(common.SEED + 1)

    def coords(deform: bool):
        def run_once():
            d = A.draw(dgen, batch, hw, hw, deform, device)
            return A.coords_from_draws(h=hw, w=hw, **d)
        return run_once

    sy, sx, gamma = coords(True)()
    img_w, lab_w = warp_image_label(imgs, labels, sy, sx)
    full = A.make_augment_fn(4, True)
    full_nodeform = A.make_augment_fn(4, False)
    data = {"image": imgs, "label": labels}
    launches = {
        "warp": common.check_launches(
            lambda: warp_image_label(imgs, labels, sy, sx),
            {"warp_image_label": 1}, device, "augment warp"),
        "full": common.check_launches(lambda: full(dgen, data),
                                      {"warp_image_label": 1}, device,
                                      "full augment")}
    rows = []
    for name, fn, jax in (
            ("coords (elastic on)", coords(True), "coords (elastic on)"),
            ("coords (no deform)", coords(False), "coords (no deform)"),
            ("warp image+labels (K5)",
             lambda: warp_image_label(imgs, labels, sy, sx),
             "warp bilinear (image)"),
            ("edge ground truth", lambda: A.edge_ground_truth(lab_w, 4),
             "edge ground truth"),
            ("gamma + zscore + 3ch", lambda: gamma_zscore(img_w, gamma),
             "gamma + zscore + 3ch"),
            ("FULL augment (deform)", lambda: full(dgen, data),
             "FULL augment (deform)"),
            ("FULL augment (no deform)", lambda: full_nodeform(dgen, data),
             "FULL augment (no deform)")):
        ms = common.whole_ms(fn, device, steps)
        rows.append(common.row(name, ms, jax, slices_per_s=batch / ms * 1e3))
    return common.report("augment", device, TOOL, rows, batch=batch, hw=hw,
                         steps=steps, launches=launches)
