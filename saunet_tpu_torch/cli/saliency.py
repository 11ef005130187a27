"""Saliency entry point: `python -m saunet_tpu_torch.cli.saliency <flags>`
(counterpart of saunet_tpu/cli/saliency.py, same flags plus `--device`).

Load a checkpoint (the port's `.pt` or the JAX package's `.msgpack`), pick
a slice of an ACDC train/val volume, and write its vanilla, guided or
SmoothGrad gradient map as four PNGs: `<volume>_z<slice>_<method>` +
`_color`, `_gray`, `_pos`, `_neg`. The model is f32, as the JAX CLI's.
It runs on the card (`--device cuda`, the default; a missing card is an
error) unless another device is named.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import ACDCDataset, normalize_for_eval
from ..interpret import (
    convert_to_grayscale,
    guided_model,
    positive_negative_saliency,
    save_gradient_image,
    smooth_grad,
    vanilla_gradients,
)
from ..models import build_unet
from ..train import restore_params_only
from ..train.state import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SAUNet (PyTorch) saliency maps")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data-root", dest="data_root", type=str,
                   default=os.getenv("DATA_ROOT", ""))
    p.add_argument("--volume", default=0, type=int,
                   help="train/val volume index")
    p.add_argument("--slice", dest="z", default=0, type=int)
    p.add_argument("--split", default="val")
    p.add_argument("--k_split", default=1, type=int)
    p.add_argument("--num_class", default=4, type=int)
    p.add_argument("--crop_size", default=256, type=int)
    p.add_argument("--method", default="smoothgrad",
                   choices=["vanilla", "guided", "smoothgrad",
                            "smoothgrad-guided"])
    p.add_argument("--classes", default="0,1",
                   help="comma-separated class seeds (reference uses 0,1)")
    p.add_argument("--param_n", default=50, type=int)
    p.add_argument("--sigma_multiplier", default=4.0, type=float)
    p.add_argument("--out", default="./saliency")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    classes = tuple(int(c) for c in args.classes.split(","))
    device = resolve_device(args.device)

    model = build_unet(num_class=args.num_class)
    restore_params_only(args.checkpoint, model)
    model = model.to(device).eval()
    if args.method.endswith("guided"):
        model = guided_model(model)

    ds = ACDCDataset(args.data_root, split=args.split, k_split=args.k_split,
                     target_size=args.crop_size)
    vol = ds.load_volume(args.volume)
    raw = torch.from_numpy(vol.image[None, :, :, args.z].copy()).to(device)
    image = normalize_for_eval(raw)[0]  # (H, W, 3)
    target = torch.from_numpy(
        vol.label[:, :, args.z].astype(np.int64)).to(device)

    def grad_fn(img):
        return vanilla_gradients(model, img, target, classes)

    if args.method in ("vanilla", "guided"):
        grads = grad_fn(image)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        grads = smooth_grad(grad_fn, gen, image, n=args.param_n,
                            sigma_multiplier=args.sigma_multiplier)

    os.makedirs(args.out, exist_ok=True)
    tag = f"{vol.name}_z{args.z}_{args.method}"
    g = grads.cpu().numpy()
    save_gradient_image(g, os.path.join(args.out, tag + "_color.png"))
    save_gradient_image(convert_to_grayscale(g),
                        os.path.join(args.out, tag + "_gray.png"))
    pos, neg = positive_negative_saliency(g)
    save_gradient_image(pos, os.path.join(args.out, tag + "_pos.png"))
    save_gradient_image(neg, os.path.join(args.out, tag + "_neg.png"))
    print(f"Saved 4 saliency maps for {tag} to {args.out}")


if __name__ == "__main__":
    main()
