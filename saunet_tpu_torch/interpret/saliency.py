"""Saliency maps: vanilla and guided backprop and SmoothGrad through the
full SAUNet (counterpart of saunet_tpu/interpret/saliency.py).

  * vanilla: the gradient w.r.t. the image of the sum over the seeded
    classes of `logits[c] * (target == c)`, the reference's one-hot seed
    over classes (0, 1). The model runs in eval mode under autograd through
    `forward` (the cuDNN encoder and module stream: the dense-block and
    shape-stream kernels have no backward); the Canny cue's input is
    detached, so Canny (its kernel on the card) runs on every forward.
  * guided: the same with every block's ReLU replaced by `guided_relu`,
    whose backward passes the gradient only where the input and the
    gradient are both positive.
  * SmoothGrad: the mean gradient over `n` noisy copies, noise std
    (sigma_multiplier / (max - min)) ** 2 (the reference's
    `normal_(mean, sigma**2)` takes a std), drawn from an explicit
    generator, `batch_size` copies a forward and a backward. Eval BatchNorm
    and the per-sample gray rescale of the Canny cue make the samples
    independent, so a batched backward gives each copy its own gradient.

Images are NHWC, as in the JAX package: (H, W, 3) or (N, H, W, 3), and the
gradient comes back in the image's layout.
"""
from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch

from ..models.blocks import set_act
from ..utils.png import write_png


class _GuidedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), whose backward passes `g` only where x > 0 and g > 0."""
    return _GuidedReLU.apply(x)


def guided_model(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` that shares its parameters and buffers and whose
    modules' `act` is `guided_relu` (the JAX `model.clone(act=...)`)."""
    shared = {id(t): t for t in (*model.parameters(), *model.buffers())}
    clone = copy.deepcopy(model, memo=shared)
    set_act(clone, guided_relu)
    return clone


def vanilla_gradients(model: torch.nn.Module, image: torch.Tensor,
                      target: torch.Tensor,
                      classes: Sequence[int] = (0, 1)) -> torch.Tensor:
    """d(sum over c in `classes` of logits[c] * (target == c)) / d(image).

    image (H, W, 3), or (N, H, W, 3) for N independent images; target
    (H, W) (or (N, H, W)) int labels. Returns the gradient, shaped as
    `image`."""
    squeeze = image.dim() == 3
    if squeeze:
        image = image[None]
    was_training = model.training
    model.eval()
    try:
        with torch.enable_grad():
            img = image.detach().requires_grad_(True)
            seg = model(img.permute(0, 3, 1, 2))[0]  # (N, C, H, W) f32
            seed = torch.stack([target == c for c in classes],
                               dim=-3).to(seg.dtype)
            objective = (seg[:, list(classes)] * seed).sum()
            (grad,) = torch.autograd.grad(objective, img)
    finally:
        model.train(was_training)
    return grad[0] if squeeze else grad


def guided_gradients(model: torch.nn.Module, image: torch.Tensor,
                     target: torch.Tensor,
                     classes: Sequence[int] = (0, 1)) -> torch.Tensor:
    return vanilla_gradients(guided_model(model), image, target, classes)


def smooth_grad(grad_fn: Callable[[torch.Tensor], torch.Tensor],
                generator: torch.Generator, image: torch.Tensor,
                n: int = 50, sigma_multiplier: float = 4.0,
                batch_size: int = 10) -> torch.Tensor:
    """Mean of `grad_fn(image + noise)` over `n` noisy copies of `image`.

    `grad_fn` takes a batch (B, *image.shape) and returns each copy's
    gradient, shaped so; it is called once per chunk of `batch_size`
    copies. The noise (std (sigma_multiplier / (max - min)) ** 2) comes
    from `generator`, which lives on the image's device."""
    sigma = sigma_multiplier / (float(image.max()) - float(image.min()))
    std = sigma ** 2
    total = torch.zeros_like(image)
    for i in range(0, n, batch_size):
        b = min(batch_size, n - i)
        noise = torch.randn((b, *image.shape), generator=generator,
                            device=image.device, dtype=image.dtype)
        total += grad_fn(image + noise * std).sum(dim=0)
    return total / n


def convert_to_grayscale(grads) -> np.ndarray:
    """Sum |grad| over channels, clip at the 99th percentile, rescale to
    [0, 1]."""
    g = np.sum(np.abs(np.asarray(grads)), axis=-1)
    hi = np.percentile(g, 99)
    lo = g.min()
    return np.clip((g - lo) / (hi - lo + 1e-12), 0, 1)


def positive_negative_saliency(grads):
    """(pos, neg) maps normalised by their own extrema."""
    g = np.asarray(grads)
    pos = np.maximum(0, g) / (g.max() + 1e-12)
    neg = np.maximum(0, -g) / (-g.min() + 1e-12)
    return pos, neg


def save_gradient_image(grads, path: str) -> None:
    """Min-max scale a gradient map to 8 bits and write it as a PNG: RGB
    for (H, W, 3), gray otherwise (the first channel of (H, W, C))."""
    g = np.asarray(grads, dtype=np.float64)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    arr = (g * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] != 3:
        arr = arr[..., 0]
    write_png(path, arr)
