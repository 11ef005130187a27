"""Weights made from the seed on the device, for the program and the
reference alike.

One `torch.randn` call on a generator on the device fills every parameter
(He-normal convolution kernels, small biases, BatchNorm scales about 1 and
shifts about 0), in float32, the type both configurations keep their
parameters in (the bfloat16 configuration casts them as it computes).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def make_state(template: nn.Module, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter of `template` (the reference
    model: the port's names), drawn from `seed` on `device`."""
    shapes = [(n, p.shape) for n, p in template.named_parameters()]
    total = sum(s.numel() for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes:
        v = flat[offset:offset + shape.numel()].view(shape)
        offset += shape.numel()
        if len(shape) == 4:
            transposed = ".ConvTranspose_0." in name
            # a transposed conv of stride 2 sums cin * 4 taps an output
            fan_in = shape[0] * 4 if transposed else shape[1] * shape[2] * \
                shape[3]
            v = v * (2.0 / fan_in) ** 0.5
        elif _is_norm(template, name):
            v = 1.0 + 0.1 * v if name.endswith("weight") else 0.1 * v
        else:
            v = 0.01 * v
        out[name] = v
    return out


def _is_norm(model: nn.Module, name: str) -> bool:
    owner = model.get_submodule(name.rsplit(".", 1)[0])
    return hasattr(owner, "running_mean")


def load(model: nn.Module, params: Dict[str, torch.Tensor],
         buffers: Dict[str, torch.Tensor] | None = None) -> nn.Module:
    """Copy `params` (and BatchNorm `buffers`, when given) into `model`;
    raises unless the names are exactly the model's."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise KeyError(f"parameters differ: "
                       f"{sorted(own.keys() ^ params.keys())[:6]}")
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])
        if buffers is not None:
            own_b = dict(model.named_buffers())
            missing = sorted(k for k in own_b if k not in buffers
                             and not k.endswith("num_batches_tracked"))
            if missing:
                raise KeyError(f"buffers missing: {missing[:6]}")
            for n, b in buffers.items():
                own_b[n].copy_(b)
    return model
