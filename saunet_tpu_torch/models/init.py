"""Seeded random weights for a port model (checks and smoke runs).

Convs get the JAX package's init, Kaiming-normal over fan-out
(std = sqrt(2 / (k*k*out))) with zero biases. BatchNorm gets scale 1 and
bias 0, and running statistics drawn at random (mean 0.1*N(0,1), var
0.5 + U(0,1)) so that folding them into the dense-block kernel's operands
is not the identity.
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill `model`'s parameters and BN statistics in place from
    `generator` (a CPU generator; the model may live anywhere)."""

    def fill(t: torch.Tensor, values: torch.Tensor):
        t.copy_(values.to(t.device, t.dtype))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            out = w.shape[1] if isinstance(m, nn.ConvTranspose2d) \
                else w.shape[0]
            std = math.sqrt(2.0 / (out * w.shape[2] * w.shape[3]))
            fill(w, torch.randn(w.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            m.weight.fill_(1.0)
            m.bias.zero_()
            fill(m.running_mean, 0.1 * torch.randn(c, generator=generator))
            fill(m.running_var, 0.5 + torch.rand(c, generator=generator))
    return model


@torch.no_grad()
def calibrate_bn_(model: nn.Module, x: torch.Tensor,
                  var_floor: float = 0.1) -> nn.Module:
    """Set every BatchNorm's running statistics to the batch statistics of
    one train-mode forward of `model` on `x`, so that random weights give
    activations of a trained network's scale instead of growing with
    depth. Variances are floored at `var_floor`: a channel that is nearly
    constant on `x` would otherwise scale its rounding errors by up to
    1/sqrt(eps). The model is left in the mode it was in."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch sets the stats
    was_training = model.training
    model.train()
    try:
        model(x)
    finally:
        model.train(was_training)
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
            m.running_var.clamp_(min=var_floor)
    return model
