"""Seeded random weights for a port model (checks and smoke runs).

`init_random_`: convs get the JAX package's init, Kaiming-normal over
fan-out (std = sqrt(2 / (k*k*out))) with zero biases. BatchNorm gets scale
1 and bias 0, and running statistics drawn at random (mean 0.1*N(0,1), var
0.5 + U(0,1)) so that folding them into the dense-block kernel's operands
is not the identity.

`fill_from_seed_`: the weights that the parity tests give the JAX package
(tests/torch_port_util.py::fill_variables), drawn from a numpy
RandomState in the JAX variable tree's leaf order, so that a machine
without jax starts from the same numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .jax_weights import from_jax_variables


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


def _jax_leaf_shapes(model: nn.Module) -> dict:
    """{('params' | 'batch_stats', *flax path, leaf): flax-layout shape}
    of every weight of `model` (the port's modules carry the flax names)."""
    leaves = {}
    for name, m in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, nn.BatchNorm2d):
            c = (m.num_features,)
            for tree, leaf in (("params", "scale"), ("params", "bias"),
                               ("batch_stats", "mean"),
                               ("batch_stats", "var")):
                leaves[(tree,) + path + (leaf,)] = c
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            o, i, kh, kw = m.weight.shape  # ConvTranspose2d: (in, out, ...)
            hwio = (kh, kw, o, i) if isinstance(m, nn.ConvTranspose2d) \
                else (kh, kw, i, o)
            leaves[("params",) + path + ("kernel",)] = hwio
            if m.bias is not None:
                leaves[("params",) + path + ("bias",)] = tuple(m.bias.shape)
    return leaves


@torch.no_grad()
def fill_from_seed_(model: nn.Module, seed: int,
                    fuse_scale: float = 1.0) -> nn.Module:
    """Load into `model` the variables `fill_variables(tree, seed)` gives
    the JAX model of the same tree: one np.random.RandomState(seed), the
    leaves in jax's flattening order (dict keys sorted at every level, so
    'batch_stats' before 'params'), conv kernels N(0, sqrt(2 / fan_in))
    over the flax kernel's (kh, kw, in) fan-in, biases 0.1*N, BatchNorm
    scale 1 + 0.1*N, running mean 0.1*N, running var 0.5 + U(0, 1), each
    drawn in float64 and rounded to f32. `fuse_scale` scales the `fuse`
    kernel in f32 afterwards, as the golden variables scale it by 0.05."""
    rs = np.random.RandomState(seed)
    tree: dict = {}
    for key, shape in sorted(_jax_leaf_shapes(model).items()):
        leaf = key[-1]
        if key[0] == "batch_stats":
            v = (0.1 * rs.randn(*shape) if leaf == "mean"
                 else 0.5 + rs.rand(*shape))
        elif leaf == "kernel":
            v = rs.randn(*shape) * np.sqrt(2.0 / int(np.prod(shape[:-1])))
        elif leaf == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(v, np.float32)
    if fuse_scale != 1.0:
        fuse = tree["params"]["fuse"]
        fuse["kernel"] = fuse["kernel"] * np.float32(fuse_scale)
    model.load_state_dict(from_jax_variables(tree), strict=True)
    return model
