"""Train-mode blocks alone (counterparts of tools/profile_block_train.py,
tools/profile_concat.py and tools/profile_res1.py), bf16 activations on
f32 weights drawn from a seed, as in the step:

  block_train: each dense block's fwd+bwd (the gradient of the mean of its
               output with respect to its parameters) at the step's block
               geometries, DenseNet-121's (6, 12, 24, 16) layers at H/2 ..
               H/16 with 64, 128, 256, 512 input channels (112^2 .. 14^2
               at 224^2), each beside its bound (`bound_ms`);
  concat:      the encoder's forward, and its fwd+bwd (the sum of squares
               of every tap), in each train layout ('chain', 'buffer',
               'fused'; models/densenet.py);
  res1:        the shape stream's first residual block (two 64-channel
               3x3 convs) at full resolution, forward and fwd+bwd (with
               respect to its parameters and input). The JAX tool A/Bs a
               mid/cross split of the lane-packed conv; the packed layout
               is a TPU memory layout that the port does not port, so the
               port times its one block.
"""
from __future__ import annotations

import torch

from ..models.blocks import ResBasicBlock
from ..models.densenet import (
    BN_SIZE,
    CONCAT_MODES,
    DENSENET121_BLOCKS,
    GROWTH_RATE,
    DenseBlock,
    DenseNetEncoder,
)
from ..models.init import init_random_
from ..utils.profiling import BF16_OPS_PER_S, bound
from . import common

STEPS = {"block_train": 10, "concat": 10, "res1": 20}
#: the input channels of DenseNet-121's blocks
BLOCK_INPUTS = (64, 128, 256, 512)


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen).to(device, torch.bfloat16)


def dense_block_bound(n: int, hw: int, c0: int, layers: int):
    """The least time of one dense block's train fwd+bwd: its products
    three times over (forward, input gradient, weight gradient: 1x1 c_in
    -> 128 and 3x3 128 -> 32 a layer, bf16), and its input (bf16) read
    and its parameters (f32) read and their gradients written once."""
    px = n * hw * hw
    hidden = BN_SIZE * GROWTH_RATE
    fwd = sum(2 * px * ((c0 + GROWTH_RATE * l) * hidden
                        + 9 * hidden * GROWTH_RATE) for l in range(layers))
    params = sum(2 * (c0 + GROWTH_RATE * l)  # norm1
                 + (c0 + GROWTH_RATE * l) * hidden + 2 * hidden
                 + 9 * hidden * GROWTH_RATE for l in range(layers))
    return bound(2 * px * c0 + 8 * params, 3 * fwd, BF16_OPS_PER_S)


def fwd_bwd(module, objective, *inputs):
    def run():
        module.zero_grad(set_to_none=True)
        objective(module, *inputs).backward()
    return run


def block_train(device=None, batch: int = common.PROF_BATCH,
                hw: int = common.PROF_HW,
                steps: int = STEPS["block_train"]) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    rows, total = [], 0.0
    for i, (layers, c0) in enumerate(zip(DENSENET121_BLOCKS, BLOCK_INPUTS)):
        s = hw // 2 ** (i + 1)
        blk = init_random_(DenseBlock(c0, layers), gen).to(device).train()
        x = _randn(gen, (batch, c0, s, s), device)
        ms = common.whole_ms(fwd_bwd(
            blk, lambda m, x: m(x).float().mean(), x), device, steps)
        b_ms, b_by = dense_block_bound(batch, s, c0, layers)
        rows.append(common.row(f"denseblock{i + 1} ({s}^2 C{c0} L{layers})",
                               ms, "denseblock", bound_ms=b_ms, bound_by=b_by))
        total += ms
    rows.append(common.row("all blocks fwd+bwd", total, "all blocks fwd+bwd"))
    return common.report("block_train", device,
                         "tools/profile_block_train.py", rows, batch=batch,
                         hw=hw, steps=steps)


def concat(device=None, batch: int = common.PROF_BATCH,
           hw: int = common.PROF_HW, steps: int = STEPS["concat"]) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    x = _randn(gen, (batch, 3, hw, hw), device)
    rows = []

    def squares(enc, x):
        return sum(t.float().square().sum() for t in enc(x))

    for mode in CONCAT_MODES:
        enc = init_random_(DenseNetEncoder(concat_mode=mode),
                           torch.Generator().manual_seed(common.SEED))
        enc = enc.to(device).train()

        def forward(enc=enc):
            with torch.no_grad():
                return squares(enc, x)

        rows.append(common.row(f"{mode} encoder fwd", common.whole_ms(
            forward, device, steps), "encoder fwd"))
        rows.append(common.row(f"{mode} encoder fwd+bwd", common.whole_ms(
            fwd_bwd(enc, squares, x), device, steps), "encoder fwd+bwd"))
        del enc
    return common.report("concat", device, "tools/profile_concat.py", rows,
                         batch=batch, hw=hw, steps=steps)


def res1(device=None, batch: int = common.PROF_BATCH,
         hw: int = common.PROF_HW, steps: int = STEPS["res1"]) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    blk = init_random_(ResBasicBlock(64), gen).to(device).train()
    x = _randn(gen, (batch, 64, hw, hw), device).requires_grad_(True)

    def forward():
        with torch.no_grad():
            return blk(x).float().sum()

    def both():
        blk.zero_grad(set_to_none=True)
        x.grad = None
        blk(x).float().sum().backward()

    rows = [common.row("res1 fwd", common.whole_ms(forward, device, steps),
                       "fwd"),
            common.row("res1 fwd+bwd", common.whole_ms(both, device, steps),
                       "fwd+bwd")]
    return common.report("res1", device, "tools/profile_res1.py", rows,
                         batch=batch, hw=hw, steps=steps)
