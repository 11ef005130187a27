"""Eval/inference DenseNet-121 encoder on the dense-block kernel
(counterpart of saunet_tpu/models/fused_encoder.py).

Drives the same modules as `DenseNetEncoder` but computes each dense block
with `ops.cuda.dense_block` (the CUDA kernel on a GPU, its plain version on
the CPU) from operands folded once per model. conv0/norm0, the transitions
and norm5 stay plain PyTorch. Every block on the card goes through the
kernel: there is no size-dependent fallback, because the kernel keeps its
concat in device memory and has no VMEM-style size limit.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..ops.cuda.dense_block import (
    dense_block,
    fold_dense_block_params,
    kernel_layout,
)
from ..utils.config import BN_EPS


def _bn_affine(x: torch.Tensor, bn) -> torch.Tensor:
    """Eval BN as `x * a + b`, with a and b in x's dtype (the JAX fused
    encoder's `_bn_affine`); x is NCHW."""
    a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    b = bn.bias - bn.running_mean * a
    return (x * a.to(x.dtype).view(1, -1, 1, 1)
            + b.to(x.dtype).view(1, -1, 1, 1))


def fold_encoder(encoder, dtype: torch.dtype) -> List[dict]:
    """Kernel operands for each dense block of `encoder`, in `dtype`, with
    the kernel's layout of W1 and W2 beside the JAX one."""
    return [kernel_layout(fold_dense_block_params(b, dtype=dtype))
            for b in encoder.blocks()]


def encoder_apply_fused(encoder, folded: List[dict], x: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16,
                        block=None) -> Tuple[torch.Tensor, ...]:
    """(N, H, W, 3) NHWC -> the five taps f1..f5, NHWC, eval mode.

    `folded` is `fold_encoder(encoder, dtype)`. The dense blocks run in
    `dtype` through `block` (the kernel wrapper; a check may pass
    `dense_block_plain`; None: this module's `dense_block`, looked up at
    the call); on the card the kernel takes bf16 only."""
    block = dense_block if block is None else block
    x = x.to(dtype).permute(0, 3, 1, 2)
    f1 = _bn_affine(encoder.conv0(x), encoder.norm0)
    h = f1.permute(0, 2, 3, 1).contiguous()
    taps = []
    n_blocks = len(encoder.block_config)
    for i in range(n_blocks):
        h = block(h, folded[i]).to(dtype)
        if i != n_blocks - 1:
            tr = getattr(encoder, f"transition{i + 1}")
            t = F.relu(_bn_affine(h.permute(0, 3, 1, 2), tr.norm))
            t = F.avg_pool2d(tr.conv(t), 2)
            h = t.permute(0, 2, 3, 1).contiguous()
            taps.append(h)
    f5 = _bn_affine(h.permute(0, 3, 1, 2), encoder.norm5)
    f2, f3, f4 = taps
    return (f1.permute(0, 2, 3, 1), f2, f3, f4, f5.permute(0, 2, 3, 1))
