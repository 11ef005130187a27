"""Eval-mode DenseNet dense block: csrc/dense_block.cu and its plain version.

Counterpart of saunet_tpu/ops/pallas/dense_block.py. `fold_dense_block_params`
turns one `DenseBlock`'s BN running statistics and conv weights into the
block's operands, once per model, and `kernel_layout` adds the kernel's
layout of W1 and W2; `dense_block` runs the block through the
CUDA kernel for a CUDA tensor (or raises), and through `dense_block_plain`
for a tensor on the CPU. Layouts are the JAX package's: NHWC in and out.

Per layer l (C_l = C0 + 32 l channels live):
    u   = relu(x_cat * a1 + b1)            norm1 affine
    t   = relu(u @ W1' + b2)               conv1 1x1, norm2 folded into W1'
    new = conv3x3(t, W2)                   conv2, zero boundary
    x_cat = concat(x_cat, new)
In bf16 the products accumulate in f32 and u, t and new round to bf16, the
TPU kernel's rounding points.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...utils.config import BN_EPS
from . import build

GROWTH = 32
HIDDEN = 128  # bn_size * growth


def fold_dense_block_params(block, eps: float = BN_EPS,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> Dict[str, torch.Tensor]:
    """Stack and BN-fold a `models.densenet.DenseBlock` into kernel
    operands (L layers, Cmax = C0 + L*GROWTH), as the JAX fold lays them out:

      a1, b1: (L, 1, Cmax)    norm1 affine, zero-padded channels (`dtype`)
      w1:     (L, Cmax, HIDDEN) conv1 with the norm2 scale folded (`dtype`)
      b2:     (L, 1, HIDDEN)  norm2 shift, f32
      w2:     (L, HIDDEN, 9*GROWTH) the 9 conv2 taps side by side, column
              tap*GROWTH + o with tap = 3*ky + kx (`dtype`)
    """
    layers = list(block.children())
    c0 = layers[0].norm1.num_features
    cmax = c0 + len(layers) * GROWTH
    a1s, b1s, w1s, b2s, w2s = [], [], [], [], []
    with torch.no_grad():
        for l, layer in enumerate(layers):
            cl = c0 + l * GROWTH
            n1, n2 = layer.norm1, layer.norm2
            a1 = n1.weight * torch.rsqrt(n1.running_var + eps)
            b1 = n1.bias - n1.running_mean * a1
            a1s.append(F.pad(a1, (0, cmax - cl))[None])
            b1s.append(F.pad(b1, (0, cmax - cl))[None])

            w1 = layer.conv1.weight[:, :, 0, 0].t()  # (Cl, HIDDEN)
            a2 = n2.weight * torch.rsqrt(n2.running_var + eps)
            w1s.append(F.pad(w1 * a2[None, :], (0, 0, 0, cmax - cl)))
            b2s.append((n2.bias - n2.running_mean * a2)[None])

            w2 = layer.conv2.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
            w2s.append(w2.reshape(9, HIDDEN, GROWTH).permute(1, 0, 2)
                       .reshape(HIDDEN, 9 * GROWTH))
    return {
        "a1": torch.stack(a1s).to(dtype).contiguous(),
        "b1": torch.stack(b1s).to(dtype).contiguous(),
        "w1": torch.stack(w1s).to(dtype).contiguous(),
        "b2": torch.stack(b2s).float().contiguous(),
        "w2": torch.stack(w2s).to(dtype).contiguous(),
    }


def dense_block_plain(x: torch.Tensor,
                      folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The block with BN affine, F.conv2d 1x1 and 3x3 and torch.cat.

    x: (N, H, W, C0) -> (N, H, W, Cmax). With f32 operands the math is f32
    throughout; with bf16 operands (bf16 mode) the input, u, t and the new
    channels round to bf16 where the kernel rounds, and the products
    accumulate in f32."""
    bf16 = folded["w1"].dtype == torch.bfloat16
    num_layers = folded["w1"].shape[0]
    c0 = x.shape[-1]

    def rnd(v):
        return v.to(torch.bfloat16).float() if bf16 else v

    h = rnd(x.permute(0, 3, 1, 2).float())
    for l in range(num_layers):
        cl = c0 + l * GROWTH
        a1 = folded["a1"][l, 0, :cl].float().view(1, cl, 1, 1)
        b1 = folded["b1"][l, 0, :cl].float().view(1, cl, 1, 1)
        u = rnd(torch.relu(h * a1 + b1))
        w1 = folded["w1"][l, :cl].float().t()[:, :, None, None]
        b2 = folded["b2"][l, 0].float().view(1, HIDDEN, 1, 1)
        t = rnd(torch.relu(F.conv2d(u, w1) + b2))
        w2 = (folded["w2"][l].float().view(HIDDEN, 3, 3, GROWTH)
              .permute(3, 0, 1, 2))
        new = rnd(F.conv2d(t, w2, padding=1))
        h = torch.cat([h, new], dim=1)
    out = h.permute(0, 2, 3, 1).contiguous()
    return out.to(torch.bfloat16) if bf16 else out


def kernel_layout(folded: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """`folded` with W1 and W2 also laid out for the kernel, K contiguous
    for each output channel (what ldmatrix reads as the B operand of mma):

      w1t: (L, HIDDEN, Cmax)        w1t[l, o, c] = w1[l, c, o]
      w2t: (L, 9, GROWTH, HIDDEN)   w2t[l, tap, o, k] = w2[l, k, tap*32 + o]

    Called once per fold (`models.fused_encoder.fold_encoder`); the kernel
    reads these two in place of w1 and w2, and `fold_dense_block_params`
    keeps the JAX package's layout."""
    w1, w2 = folded["w1"], folded["w2"]
    num_layers = w1.shape[0]
    return {**folded, "w1t": w1.transpose(1, 2).contiguous(),
            "w2t": w2.view(num_layers, HIDDEN, 9, GROWTH).permute(0, 2, 3, 1)
            .contiguous()}


def dense_block(x: torch.Tensor,
                folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: (N, H, W, C0) NHWC -> (N, H, W, C0 + L*GROWTH).

    CPU tensors take `dense_block_plain`. CUDA tensors launch the kernel,
    which takes bf16 input and bf16-folded operands passed through
    `kernel_layout`, or raise."""
    if x.device.type == "cpu":
        return dense_block_plain(x, folded)
    if not x.is_cuda:
        raise ValueError(f"dense block kernel: no kernel for {x.device}")
    if x.dim() != 4:
        raise ValueError(f"dense block kernel: expected NHWC, got "
                         f"{tuple(x.shape)}")
    n, h, w, c0 = x.shape
    num_layers, _, cmax = folded["a1"].shape
    shapes = {"a1": (num_layers, 1, cmax), "b1": (num_layers, 1, cmax),
              "w1t": (num_layers, HIDDEN, cmax),
              "b2": (num_layers, 1, HIDDEN),
              "w2t": (num_layers, 9, GROWTH, HIDDEN)}
    if c0 % GROWTH or cmax != c0 + num_layers * GROWTH:
        raise ValueError(f"dense block kernel: C0={c0} must be a multiple "
                         f"of {GROWTH} and match the folded width {cmax}")
    if "w1t" not in folded:
        raise ValueError("dense block kernel: the operands need the "
                         "kernel's layout; fold with kernel_layout")
    for name, shape in shapes.items():
        v = folded[name]
        want = torch.float32 if name == "b2" else torch.bfloat16
        if tuple(v.shape) != shape or v.dtype != want:
            raise ValueError(f"dense block kernel: {name} must be {want} "
                             f"{shape}, got {v.dtype} {tuple(v.shape)}")
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"dense block kernel: {name} must be contiguous "
                             f"on {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"dense block kernel: input must be contiguous "
                         f"bf16, got {x.dtype}")
    lib = build.load("dense_block")
    if (lib.dense_block_growth(), lib.dense_block_hidden()) != (GROWTH,
                                                                HIDDEN):
        raise RuntimeError("dense block kernel built for another width")
    out = torch.empty((n, h, w, cmax), dtype=torch.bfloat16, device=x.device)
    if n * h * w:
        with torch.cuda.device(x.device):
            build.check(lib.dense_block_forward(
                x.data_ptr(), out.data_ptr(), folded["a1"].data_ptr(),
                folded["b1"].data_ptr(), folded["w1t"].data_ptr(),
                folded["b2"].data_ptr(), folded["w2t"].data_ptr(), n, h, w,
                c0, num_layers, torch.cuda.current_stream().cuda_stream),
                "dense block kernel")
        dense_block.launches += 1
    return out


dense_block.launches = 0
