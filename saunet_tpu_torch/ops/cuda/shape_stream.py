"""Eval-mode shape stream in one kernel call: csrc/shape_stream.cu and its
plain version.

Counterpart of saunet_tpu/ops/pallas/shape_stream.py. `fold_shape_stream_
params` turns the stream's modules (res1..res3, d1..d3, gate1..gate3, fuse)
and their BN running statistics into the kernel's operands, once per model;
`shape_stream_fused` runs the stream through the CUDA kernel for a CUDA
tensor (or raises), and through `shape_stream_plain` for a tensor on the
CPU. Layouts are the JAX package's: the packed (N, H, W, 67) input of
`SAUNet.shape_stream_inputs` in, the (N, H, W, 1) f32 edge map out; the
fold also holds the 3x3 conv weights in the kernel's layout
(`layout_specs`), which the plain version does not read.

Stage i (C = 64, 32, 16 channels entering it, Cn = C / 2, cue = input
channel 64 + i), in bf16 with f32 accumulation, rounding where the TPU
kernel rounds:
    y   = bf16(relu(conv3x3(ss, W1') + b1))             res block, bn1 folded
    ss  = bf16(relu(conv3x3(y, W2') + b2 + ss))         bn2 folded
    ss  = bf16(ss @ Wd + bd)                            d_i
    pre = bf16(bf16(ss * a_ss) + b_ss)                  gate_bn1, ss part
    g   = bf16(relu(pre @ W1ss + (cue*a_cue + b_cue) * w1cue + b1g))
    alpha = sigmoid(a2 * (g @ w2 + b2g) + bn2b)         gate_conv2, gate_bn2
    ss  = bf16(bf16(ss * (alpha + 1)) @ Wg)             gate conv
and last edge = bf16(sigmoid(ss @ Wfuse)) as f32. Every 3x3 conv pads with
zeros (SAME). The gate's (C+1)-channel concat is never built: its BN is a
per-channel affine and its 1x1 conv splits into the ss rows and the cue row.
The TPU kernel casts to bf16 whatever the model's dtype, and so does this.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...utils.config import BN_EPS
from . import build

CHANNELS = (64, 32, 16, 8)  # ss width entering res1 / res2 / res3 / fuse
CUE = 64                    # input channels 64, 65, 66: the gates' cues
PACKED = CUE + 3


def _affine(bn, eps: float):
    a = bn.weight * torch.rsqrt(bn.running_var + eps)
    return a, bn.bias - bn.running_mean * a


def _mat(conv) -> torch.Tensor:
    """A 1x1 conv's weight as a (C_in, C_out) matrix."""
    return conv.weight[:, :, 0, 0].t()


def operand_specs(i: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Stage i's operands, name -> (shape, dtype), in the order the C entry
    point reads them."""
    c, cn = CHANNELS[i], CHANNELS[i + 1]
    bf16, f32 = torch.bfloat16, torch.float32
    return {"r_w1": ((9, c, c), bf16), "r_b1": ((c,), f32),
            "r_w2": ((9, c, c), bf16), "r_b2": ((c,), f32),
            "d_w": ((c, cn), bf16), "d_b": ((cn,), f32),
            "g_a_ss": ((cn,), bf16), "g_b_ss": ((cn,), bf16),
            "g_a_cue": ((), f32), "g_b_cue": ((), f32),
            "g_w1_ss": ((cn, cn + 1), bf16), "g_w1_cue": ((cn + 1,), f32),
            "g_b1": ((cn + 1,), f32), "g_w2": ((cn + 1,), bf16),
            "g_b2": ((), f32), "g_a2": ((), f32), "g_bn2b": ((), f32),
            "g_wg": ((cn, cn), bf16)}


def layout_specs(i: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Stage i's conv weights as the kernel reads them, name -> (shape,
    dtype): r_w1k[tap, kc, o, e] = r_w1[tap, 8 * kc + e, o], and so r_w2k,
    the K-major layout of wgmma's B operand (8 input channels of one output
    channel in 16 bytes, one tap's C x C weights contiguous)."""
    c = CHANNELS[i]
    return {k: ((9, c // 8, c, 8), torch.bfloat16) for k in ("r_w1k", "r_w2k")}


def kernel_operands(i: int) -> list:
    """Stage i's operand names in the order the C entry point reads them:
    `operand_specs` with the conv weights in their kernel layout."""
    return [k + "k" if k in ("r_w1", "r_w2") else k for k in operand_specs(i)]


# Every operand of the fold, name -> (shape, dtype), and the order of the
# pointers the C entry point reads; made once, each call checks against them
_FOLD = {f"{i}/{k}": spec for i in range(3)
         for k, spec in {**operand_specs(i), **layout_specs(i)}.items()}
_FOLD["fuse_w"] = ((CHANNELS[3],), torch.bfloat16)
_POINTERS = [f"{i}/{k}" for i in range(3)
             for k in kernel_operands(i)] + ["fuse_w"]


def fold_shape_stream_params(model, eps: float = BN_EPS
                             ) -> Dict[str, torch.Tensor]:
    """BN-fold the stream modules of a `models.saunet.SAUNet` into kernel
    operands, `{i}/<name>` for stage i in 0..2 plus `fuse_w`:

      r_w1, r_w2: (9, C, C) bf16, tap 3*ky + kx, [tap, c_in, c_out], the
                  bn1 / bn2 scale folded in; r_b1, r_b2: (C,) f32 BN shifts
      d_w: (C, Cn) bf16; d_b: (Cn,) f32
      g_a_ss, g_b_ss: (Cn,) bf16, gate_bn1's affine on the ss channels;
      g_a_cue, g_b_cue: () f32, its affine on the cue channel
      g_w1_ss: (Cn, Cn+1) bf16 and g_w1_cue: (Cn+1,) f32, gate_conv1's ss
                  rows and cue row; g_b1: (Cn+1,) f32
      g_w2: (Cn+1,) bf16 and g_b2: () f32, gate_conv2
      g_a2, g_bn2b: () f32, gate_bn2's affine
      g_wg: (Cn, Cn) bf16, the gate's conv
      fuse_w: (8,) bf16
    and beside them the kernel's layout of the conv weights, r_w1k and r_w2k
    (`layout_specs`), made here once per model."""
    folded: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for i in range(3):
            res = getattr(model, f"res{i + 1}")
            d = getattr(model, f"d{i + 1}")
            gate = getattr(model, f"gate{i + 1}")
            c, cn = CHANNELS[i], CHANNELS[i + 1]
            ops = {}  # f32, cast to the operand dtypes below
            for j, (conv, bn) in enumerate(((res.conv1, res.bn1),
                                            (res.conv2, res.bn2)), 1):
                a, b = _affine(bn, eps)
                k = conv.weight.permute(2, 3, 1, 0).reshape(9, c, c)
                ops[f"r_w{j}"], ops[f"r_b{j}"] = k * a, b
            ops["d_w"], ops["d_b"] = _mat(d), d.bias
            a1, b1 = _affine(gate.gate_bn1, eps)
            ops["g_a_ss"], ops["g_b_ss"] = a1[:cn], b1[:cn]
            ops["g_a_cue"], ops["g_b_cue"] = a1[cn], b1[cn]
            w1 = _mat(gate.gate_conv1)
            ops["g_w1_ss"], ops["g_w1_cue"] = w1[:cn], w1[cn]
            ops["g_b1"] = gate.gate_conv1.bias
            ops["g_w2"] = _mat(gate.gate_conv2)[:, 0]
            ops["g_b2"] = gate.gate_conv2.bias[0]
            a2, b2 = _affine(gate.gate_bn2, eps)
            ops["g_a2"], ops["g_bn2b"] = a2[0], b2[0]
            ops["g_wg"] = _mat(gate.conv)
            for k, (_, dtype) in operand_specs(i).items():
                # copies: no operand aliases a weight
                folded[f"{i}/{k}"] = ops[k].to(dtype).contiguous().clone()
            for k in ("r_w1", "r_w2"):
                folded[f"{i}/{k}k"] = (folded[f"{i}/{k}"]
                                       .view(9, c // 8, 8, c)
                                       .permute(0, 1, 3, 2).contiguous())
        folded["fuse_w"] = _mat(model.fuse)[:, 0].to(
            torch.bfloat16).contiguous()
    return folded


def shape_stream_plain(packed: torch.Tensor,
                       folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stream with F.conv2d and elementwise ops, in f32 on bf16-rounded
    values (the products of two bf16 numbers are exact in f32, so the only
    differences from the kernel are summation orders).

    packed: (N, H, W, 67) -> edge (N, H, W, 1) f32."""

    def rnd(v):
        return v.to(torch.bfloat16).float()

    def op(i, name):
        return folded[f"{i}/{name}"].float()

    def chan(v):  # a per-channel vector broadcast over NCHW
        return v.view(1, -1, 1, 1)

    def conv1x1(v, w):  # w: (C_in, C_out)
        return F.conv2d(v, w.t()[:, :, None, None])

    x = packed.to(torch.bfloat16).permute(0, 3, 1, 2).float()
    ss = x[:, :CHANNELS[0]]
    for i in range(3):
        c = CHANNELS[i]
        w1 = op(i, "r_w1").view(3, 3, c, c).permute(3, 2, 0, 1)
        w2 = op(i, "r_w2").view(3, 3, c, c).permute(3, 2, 0, 1)
        y = rnd(torch.relu(F.conv2d(ss, w1, padding=1)
                           + chan(op(i, "r_b1"))))
        ss = rnd(torch.relu(F.conv2d(y, w2, padding=1) + chan(op(i, "r_b2"))
                            + ss))
        ss = rnd(conv1x1(ss, op(i, "d_w")) + chan(op(i, "d_b")))

        cue = x[:, CUE + i:CUE + i + 1]
        pre = rnd(rnd(ss * chan(op(i, "g_a_ss"))) + chan(op(i, "g_b_ss")))
        cuep = cue * op(i, "g_a_cue") + op(i, "g_b_cue")
        g = rnd(torch.relu(conv1x1(pre, op(i, "g_w1_ss"))
                           + cuep * chan(op(i, "g_w1_cue"))
                           + chan(op(i, "g_b1"))))
        g2 = conv1x1(g, op(i, "g_w2")[:, None]) + op(i, "g_b2")
        alpha = torch.sigmoid(op(i, "g_a2") * g2 + op(i, "g_bn2b"))
        ss = rnd(conv1x1(rnd(ss * (alpha + 1.0)), op(i, "g_wg")))
    edge = rnd(torch.sigmoid(conv1x1(ss, folded["fuse_w"].float()[:, None])))
    return edge.permute(0, 2, 3, 1).contiguous()


def _check(packed: torch.Tensor, folded: Dict[str, torch.Tensor]) -> None:
    if packed.dim() != 4 or packed.shape[-1] != PACKED:
        raise ValueError(f"shape stream kernel: expected (N, H, W, "
                         f"{PACKED}), got {tuple(packed.shape)}")
    if packed.dtype != torch.bfloat16 or not packed.is_contiguous():
        raise ValueError(f"shape stream kernel: input must be contiguous "
                         f"bf16, got {packed.dtype}")
    if packed.data_ptr() % 16:
        raise ValueError("shape stream kernel: input must start on a "
                         "16-byte boundary")
    if folded.keys() != _FOLD.keys():
        raise ValueError(f"shape stream kernel: operands "
                         f"{sorted(set(folded) ^ set(_FOLD))} missing or "
                         f"unknown")
    dev = packed.device
    for name, (shape, dtype) in _FOLD.items():
        v = folded[name]
        if v.shape != shape or v.dtype != dtype:
            raise ValueError(f"shape stream kernel: {name} must be {dtype} "
                             f"{shape}, got {v.dtype} {tuple(v.shape)}")
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"shape stream kernel: {name} must be "
                             f"contiguous on {dev}")


def shape_stream_fused(packed: torch.Tensor,
                       folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """packed (N, H, W, 67) from `SAUNet.shape_stream_inputs` -> edge
    (N, H, W, 1) f32, `folded` from `fold_shape_stream_params`.

    CPU tensors take `shape_stream_plain`. CUDA tensors launch the kernel,
    which takes a bf16 input, or raise."""
    if packed.device.type == "cpu":
        return shape_stream_plain(packed, folded)
    if not packed.is_cuda:
        raise ValueError(f"shape stream kernel: no kernel for "
                         f"{packed.device}")
    _check(packed, folded)
    n, h, w, _ = packed.shape
    lib = build.load("shape_stream")
    if lib.shape_stream_operands() != len(operand_specs(0)):
        raise RuntimeError("shape stream kernel built for other operands")
    ptrs = [folded[name].data_ptr() for name in _POINTERS]
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dev = packed.device
    out = torch.empty((n, h, w, 1), dtype=torch.float32, device=dev)
    ss1 = torch.empty((n, h, w, CHANNELS[1]), dtype=torch.bfloat16,
                      device=dev)
    ss2 = torch.empty((n, h, w, CHANNELS[2]), dtype=torch.bfloat16,
                      device=dev)
    if n * h * w:
        with torch.cuda.device(dev):
            build.check(lib.shape_stream_forward(
                packed.data_ptr(), ss1.data_ptr(), ss2.data_ptr(),
                out.data_ptr(), ptr_array, n, h, w,
                torch.cuda.current_stream().cuda_stream),
                "shape stream kernel")
        shape_stream_fused.launches += 1
    return out


shape_stream_fused.launches = 0
