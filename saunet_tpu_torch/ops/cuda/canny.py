"""Canny kernel wrapper: csrc/canny.cu, one kernel at every image size.

Counterpart of saunet_tpu/ops/pallas/canny.py. Its two Pallas entry points,
`canny_edges_pallas` (whole image) and `canny_edges_pallas_tiled` (row bands
above 220 000 pixels), are both served by the one tiled CUDA kernel, so the
port has no size switch. The plain version is ops/edge.py::canny_edges; the
wrapper takes it for a tensor on the CPU and launches the kernel for a CUDA
tensor, or raises.
"""
from __future__ import annotations

import torch

from ..edge import canny_edges
from . import build


def canny_edges_cuda(gray: torch.Tensor, low: float = 10.0,
                     high: float = 100.0,
                     hysteresis_iters: int = 8) -> torch.Tensor:
    """NHW1 (or NHW) grayscale in [0, 255] -> {0, 255} NHW1 f32."""
    if gray.device.type == "cpu":
        return canny_edges(gray, low, high, hysteresis_iters)
    if not gray.is_cuda:
        raise ValueError(f"canny kernel: no kernel for device {gray.device}")
    x = gray[..., 0] if gray.dim() == 4 else gray
    if x.dim() != 3:
        raise ValueError(f"canny kernel: expected NHW1 or NHW, got "
                         f"{tuple(gray.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"canny kernel: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("canny kernel: input must be contiguous")
    lib = build.load("canny")
    if hysteresis_iters != lib.canny_iters():
        raise ValueError(f"canny kernel is built for {lib.canny_iters()} "
                         f"hysteresis rounds, got {hysteresis_iters}")
    n, h, w = x.shape
    out = torch.empty((n, h, w, 1), dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            build.check(lib.canny_forward(
                x.data_ptr(), out.data_ptr(), n, h, w, float(low),
                float(high), torch.cuda.current_stream().cuda_stream),
                "canny kernel")
        canny_edges_cuda.launches += 1
    return out


canny_edges_cuda.launches = 0
