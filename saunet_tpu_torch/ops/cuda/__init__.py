"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Counterpart of saunet_tpu/ops/pallas/. Each wrapper runs its kernel for a
CUDA tensor (or raises) and its plain PyTorch version for a CPU tensor, and
counts its kernel launches in `<wrapper>.launches` (`launches()` reads
them all, `zero_launches()` zeroes them).
"""
from typing import Dict

from .canny import canny_edges_cuda
from .dense_block import dense_block, dense_block_plain, fold_dense_block_params
from .shape_stream import (
    fold_shape_stream_params,
    shape_stream_fused,
    shape_stream_plain,
)
from .warp import (
    gather_image,
    gather_image_plain,
    resample,
    resample_plain,
    warp_image_label,
    warp_image_label_plain,
)

KERNELS = (canny_edges_cuda, dense_block, gather_image, resample,
           shape_stream_fused, warp_image_label)


def launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count, by the wrapper's name."""
    return {k.__name__: k.launches for k in KERNELS}


def zero_launches() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "canny_edges_cuda", "dense_block",
           "dense_block_plain", "fold_dense_block_params",
           "fold_shape_stream_params", "gather_image", "gather_image_plain",
           "launches", "resample", "resample_plain", "shape_stream_fused",
           "shape_stream_plain", "warp_image_label",
           "warp_image_label_plain", "zero_launches"]
