"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Counterpart of saunet_tpu/ops/pallas/. Each wrapper runs its kernel for a
CUDA tensor (or raises) and its plain PyTorch version for a CPU tensor, and
counts its kernel launches in `<wrapper>.launches`.
"""
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

__all__ = ["KERNELS", "canny_edges_cuda", "dense_block",
           "dense_block_plain", "fold_dense_block_params",
           "fold_shape_stream_params", "gather_image", "gather_image_plain",
           "resample", "resample_plain", "shape_stream_fused",
           "shape_stream_plain", "warp_image_label",
           "warp_image_label_plain"]
