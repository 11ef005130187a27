from .edge import canny_edges, image_to_gray255
from .filters import (
    conv2d_same,
    conv_tri,
    gradient_central_diff,
    gradient_magnitude_and_normal,
    triangle_kernel,
)
from .pooling import adaptive_pool2d, pooling_factor
from .resize import resize_bilinear, resize_nearest

__all__ = ["adaptive_pool2d", "canny_edges", "conv2d_same", "conv_tri",
           "gradient_central_diff", "gradient_magnitude_and_normal",
           "image_to_gray255", "pooling_factor", "resize_bilinear",
           "resize_nearest", "triangle_kernel"]
