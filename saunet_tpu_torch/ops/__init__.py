from .edge import canny_edges, image_to_gray255
from .resize import resize_bilinear

__all__ = ["canny_edges", "image_to_gray255", "resize_bilinear"]
