"""Model factory (counterpart of saunet_tpu/models/__init__.py)."""
from __future__ import annotations

import torch

from .saunet import SAUNet
from .segmentation_module import SegmentationModule
from .torch_port import port_torch_saunet_state_dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_unet(num_class: int = 4, arch: str = "saunet",
               dtype: str = "float32", **kwargs) -> SAUNet:
    arch = arch.lower()
    if arch != "saunet":
        raise ValueError(f"Architecture undefined: {arch!r}")
    return SAUNet(num_classes=num_class, dtype=_DTYPES[dtype], **kwargs)


__all__ = ["SAUNet", "SegmentationModule", "build_unet",
           "port_torch_saunet_state_dict"]
