"""Model factory (counterpart of saunet_tpu/models/__init__.py)."""
from __future__ import annotations

import torch

from .blocks import (
    ConvBNRelu,
    DecoderBlock,
    DualAttBlock,
    GatedSpatialConv,
    HighFrequencyGatedSpatialConv,
    ResBasicBlock,
    SEBottleneck,
    SEModule,
    SEResNetBottleneck,
    SpatialAttentionBlock,
)
from .densenet import DenseNetEncoder
from .resnet import (
    BasicBlockStride,
    BottleneckBlock,
    ResNet,
    port_resnet_state_dict,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
)
from .saunet import SAUNet
from .segmentation_module import SegmentationModule
from .torch_port import port_torch_saunet_state_dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_unet(num_class: int = 4, arch: str = "saunet",
               dtype: str = "float32", **kwargs) -> SAUNet:
    """The JAX `build_unet`'s surface: SAUNet's keywords (`act`,
    `edge_kernel`, `stream_impl`, `encoder_concat`, `remat`, ...) pass
    through."""
    arch = arch.lower()
    if arch != "saunet":
        raise ValueError(f"Architecture undefined: {arch!r}")
    return SAUNet(num_classes=num_class, dtype=_DTYPES[dtype], **kwargs)


__all__ = [
    "SAUNet", "SegmentationModule", "build_unet", "DenseNetEncoder",
    "port_torch_saunet_state_dict",
    "ConvBNRelu", "DecoderBlock", "DualAttBlock", "GatedSpatialConv",
    "HighFrequencyGatedSpatialConv", "ResBasicBlock", "SEBottleneck",
    "SEModule", "SEResNetBottleneck", "SpatialAttentionBlock",
    "BasicBlockStride", "BottleneckBlock", "ResNet",
    "port_resnet_state_dict", "resnet18", "resnet34", "resnet50",
    "resnet101",
]
