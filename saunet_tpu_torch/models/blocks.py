"""Building blocks of SAUNet, NCHW (counterpart of saunet_tpu/models/blocks.py).

Module and child names are the flax tree's (`Conv_0`, `BatchNorm_0`,
`mrf_up`, `c3x3`, ...), so the weight bridge (models/jax_weights.py) is a
one-to-one map of names. Parameters stay f32; convs compute in the dtype of
their input, as flax's `dtype=` does. Every ReLU that the JAX modules route
through their `act` field goes through the module's `act` attribute
(`F.relu`; interpret/saliency.py's guided model swaps it), and no other.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm2d


class Conv2d(nn.Conv2d):
    """'SAME' conv (stride 1, or conv0's explicit padding) computing in the
    input's dtype from f32 weights."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int | None = None, bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ConvTranspose(k=4, s=2, 'SAME'): the exact 2x upsampler, which
    is torch's (k=4, s=2, p=1) with the kernel flipped by the bridge."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=2, padding=1)


class ConvBNRelu(nn.Module):
    """Conv -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.act = F.relu
        self.Conv_0 = Conv2d(cin, features, kernel)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        return self.act(self.BatchNorm_0(self.Conv_0(x)))


class SEModule(nn.Module):
    """Squeeze-and-excite: global avgpool -> 1x1 reduce -> ReLU -> 1x1
    expand -> sigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.act = F.relu
        self.fc1 = Conv2d(channels, channels // reduction)
        self.fc2 = Conv2d(channels // reduction, channels)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(self.act(self.fc1(s)))
        return x * torch.sigmoid(s)


class SpatialAttentionBlock(nn.Module):
    """1x1 down-projection -> BN -> ReLU -> 1x1 to one channel -> sigmoid;
    returns the (N, 1, H, W) map."""

    def __init__(self, cin: int, attn_features: int):
        super().__init__()
        self.act = F.relu
        self.down = Conv2d(cin, attn_features, bias=False)
        self.BatchNorm_0 = BatchNorm2d(attn_features)
        self.phi = Conv2d(attn_features, 1)

    def forward(self, x):
        return torch.sigmoid(self.phi(self.act(self.BatchNorm_0(
            self.down(x)))))


class ConvTransposeBNRelu(nn.Module):
    """ConvTranspose 2x upsampler -> BN -> ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.act = F.relu
        self.ConvTranspose_0 = ConvTranspose2d(cin, features)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        return self.act(self.BatchNorm_0(self.ConvTranspose_0(x)))


class DualAttBlock(nn.Module):
    """Upsample the coarse input, concat the skip FIRST, 3x3 conv-BN-ReLU,
    then out = SE(x) * (1 + spatial(x)). Returns (out, spatial_map)."""

    def __init__(self, coarse_channels: int, skip_channels: int,
                 outchannels: int):
        super().__init__()
        self.act = F.relu
        self.mrf_up = ConvTransposeBNRelu(coarse_channels, coarse_channels)
        self.c3x3 = Conv2d(skip_channels + coarse_channels, outchannels, 3)
        self.BatchNorm_0 = BatchNorm2d(outchannels)
        self.spatialAttn = SpatialAttentionBlock(outchannels,
                                                 outchannels // 4)
        self.channelAttn = SEModule(outchannels, 16)

    def forward(self, coarse, skip):
        fused = torch.cat([skip, self.mrf_up(coarse)], dim=1)
        fused = self.act(self.BatchNorm_0(self.c3x3(fused)))
        spatial = self.spatialAttn(fused)
        channel = self.channelAttn(fused)
        return channel * (spatial + 1.0), spatial


class ResBasicBlock(nn.Module):
    """ResNet BasicBlock (stride 1, no downsample): the shape-stream
    residual unit."""

    def __init__(self, planes: int):
        super().__init__()
        self.act = F.relu
        self.conv1 = Conv2d(planes, planes, 3, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, bias=False)
        self.bn2 = BatchNorm2d(planes)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.act(out + x)


class GatedSpatialConv(nn.Module):
    """Shape-stream gate: alpha = gate_net(cat(shape_feat, texture_cue)),
    with BN on the (C+1)-channel concat; out = conv1x1 (no bias) of
    shape_feat * (1 + alpha). Returns (out, alpha)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.act = F.relu
        self.gate_bn1 = BatchNorm2d(cin + 1)
        self.gate_conv1 = Conv2d(cin + 1, cin + 1)
        self.gate_conv2 = Conv2d(cin + 1, 1)
        self.gate_bn2 = BatchNorm2d(1)
        self.conv = Conv2d(cin, features, bias=False)

    def forward(self, input_features, gating_features):
        cat = torch.cat([input_features, gating_features], dim=1)
        g = self.act(self.gate_conv1(self.gate_bn1(cat)))
        alpha = torch.sigmoid(self.gate_bn2(self.gate_conv2(g)))
        return self.conv(input_features * (alpha + 1.0)), alpha


class DecoderBlock(nn.Module):
    """conv3x3-BN-ReLU -> ConvTranspose 2x -> BN -> ReLU."""

    def __init__(self, cin: int, middle_channels: int, out_channels: int):
        super().__init__()
        self.conv = ConvBNRelu(cin, middle_channels, 3)
        self.up = ConvTransposeBNRelu(middle_channels, out_channels)

    def forward(self, x):
        return self.up(self.conv(x))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)
