"""Building blocks of SAUNet, NCHW (counterpart of saunet_tpu/models/blocks.py).

Module and child names are the flax tree's (`Conv_0`, `BatchNorm_0`,
`mrf_up`, `c3x3`, ...), so the weight bridge (models/jax_weights.py) is a
one-to-one map of names. Parameters stay f32; convs compute in the dtype of
their input, as flax's `dtype=` does. Every ReLU that the JAX modules route
through their `act` field goes through the module's `act` attribute
(`F.relu`; interpret/saliency.py's guided model swaps it), and no other.

The 'space' axis: inside `partition_space(model, mesh, height)` every
module with a `space` attribute holds the rank's `SpaceShard`
(parallel/mesh.py), and the input's image H axis is split over the ranks
of the mesh's 'space' group, each holding `rows(level)` of every level.
Each op that reads across a shard border then fetches the rows it reads by
their global indices (`SpaceShard.fetch`, a differentiable exchange) and
computes exactly the rows the one-process op computes: the k x k convs
(`conv2d_rows`: a (k-1)/2-row halo, conv0's 3 above and 2 below), the
transposed conv (a 1-row halo, the output cropped to the rank's rows), the
2x2 pools (`pool_2x2`, a row of the neighbour where the split is odd) and
the squeeze-and-excite mean (`mean_hw`, an all-reduce of the sum and the
pixel count). Without a mesh nothing of this runs.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from .norm import BatchNorm2d
from .resnet import SameConv2d


@contextlib.contextmanager
def partition_space(model: nn.Module, mesh, height: int):
    """Within the block, every module of `model` with a `space` attribute
    computes its rows of an input of `height` global rows split over the
    'space' axis of `mesh` (a parallel.DataMesh): the counterpart of
    sharding a batch's H axis over 'space'. `mesh` None or without a
    'space' axis changes nothing."""
    shard = None if mesh is None else mesh.space_shard(height)
    if shard is None:
        yield model
        return
    parts = [m for m in model.modules() if hasattr(type(m), "space")]
    for m in parts:
        m.space = shard
    try:
        yield model
    finally:
        for m in parts:
            m.space = None


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, padding,
                space) -> torch.Tensor:
    """This rank's rows of a k x k conv (zero padding `padding`) of the
    level `x` holds rows of: the rows each output row reads, fetched by
    their global index (zeros beyond the level), convolved without H
    padding."""
    k, (ph, pw) = weight.shape[2], padding
    h = space.level(x.shape[2])
    ho = (h + 2 * ph - k) // stride + 1
    window = space.fetch(x, h, ho, lambda lo, hi: (lo * stride - ph,
                                                   (hi - 1) * stride - ph + k))
    return F.conv2d(window, weight, bias, stride, (0, pw))


def conv_transpose2d_rows(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, space) -> torch.Tensor:
    """This rank's rows of the (k 4, stride 2, padding 1) transposed conv
    of a level of h rows: output row o reads input rows (o - 2) // 2 + 1
    .. (o + 1) // 2, so the rank's rows [lo, hi) read [(lo - 1) // 2,
    hi // 2 + 1); without H padding, window row 0 lands on output row
    2 * ((lo - 1) // 2) - 1."""
    h = space.level(x.shape[2])
    lo, hi = space.rows(2 * h)
    window = space.fetch(x, h, 2 * h,
                         lambda lo, hi: ((lo - 1) // 2, hi // 2 + 1))
    y = F.conv_transpose2d(window, weight, bias, stride=2, padding=(0, 1))
    start = lo - 2 * ((lo - 1) // 2) + 1
    return y[:, :, start:start + hi - lo]


def pool_2x2(x: torch.Tensor, pool: Callable, space=None) -> torch.Tensor:
    """`pool(x, 2)` (max or average, floor mode); on the 'space' axis, the
    input rows 2 lo .. 2 hi - 1 of the rank's output rows [lo, hi)."""
    if space is None:
        return pool(x, 2)
    h = space.level(x.shape[2])
    return pool(space.fetch(x, h, h // 2, lambda lo, hi: (2 * lo, 2 * hi)),
                2)


def mean_hw(x: torch.Tensor, space=None) -> torch.Tensor:
    """The (N, C, 1, 1) mean over H and W; on the 'space' axis the f32 sum
    and the pixel count summed over the ranks (shards can be uneven, so
    local means are not averaged), then cast to x's dtype."""
    if space is None:
        return x.mean(dim=(2, 3), keepdim=True)
    n, c = x.shape[:2]
    local = torch.cat([x.float().sum(dim=(2, 3)).reshape(-1),
                       x.new_full((1,), x.shape[2] * x.shape[3],
                                  dtype=torch.float32)])
    total = all_reduce_sum(local, space.group)
    return (total[:-1] / total[-1]).reshape(n, c, 1, 1).to(x.dtype)


def set_act(model: nn.Module, act: Callable) -> None:
    """Make `act` the `act` of every module of `model` that has one (the
    JAX modules' `act` field, passed down to every submodule)."""
    for m in model.modules():
        if hasattr(m, "act"):
            m.act = act


class Conv2d(nn.Conv2d):
    """'SAME' conv (stride 1, or conv0's explicit padding) computing in the
    input's dtype from f32 weights."""

    space = None

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int | None = None, bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight.to(x.dtype)
        if self.space is None or self.kernel_size[0] == self.stride[0] == 1:
            return self._conv_forward(x, w, b)
        return conv2d_rows(x, w, b, self.stride[0], self.padding,
                           self.space)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ConvTranspose(k=4, s=2, 'SAME'): the exact 2x upsampler, which
    is torch's (k=4, s=2, p=1) with the kernel flipped by the bridge."""

    space = None

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.space is None:
            return F.conv_transpose2d(x, w, b, stride=2, padding=1)
        return conv_transpose2d_rows(x, w, b, self.space)


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

    space = None

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.act = F.relu
        self.fc1 = Conv2d(channels, channels // reduction)
        self.fc2 = Conv2d(channels // reduction, channels)

    def forward(self, x):
        s = mean_hw(x, self.space)
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


def max_pool_2x2(x: torch.Tensor, space=None) -> torch.Tensor:
    return pool_2x2(x, F.max_pool2d, space)


class SEBottleneck(nn.Module):
    """SENet-154-style bottleneck, squeeze-and-excite before the residual
    add (unused by SAUNet; inventory parity). 'SAME' convs
    (resnet.SameConv2d), conv2 grouped and strided."""

    def __init__(self, cin: int, planes: int, groups: int = 1,
                 reduction: int = 16, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.act = F.relu
        self.conv1 = SameConv2d(cin, planes * 2, 1)
        self.bn1 = BatchNorm2d(planes * 2)
        self.conv2 = SameConv2d(planes * 2, planes * 4, 3, stride, groups)
        self.bn2 = BatchNorm2d(planes * 4)
        self.conv3 = SameConv2d(planes * 4, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        if downsample:
            self.down_conv = SameConv2d(cin, planes * 4, 1, stride)
            self.down_bn = BatchNorm2d(planes * 4)
        self.se_module = SEModule(planes * 4, reduction)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.act(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.down_bn(self.down_conv(x)) \
            if hasattr(self, "down_conv") else x
        return self.act(self.se_module(out) + residual)


class SEResNetBottleneck(nn.Module):
    """Caffe-style SE-ResNet bottleneck, the stride in conv1 (unused by
    SAUNet; inventory parity)."""

    def __init__(self, cin: int, planes: int, groups: int = 1,
                 reduction: int = 16, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.act = F.relu
        self.conv1 = SameConv2d(cin, planes, 1, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = SameConv2d(planes, planes, 3, 1, groups)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = SameConv2d(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        if downsample:
            self.down_conv = SameConv2d(cin, planes * 4, 1, stride)
            self.down_bn = BatchNorm2d(planes * 4)
        self.se_module = SEModule(planes * 4, reduction)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.act(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.down_bn(self.down_conv(x)) \
            if hasattr(self, "down_conv") else x
        return self.act(self.se_module(out) + residual)


def gaussian_kernel7(sigma: float = 3.0) -> torch.Tensor:
    """The normalised 7x7 Gaussian (f64 math, f32 result)."""
    ax = torch.arange(7, dtype=torch.float64)
    g = torch.exp(-((ax - 3.0) ** 2) / (2 * sigma ** 2))
    k = torch.outer(g, g)
    return (k / k.sum()).float()


class HighFrequencyGatedSpatialConv(nn.Module):
    """Difference-of-Gaussian shape-stream gate (unused by SAUNet;
    inventory parity): a frozen 7x7, sigma 3 depthwise Gaussian blur
    ('SAME', zero padding) leaves the high frequencies (x - blur(x)),
    which a 1x1 conv (`cw`) mixes with x; they are gated as in
    GatedSpatialConv by the concat of x and the `gate_channels` gating
    features. Returns the (N, features, H, W) output."""

    def __init__(self, cin: int, features: int, gate_channels: int = 1):
        super().__init__()
        self.act = F.relu
        cat = cin + gate_channels
        self.register_buffer("blur", gaussian_kernel7().expand(
            cin, 1, 7, 7).contiguous(), persistent=False)
        self.cw = Conv2d(2 * cin, cin)
        self.gate_bn1 = BatchNorm2d(cat)
        self.gate_conv1 = Conv2d(cat, cat)
        self.gate_conv2 = Conv2d(cat, 1)
        self.gate_bn2 = BatchNorm2d(1)
        self.conv = Conv2d(cin, features, bias=False)

    def forward(self, input_features, gating_features):
        x = input_features
        smooth = F.conv2d(x, self.blur.to(x.dtype), padding=3,
                          groups=x.shape[1])
        dog = self.cw(torch.cat([x - smooth, x], dim=1))
        cat = torch.cat([x, gating_features], dim=1)
        g = self.act(self.gate_conv1(self.gate_bn1(cat)))
        alpha = torch.sigmoid(self.gate_bn2(self.gate_conv2(g)))
        return self.conv(dog * (alpha + 1.0))
