"""ResNet backbone family, NCHW (counterpart of saunet_tpu/models/resnet.py).

The deep-stem trunk (three 3x3 stem convs) with its stage taps c1..c5,
BasicBlockStride and BottleneckBlock, and resnet18/34/50/101. SAUNet does
not use them; they complete the model inventory. Module names are the flax
tree's (`stem_conv1`, `layer2_block1.down_bn`, ...), so
`jax_weights.from_jax_variables` maps a JAX ResNet's variables one to one,
and `port_resnet_state_dict` maps an MIT-CSAIL/torchvision state_dict onto
them. Convs are flax's 'SAME' (`SameConv2d`: at stride 2 the padding is
uneven, one more below and right), the stem's max pool likewise.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm2d


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding (before, after) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    (t, b), (l, r) = (same_pads(x.shape[2], kernel, stride),
                      same_pads(x.shape[3], kernel, stride))
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


class SameConv2d(nn.Conv2d):
    """flax `nn.Conv(padding='SAME')` at any stride, with groups, computing
    in the input's dtype from f32 weights."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(pad_same(x, self.kernel_size[0], self.stride[0]),
                        self.weight.to(x.dtype), b, self.stride, 0, 1,
                        self.groups)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.max_pool(x, (3, 3), strides=(2, 2), padding='SAME')`."""
    return F.max_pool2d(pad_same(x, 3, 2, float("-inf")), 3, 2)


class BasicBlockStride(nn.Module):
    """BasicBlock with optional stride and downsample (the stride-1
    shape-stream unit is blocks.ResBasicBlock)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.act = F.relu
        self.conv1 = SameConv2d(cin, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = SameConv2d(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        if downsample:
            self.down_conv = SameConv2d(cin, planes, 1, stride)
            self.down_bn = BatchNorm2d(planes)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.down_bn(self.down_conv(x)) \
            if hasattr(self, "down_conv") else x
        return self.act(out + residual)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.act = F.relu
        self.conv1 = SameConv2d(cin, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = SameConv2d(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = SameConv2d(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        if downsample:
            self.down_conv = SameConv2d(cin, planes * 4, 1, stride)
            self.down_bn = BatchNorm2d(planes * 4)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.act(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.down_bn(self.down_conv(x)) \
            if hasattr(self, "down_conv") else x
        return self.act(out + residual)


class ResNet(nn.Module):
    """Deep-stem ResNet trunk: NCHW image -> stage taps (c1, ..., c5).
    `dtype` is the compute dtype (parameters stay f32); `act` the ReLU of
    every block and of the stem."""

    def __init__(self, block: type = BasicBlockStride,
                 layers: Sequence[int] = (2, 2, 2, 2), in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 act: Callable = F.relu):
        super().__init__()
        self.dtype = dtype
        cin = in_channels
        for i, (f, s) in enumerate([(64, 2), (64, 1), (128, 1)], 1):
            setattr(self, f"stem_conv{i}", SameConv2d(cin, f, 3, s))
            setattr(self, f"stem_bn{i}", BatchNorm2d(f))
            cin = f
        self.stages = []
        planes = 64
        for stage, n_blocks in enumerate(layers, 1):
            stride = 1 if stage == 1 else 2
            names = []
            for b in range(n_blocks):
                down = b == 0 and (stride != 1
                                   or cin != planes * block.expansion)
                name = f"layer{stage}_block{b + 1}"
                setattr(self, name, block(cin, planes, stride if b == 0
                                          else 1, down))
                names.append(name)
                cin = planes * block.expansion
            self.stages.append(names)
            planes *= 2
        from .blocks import set_act  # blocks imports this module

        self.act = act
        set_act(self, act)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.to(self.dtype)
        for i in (1, 2, 3):
            x = self.act(getattr(self, f"stem_bn{i}")(
                getattr(self, f"stem_conv{i}")(x)))
        c1 = x
        x = max_pool_3x3_s2(x)
        taps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        return (c1, *taps)


def resnet18(**kw) -> ResNet:
    return ResNet(block=BasicBlockStride, layers=(2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(block=BasicBlockStride, layers=(3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(block=BottleneckBlock, layers=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(block=BottleneckBlock, layers=(3, 4, 23, 3), **kw)


def _port_name(name: str):
    m = re.match(r"^conv([123])\.weight$", name)
    if m:
        return f"stem_conv{m.group(1)}.weight"
    m = re.match(r"^bn([123])\.(\w+)$", name)
    if m:
        return f"stem_bn{m.group(1)}.{m.group(2)}"
    m = re.match(r"^layer(\d+)\.(\d+)\.(.+)$", name)
    if not m:
        return None  # the fc head
    block = f"layer{m.group(1)}_block{int(m.group(2)) + 1}"
    rest = m.group(3)
    rest = re.sub(r"^downsample\.0\.", "down_conv.", rest)
    rest = re.sub(r"^downsample\.1\.", "down_bn.", rest)
    return f"{block}.{rest}"


def port_resnet_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """An MIT-CSAIL/torchvision deep-stem ResNet `state_dict` (name ->
    tensor or numpy array, OIHW conv kernels) -> this trunk's state_dict
    (the counterpart of the JAX `port_resnet_state_dict`, which maps the
    same names onto the flax tree):

      conv1..3 / bn1..3                 -> stem_conv1..3 / stem_bn1..3
      layerS.B.convK / .bnK             -> layerS_block{B+1}.convK / .bnK
      layerS.B.downsample.0 / .1        -> layerS_block{B+1}.down_conv / _bn

    The classifier head (fc.*) is dropped. Load the result with
    `load_state_dict(..., strict=True)` to catch a key left over or
    missing."""
    out = {}
    for name, v in state_dict.items():
        port = _port_name(name)
        if port is not None:
            out[port] = torch.as_tensor(v)
    return out
