"""DenseNet-121 feature encoder, NCHW (counterpart of
saunet_tpu/models/densenet.py).

Two quirks of SAUNet's use of torchvision's densenet121 are kept:
  * stage 1 is conv0 + norm0 only: no relu0 and no pool0, so denseblock1
    runs at H/2;
  * f5 is denseblock4 + norm5 with no trailing ReLU.
The taps f2..f4 are the transition outputs after their 2x2 average pool.

The dense blocks concatenate layer by layer (the JAX package's 'chain'
layout, its default); its 'buffer' and 'fused' layouts store the same math
differently for the TPU and are not ported. The module names are
torchvision's, so `load_pretrained_encoder` maps a densenet121 state_dict
by name. Under `blocks.partition_space` conv0 (7x7, stride 2: 3 rows
above and 2 below), the 3x3 convs and the transitions' pools read across
the 'space' shard borders; BatchNorm reduces over the grid.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, pool_2x2
from .norm import BatchNorm2d

DENSENET121_BLOCKS = (6, 12, 24, 16)
GROWTH_RATE = 32
BN_SIZE = 4
NUM_INIT_FEATURES = 64


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1(bn_size*k) -> BN-ReLU-Conv3x3(k); returns the new
    features to concatenate."""

    def __init__(self, cin: int):
        super().__init__()
        self.act = F.relu
        hidden = BN_SIZE * GROWTH_RATE
        self.norm1 = BatchNorm2d(cin)
        self.conv1 = Conv2d(cin, hidden, bias=False)
        self.norm2 = BatchNorm2d(hidden)
        self.conv2 = Conv2d(hidden, GROWTH_RATE, 3, bias=False)

    def forward(self, x):
        h = self.conv1(self.act(self.norm1(x)))
        return self.conv2(self.act(self.norm2(h)))


class DenseBlock(nn.Module):
    """`num_layers` DenseLayers over a growing channel concat."""

    def __init__(self, cin: int, num_layers: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(cin + i * GROWTH_RATE))

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class Transition(nn.Module):
    """BN-ReLU-Conv1x1(out) -> AvgPool 2x2 (on the 'space' axis, with the
    neighbour's row where a level's rows split oddly)."""

    space = None

    def __init__(self, cin: int, out_features: int):
        super().__init__()
        self.act = F.relu
        self.norm = BatchNorm2d(cin)
        self.conv = Conv2d(cin, out_features, bias=False)

    def forward(self, x):
        return pool_2x2(self.conv(self.act(self.norm(x))), F.avg_pool2d,
                        self.space)


class DenseNetEncoder(nn.Module):
    """DenseNet-121 trunk exposing the five SAUNet feature taps (f1..f5),
    NCHW in and out."""

    def __init__(self, block_config=DENSENET121_BLOCKS):
        super().__init__()
        self.block_config = tuple(block_config)
        self.conv0 = Conv2d(3, NUM_INIT_FEATURES, 7, stride=2, padding=3,
                            bias=False)
        self.norm0 = BatchNorm2d(NUM_INIT_FEATURES)
        features = NUM_INIT_FEATURES
        for i, num_layers in enumerate(self.block_config):
            self.add_module(f"denseblock{i + 1}",
                            DenseBlock(features, num_layers))
            features += num_layers * GROWTH_RATE
            if i != len(self.block_config) - 1:
                self.add_module(f"transition{i + 1}",
                                Transition(features, features // 2))
                features //= 2
        self.norm5 = BatchNorm2d(features)

    def blocks(self):
        return [getattr(self, f"denseblock{i + 1}")
                for i in range(len(self.block_config))]

    def forward(self, x):
        f1 = self.norm0(self.conv0(x))
        h, taps = f1, []
        for i in range(len(self.block_config)):
            h = getattr(self, f"denseblock{i + 1}")(h)
            if i != len(self.block_config) - 1:
                h = getattr(self, f"transition{i + 1}")(h)
                taps.append(h)
        f2, f3, f4 = taps
        return f1, f2, f3, f4, self.norm5(h)


def load_pretrained_encoder(path: str, model: nn.Module) -> nn.Module:
    """Load torchvision densenet121 ImageNet weights (`features.*` of a
    torch .pth state_dict, or the .npz of tools/convert_torchvision.py)
    into `model.encoder`; returns `model`.

    Legacy `norm.1`-style names are re-joined; the classifier is ignored.
    Every encoder entry must be present with its shape (BN batch counters
    excepted, which old checkpoints lack)."""
    if path.endswith(".npz"):
        raw = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in raw:
            raw = raw["state_dict"]
    encoder = model.encoder
    sd = {}
    for name, v in raw.items():
        if not name.startswith("features."):
            continue
        name = re.sub(r"\.(norm|relu|conv)\.(\d+)\.", r".\1\2.",
                      name[len("features."):])
        sd[name] = torch.as_tensor(v)
    want = encoder.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
    encoder.load_state_dict(sd, strict=True)
    return model
