"""DenseNet-121 feature encoder, NCHW (counterpart of
saunet_tpu/models/densenet.py).

Two quirks of SAUNet's use of torchvision's densenet121 are kept:
  * stage 1 is conv0 + norm0 only: no relu0 and no pool0, so denseblock1
    runs at H/2;
  * f5 is denseblock4 + norm5 with no trailing ReLU.
The taps f2..f4 are the transition outputs after their 2x2 average pool.

A dense block stores its growing concat in one of the JAX package's three
train layouts (`concat_mode`), each the same math over the same parameter
names, so the weight bridge, `fold_encoder` and the eval kernel do not
depend on it:

  * 'chain': a new concat a layer (`torch.cat`);
  * 'buffer': one preallocated (N, Cmax, H, W) buffer; each layer reads
    the live prefix as a view and its output is written behind it. The
    writes go around autograd (channels are never written twice, so a
    prefix saved for the backward keeps its values), and `_Prefix` routes
    each prefix's gradient to the pieces written into it;
  * 'fused': the residual-lean autograd Function of
    ops/dense_block_train.py (only the final buffer saved; the layers
    recomputed one at a time in the backward); in eval mode, and so under
    `--fix_bn`, its `dense_block_eval`.

`DenseNetEncoder(remat=True)` rematerialises each dense block
(`torch.utils.checkpoint`): its activations are recomputed in the backward
instead of kept, and its BatchNorms' running statistics move once a step
(`norm.frozen_running_stats` around the recompute).

The module names are torchvision's, so `load_pretrained_encoder` maps a
densenet121 state_dict by name. Under `blocks.partition_space` conv0 (7x7,
stride 2: 3 rows above and 2 below), the 3x3 convs and the transitions'
pools read across the 'space' shard borders; BatchNorm reduces over the
grid, in every layout.
"""
from __future__ import annotations

import contextlib
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import dense_block_train as block_train
from ..utils.config import BN_EPS
from .blocks import Conv2d, pool_2x2
from .norm import BatchNorm2d, frozen_running_stats

DENSENET121_BLOCKS = (6, 12, 24, 16)
GROWTH_RATE = 32
BN_SIZE = 4
NUM_INIT_FEATURES = 64
CONCAT_MODES = ("chain", "buffer", "fused")


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


class _Prefix(torch.autograd.Function):
    """`buf[:, :C]` as a function of the pieces written into its channels
    [0, C) in order: the backward hands each piece its slice of the
    gradient. `buf` itself carries no gradient."""

    @staticmethod
    def forward(ctx, buf, *pieces):
        ctx.widths = [p.shape[1] for p in pieces]
        return buf[:, :sum(ctx.widths)]

    @staticmethod
    def backward(ctx, grad):
        return (None, *torch.split(grad, ctx.widths, dim=1))


class DenseBlock(nn.Module):
    """`num_layers` DenseLayers over a growing channel concat, stored as
    `concat_mode` says (module docstring)."""

    def __init__(self, cin: int, num_layers: int, concat_mode: str = "chain"):
        super().__init__()
        if concat_mode not in CONCAT_MODES:
            raise ValueError(f"concat_mode must be one of {CONCAT_MODES}, "
                             f"got {concat_mode!r}")
        self.concat_mode = concat_mode
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(cin + i * GROWTH_RATE))

    def forward(self, x):
        if self.concat_mode == "buffer":
            return self._forward_buffer(x)
        if self.concat_mode == "fused":
            return self._forward_fused(x)
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x

    def _forward_buffer(self, x):
        layers = list(self.children())
        c0 = x.shape[1]
        buf = block_train.new_buffer(x, c0 + len(layers) * GROWTH_RATE)
        # `.data` has a version counter of its own: the writes do not mark
        # the prefixes saved for the backward as modified
        store = buf.data
        store[:, :c0] = x.detach()
        pieces = [x]
        for i, layer in enumerate(layers):
            cl = c0 + i * GROWTH_RATE
            new = layer(_Prefix.apply(buf, *pieces))
            store[:, cl:cl + GROWTH_RATE] = new.detach()
            pieces.append(new)
        return _Prefix.apply(buf, *pieces)

    def _forward_fused(self, x):
        layers = list(self.children())
        first = layers[0]
        cfg = block_train.Config(BN_EPS, first.norm1.group, first.conv2.space,
                                 first.act)
        weights = [(l.norm1.weight, l.norm1.bias, l.conv1.weight,
                    l.norm2.weight, l.norm2.bias, l.conv2.weight)
                   for l in layers]
        if not first.norm1.training:
            running = [(l.norm1.running_mean, l.norm1.running_var,
                        l.norm2.running_mean, l.norm2.running_var)
                       for l in layers]
            return block_train.dense_block_eval(x, weights, running, cfg)
        buf, (mu1, var1, mu2, var2) = block_train.dense_block_train(
            x, weights, cfg)
        c0 = x.shape[1]
        with torch.no_grad():
            for i, l in enumerate(layers):
                cl = c0 + i * GROWTH_RATE
                l.norm1.update_running(mu1[:cl], var1[:cl])
                l.norm2.update_running(mu2[i], var2[i])
        return buf


@contextlib.contextmanager
def _restored(settings):
    """Within the block each (module, attribute, value) of `settings` holds
    its value again."""
    now = [(m, name, getattr(m, name)) for m, name, _ in settings]
    for m, name, value in settings:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in now:
            setattr(m, name, value)


def rematerialised(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` with its activations recomputed in the backward. The
    recompute runs after `sync_batch_norm` and `partition_space` have
    left, so it runs under the process group and 'space' shard that the
    forward saw, and it leaves the running statistics as the forward set
    them."""
    settings = [(m, name, getattr(m, name)) for m in block.modules()
                for name in ("group", "space") if hasattr(type(m), name)]
    done = []

    def run(x):
        if not done:
            done.append(True)
            return block(x)
        with _restored(settings), frozen_running_stats(block):
            return block(x)

    return checkpoint(run, x, use_reentrant=False)


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
    NCHW in and out; `concat_mode` is every dense block's layout, `remat`
    rematerialises each dense block when gradients are taken."""

    def __init__(self, block_config=DENSENET121_BLOCKS, remat: bool = False,
                 concat_mode: str = "chain"):
        super().__init__()
        self.block_config = tuple(block_config)
        self.remat = remat
        self.conv0 = Conv2d(3, NUM_INIT_FEATURES, 7, stride=2, padding=3,
                            bias=False)
        self.norm0 = BatchNorm2d(NUM_INIT_FEATURES)
        features = NUM_INIT_FEATURES
        for i, num_layers in enumerate(self.block_config):
            self.add_module(f"denseblock{i + 1}",
                            DenseBlock(features, num_layers, concat_mode))
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
        remat = self.remat and torch.is_grad_enabled()
        for i in range(len(self.block_config)):
            block = getattr(self, f"denseblock{i + 1}")
            h = rematerialised(block, h) if remat else block(h)
            if i != len(self.block_config) - 1:
                h = getattr(self, f"transition{i + 1}")(h)
                taps.append(h)
        f2, f3, f4 = taps
        return f1, f2, f3, f4, self.norm5(h)


def load_pretrained_encoder(path: str, model: nn.Module) -> nn.Module:
    """Load torchvision densenet121 ImageNet weights (`features.*` of a
    torch .pth state_dict, or the .npz that
    `saunet_tpu_torch.cli.ingest_pretrained` writes) into `model.encoder`;
    returns `model`.

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


def torchvision_state_dict(encoder: nn.Module) -> dict:
    """`encoder`'s weights, on the CPU, under the names of torchvision's
    densenet121 hub file (`densenet121-a639ec97.pth`), the names that
    `load_pretrained_encoder` maps back: the `features.` prefix, the dense
    layers' legacy `norm.1`-style names, no BatchNorm batch counters, and
    the file's 1000-way classifier (zeros), which the graft ignores."""
    sd = {}
    for k, v in encoder.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if ".denselayer" in k:
            k = re.sub(r"\.(norm|conv)([12])\.", r".\1.\2.", k)
        sd["features." + k] = v.detach().cpu().clone()
    sd["classifier.weight"] = torch.zeros(1000, encoder.norm5.num_features)
    sd["classifier.bias"] = torch.zeros(1000)
    return sd
