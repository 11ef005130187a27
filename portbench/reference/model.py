"""The plain reference SAUNet: float32 PyTorch, no kernels, no batching
tricks, written from the published architecture (arXiv 2001.07645 and its
code's models/saunet.py) in the layout the port's weights use.

Parameter and buffer names are the port's (`encoder.denseblock1.
denselayer1.conv1.weight`, `dec5.mrf_up.ConvTranspose_0.weight`, ...), so
one state dict made by the benchmark loads into both. Nothing here imports
the port.

    encoder  DenseNet-121 (blocks 6, 12, 24, 16; growth 32; bn_size 4),
             conv0 7x7/2 + norm0 (no relu0, no pool0), f2..f4 the
             transitions' pooled outputs, f5 = norm5(denseblock4)
    stream   d0(f2) resized to full size -> res1 -> d1 -> gate1(c3(f3))
             -> res2 -> d2 -> gate2(c4(f4)) -> res3 -> d3 -> gate3(c5(f5))
             -> fuse -> sigmoid: the edge map
    edge cue Canny of the image's gray (Sobel, NMS, double threshold 10 /
             100, 8 hysteresis rounds), fused with the edge map by `cw`,
             expanded by `expand`
    decoder  center(maxpool f5), four dual-attention blocks, dec1, dec0
             over [dec1, edge], the 1x1 head

BatchNorm follows flax: statistics in f32, biased variance. `set_mode`
picks how it normalises: 'eval' (running statistics) or 'calibrate' (the
batch's, which then become the running statistics). `set_mode(cast=...)`
rounds the operands of every convolution to bfloat16 or float8 (e4m3, one
scale a tensor) before an f32 product: the benchmark's controls, the
reference in the precision below the configuration's.
`set_mode(input_dtype=...)` gives the network its input in the
configuration's type (a bfloat16 model takes the image, and Canny the
gray, from the image cast to bfloat16); everything after runs in float32.

`ARCHITECTURE` is what this module builds, in the configuration files'
keys; `SAUNet`'s arguments (classes, filters, Canny's thresholds) are what
a configuration may set besides.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BLOCKS = (6, 12, 24, 16)
GROWTH = 32
BN_SIZE = 4
INIT_FEATURES = 64
FP8_MAX = 448.0
RES_WIDTHS = (64, 32, 16)
DECODER_WIDTHS = (512, 256, 128, 64)
SE_REDUCTION = 16
HYSTERESIS_ROUNDS = 8

TAN225 = 0.4142135623730951
TAN675 = 2.414213562373095

#: the configuration files' keys of what this module builds
ARCHITECTURE = {
    "model": "SAUNet",
    "input_channels": 3,
    "encoder": {"arch": "densenet121", "block_config": list(BLOCKS),
                "growth_rate": GROWTH, "bn_size": BN_SIZE,
                "num_init_features": INIT_FEATURES, "pool0": False,
                "relu_after_norm5": False},
    "shape_stream": {"res_widths": list(RES_WIDTHS),
                     "gates": len(RES_WIDTHS), "edge_cue": "canny",
                     "hysteresis_rounds": HYSTERESIS_ROUNDS},
    "decoder": {"blocks": "dual_attention",
                "widths": list(DECODER_WIDTHS),
                "se_reduction": SE_REDUCTION},
    "batchnorm": {"eps": BN_EPS, "momentum_flax": 0.9},
}


def _rounded(x: torch.Tensor, cast: str) -> torch.Tensor:
    """`x` rounded to bfloat16, or to float8 e4m3 with one scale a
    tensor."""
    if cast == "bf16":
        return x.to(torch.bfloat16).float()
    if cast == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown operand cast {cast!r}")


def cast_operand(x: torch.Tensor, cast) -> torch.Tensor:
    """`x` rounded to the control's precision; `cast` None leaves it as
    it is."""
    return x if cast is None else _rounded(x, cast)


def eval_input(slices: torch.Tensor) -> torch.Tensor:
    """(N, H, W) slices -> (N, 3, H, W): per-slice z-score (biased std),
    three equal channels."""
    x = slices.float()
    mu = x.mean(dim=(1, 2), keepdim=True)
    sd = x.std(dim=(1, 2), keepdim=True, correction=0)
    x = (x - mu) / (sd + 1e-10)
    return x[:, None].expand(-1, 3, -1, -1)


class _Mode:
    """What every reference module reads: BatchNorm's mode, the operand
    cast, and the type the network's input is given in."""
    bn = "eval"
    cast = None
    input_dtype = torch.float32


def set_mode(model: nn.Module, bn=None, cast="keep", input_dtype=None):
    mode = model.mode
    if input_dtype is not None:
        mode.input_dtype = input_dtype
    if bn is not None:
        if bn not in ("eval", "calibrate"):
            raise ValueError(f"unknown BatchNorm mode {bn!r}")
        mode.bn = bn
    if cast != "keep":
        mode.cast = cast
    return model


class Conv(nn.Module):
    def __init__(self, mode, cin, cout, k=1, stride=1, padding=None,
                 bias=True):
        super().__init__()
        self.mode = mode
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        c = self.mode.cast
        return F.conv2d(cast_operand(x, c), cast_operand(self.weight, c),
                        self.bias, self.stride, self.padding)


class ConvT(nn.Module):
    """The exact 2x upsampler: transposed conv, kernel 4, stride 2,
    padding 1."""

    def __init__(self, mode, cin, cout):
        super().__init__()
        self.mode = mode
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        c = self.mode.cast
        return F.conv_transpose2d(cast_operand(x, c),
                                  cast_operand(self.weight, c), self.bias,
                                  stride=2, padding=1)


class BN(nn.Module):
    def __init__(self, mode, c):
        super().__init__()
        self.mode = mode
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.mode.bn == "eval":
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            if self.mode.bn == "calibrate":
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


class ConvBNRelu(nn.Module):
    def __init__(self, mode, cin, cout, k=3):
        super().__init__()
        self.Conv_0 = Conv(mode, cin, cout, k)
        self.BatchNorm_0 = BN(mode, cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class ConvTBNRelu(nn.Module):
    def __init__(self, mode, cin, cout):
        super().__init__()
        self.ConvTranspose_0 = ConvT(mode, cin, cout)
        self.BatchNorm_0 = BN(mode, cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class DenseLayer(nn.Module):
    def __init__(self, mode, cin):
        super().__init__()
        self.norm1 = BN(mode, cin)
        self.conv1 = Conv(mode, cin, BN_SIZE * GROWTH, bias=False)
        self.norm2 = BN(mode, BN_SIZE * GROWTH)
        self.conv2 = Conv(mode, BN_SIZE * GROWTH, GROWTH, 3, bias=False)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h)))


class DenseBlock(nn.Module):
    def __init__(self, mode, cin, layers):
        super().__init__()
        for i in range(layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(mode, cin + i * GROWTH))

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class Transition(nn.Module):
    def __init__(self, mode, cin, cout):
        super().__init__()
        self.norm = BN(mode, cin)
        self.conv = Conv(mode, cin, cout, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2)


class Encoder(nn.Module):
    def __init__(self, mode):
        super().__init__()
        self.conv0 = Conv(mode, 3, INIT_FEATURES, 7, stride=2, padding=3,
                          bias=False)
        self.norm0 = BN(mode, INIT_FEATURES)
        c = INIT_FEATURES
        for i, n in enumerate(BLOCKS):
            self.add_module(f"denseblock{i + 1}", DenseBlock(mode, c, n))
            c += n * GROWTH
            if i != len(BLOCKS) - 1:
                self.add_module(f"transition{i + 1}",
                                Transition(mode, c, c // 2))
                c //= 2
        self.norm5 = BN(mode, c)

    def forward(self, x):
        h = self.norm0(self.conv0(x))
        taps = []
        for i in range(len(BLOCKS)):
            h = getattr(self, f"denseblock{i + 1}")(h)
            if i != len(BLOCKS) - 1:
                h = getattr(self, f"transition{i + 1}")(h)
                taps.append(h)
        return (*taps, self.norm5(h))


class ResBlock(nn.Module):
    def __init__(self, mode, c):
        super().__init__()
        self.conv1 = Conv(mode, c, c, 3, bias=False)
        self.bn1 = BN(mode, c)
        self.conv2 = Conv(mode, c, c, 3, bias=False)
        self.bn2 = BN(mode, c)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class Gate(nn.Module):
    def __init__(self, mode, c):
        super().__init__()
        self.gate_bn1 = BN(mode, c + 1)
        self.gate_conv1 = Conv(mode, c + 1, c + 1)
        self.gate_conv2 = Conv(mode, c + 1, 1)
        self.gate_bn2 = BN(mode, 1)
        self.conv = Conv(mode, c, c, bias=False)

    def forward(self, feats, cue):
        g = F.relu(self.gate_conv1(self.gate_bn1(torch.cat([feats, cue], 1))))
        alpha = torch.sigmoid(self.gate_bn2(self.gate_conv2(g)))
        return self.conv(feats * (alpha + 1.0))


class SpatialAttn(nn.Module):
    def __init__(self, mode, cin, mid):
        super().__init__()
        self.down = Conv(mode, cin, mid, bias=False)
        self.BatchNorm_0 = BN(mode, mid)
        self.phi = Conv(mode, mid, 1)

    def forward(self, x):
        return torch.sigmoid(self.phi(F.relu(self.BatchNorm_0(self.down(x)))))


class SE(nn.Module):
    def __init__(self, mode, c, reduction=16):
        super().__init__()
        self.fc1 = Conv(mode, c, c // reduction)
        self.fc2 = Conv(mode, c // reduction, c)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class DualAtt(nn.Module):
    def __init__(self, mode, coarse, skip, out):
        super().__init__()
        self.mrf_up = ConvTBNRelu(mode, coarse, coarse)
        self.c3x3 = Conv(mode, skip + coarse, out, 3)
        self.BatchNorm_0 = BN(mode, out)
        self.spatialAttn = SpatialAttn(mode, out, out // 4)
        self.channelAttn = SE(mode, out, SE_REDUCTION)

    def forward(self, coarse, skip):
        x = torch.cat([skip, self.mrf_up(coarse)], dim=1)
        x = F.relu(self.BatchNorm_0(self.c3x3(x)))
        return self.channelAttn(x) * (self.spatialAttn(x) + 1.0)


class Decoder(nn.Module):
    def __init__(self, mode, cin, mid, out):
        super().__init__()
        self.conv = ConvBNRelu(mode, cin, mid, 3)
        self.up = ConvTBNRelu(mode, mid, out)

    def forward(self, x):
        return self.up(self.conv(x))


def _shift(x, dy, dx):
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def canny(gray: torch.Tensor, low=10.0, high=100.0,
          rounds=HYSTERESIS_ROUNDS):
    """(N, H, W) gray in [0, 255] -> (N, H, W) edges in {0, 255}."""
    g = gray.float()
    n, s, e, w_ = _shift(g, 1, 0), _shift(g, -1, 0), _shift(g, 0, -1), \
        _shift(g, 0, 1)
    ne, nw, se, sw = _shift(g, 1, -1), _shift(g, 1, 1), _shift(g, -1, -1), \
        _shift(g, -1, 1)
    gx = (ne + 2.0 * e + se) - (nw + 2.0 * w_ + sw)
    gy = (sw + 2.0 * s + se) - (nw + 2.0 * n + ne)
    mag = gx.abs() + gy.abs()
    ax, ay = gx.abs(), gy.abs()
    keep_h = (mag >= _shift(mag, 0, 1)) & (mag >= _shift(mag, 0, -1))
    keep_v = (mag >= _shift(mag, 1, 0)) & (mag >= _shift(mag, -1, 0))
    keep_d1 = (mag >= _shift(mag, 1, 1)) & (mag >= _shift(mag, -1, -1))
    keep_d2 = (mag >= _shift(mag, 1, -1)) & (mag >= _shift(mag, -1, 1))
    keep = torch.where(ay <= TAN225 * ax, keep_h,
                       torch.where(ay >= TAN675 * ax, keep_v,
                                   torch.where(gx * gy >= 0, keep_d1,
                                               keep_d2)))
    nms = mag * keep.float()
    strong, weak = (nms > high).float(), (nms > low).float()
    for _ in range(rounds):
        grown = F.max_pool2d(strong[:, None], 3, stride=1, padding=1)[:, 0]
        strong = torch.maximum(strong, grown * weak)
    return strong * 255.0


def gray255(x: torch.Tensor) -> torch.Tensor:
    """NCHW image -> (N, H, W) gray rescaled to [0, 255] per sample."""
    g = x.sum(dim=1) / x.shape[1]
    lo = g.amin(dim=(1, 2), keepdim=True)
    hi = g.amax(dim=(1, 2), keepdim=True)
    return (g - lo) / (hi - lo + 1e-8) * 255.0


def _resize(x, hw):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


class SAUNet(nn.Module):
    def __init__(self, num_classes: int = 4, num_filters: int = 32,
                 canny_low: float = 10.0, canny_high: float = 100.0):
        super().__init__()
        mode = self.mode = _Mode()
        nf = num_filters
        self.canny_low, self.canny_high = canny_low, canny_high
        self.encoder = Encoder(mode)
        r1, r2, r3 = RES_WIDTHS
        w5, w4, w3, w2 = DECODER_WIDTHS
        self.d0 = Conv(mode, 128, r1)
        self.c3 = Conv(mode, 256, 1)
        self.c4 = Conv(mode, 512, 1)
        self.c5 = Conv(mode, 1024, 1)
        self.res1 = ResBlock(mode, r1)
        self.d1 = Conv(mode, r1, r2)
        self.gate1 = Gate(mode, r2)
        self.res2 = ResBlock(mode, r2)
        self.d2 = Conv(mode, r2, r3)
        self.gate2 = Gate(mode, r3)
        self.res3 = ResBlock(mode, r3)
        self.d3 = Conv(mode, r3, r3 // 2)
        self.gate3 = Gate(mode, r3 // 2)
        self.fuse = Conv(mode, r3 // 2, 1, bias=False)
        self.center = ConvBNRelu(mode, 1024, nf * 16, 3)
        self.dec5 = DualAtt(mode, nf * 16, 1024, w5)
        self.dec4 = DualAtt(mode, w5, 512, w4)
        self.dec3 = DualAtt(mode, w4, 256, w3)
        self.dec2 = DualAtt(mode, w3, 128, w2)
        self.cw = Conv(mode, 2, 1, bias=False)
        self.expand = ConvBNRelu(mode, 1, nf, 1)
        self.dec1 = Decoder(mode, w2, 48, nf)
        self.dec0 = ConvBNRelu(mode, 2 * nf, nf, 3)
        self.final = Conv(mode, nf, num_classes)

    def forward(self, x: torch.Tensor):
        """x: (N, 3, H, W) f32 -> (logits (N, C, H, W), edge (N, 1, H, W)).
        The input is first rounded to the configuration's input type: the
        network, and Canny's gray, see the image in that type."""
        x = x.to(self.mode.input_dtype).float()
        f2, f3, f4, f5 = self.encoder(x)
        hw = x.shape[-2:]
        ss = self.d1(self.res1(_resize(self.d0(f2), hw)))
        ss = self.d2(self.res2(self.gate1(ss, _resize(self.c3(f3), hw))))
        ss = self.d3(self.res3(self.gate2(ss, _resize(self.c4(f4), hw))))
        ss = self.gate3(ss, _resize(self.c5(f5), hw))
        edge_out = torch.sigmoid(self.fuse(ss))

        with torch.no_grad():
            edges = canny(gray255(x), self.canny_low,
                          self.canny_high)[:, None]
        acts = torch.sigmoid(self.cw(torch.cat([edge_out, edges], 1)))
        edge = self.expand(acts)

        def up2(t):
            return _resize(t, (t.shape[2] * 2, t.shape[3] * 2))

        center = self.center(F.max_pool2d(f5, 2))
        dec = self.dec5(center, f5)
        dec = self.dec4(dec, up2(f4))
        dec = self.dec3(dec, up2(f3))
        dec = self.dec2(dec, up2(f2))
        dec0 = self.dec0(torch.cat([self.dec1(dec), edge], dim=1))
        return self.final(dec0), edge_out
