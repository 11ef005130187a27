"""SAUNet: Shape-Attentive U-Net, NCHW (counterpart of
saunet_tpu/models/saunet.py, `stream_impl="xla"` math).

DenseNet-121 encoder (no pool0), gated full-resolution shape stream, Canny
edge cue, four dual-attention decoder blocks, edge fusion and a 1x1 head.
Parameters stay f32; `dtype` is the compute dtype, as flax's `dtype=`.

The TPU package's lane-packed stream (`stream_impl="packed"`) is a TPU
memory layout with the same math and the same parameter tree; the port
computes that math once, and its tests hold it against both layouts.

Under `blocks.partition_space` (the 'space' axis) the model holds the
rank's `SpaceShard` too: its resizes run on global rows, the center
block's max pool fetches the rows it reads, and Canny runs on the rank's
rows and CANNY_HALO rows either side (no farther than the image), the
design of the JAX package's banded Canny (K2), whose result is exact.

Spans (`utils/profiling.py::annotate`): `saunet.encoder` (the encoder in
`forward`), `saunet.stream`, `saunet.canny` (K1, or the plain Canny)
and `saunet.decoder` (edge fusion, the dual-attention decoder, dec1, dec0
and the head's convolution).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.canny import canny_edges_cuda
from ..ops.edge import canny_edges, image_to_gray255
from ..ops.resize import resize_bilinear
from ..utils.config import NUM_CLASSES, NUM_FILTERS
from ..utils.profiling import annotate
from .blocks import (
    Conv2d,
    ConvBNRelu,
    DecoderBlock,
    DualAttBlock,
    GatedSpatialConv,
    ResBasicBlock,
    max_pool_2x2,
    set_act,
)
from .densenet import DenseNetEncoder

#: Canny's reach in rows: Sobel and non-maximum suppression 2, then one a
#: hysteresis round, of the 8 both Canny functions run by default
#: (saunet_tpu/ops/pallas/canny.py's band halo)
CANNY_HALO = 8 + 2


def canny_rows(gray: torch.Tensor, space, edges) -> torch.Tensor:
    """This rank's rows of `edges` (NHW1 gray -> NHW1 edges, a Canny) of
    the image whose rows `gray` holds on the 'space' axis: `edges` of the
    rank's rows and CANNY_HALO rows either side, cut at the image's
    border, cropped to the rank's rows. Exact: a band's false border
    reaches CANNY_HALO rows in."""
    h = space.level(gray.shape[1])
    lo, hi = space.rows(h)

    def band(lo, hi):
        return max(lo - CANNY_HALO, 0), min(hi + CANNY_HALO, h)

    with torch.no_grad():
        out = edges(space.fetch(gray, h, h, band, dim=1))
    start = lo - band(lo, hi)[0]
    return out[:, start:start + hi - lo]


#: `edge_kernel` values: the Canny each one runs (the JAX package's 'xla'
#: is the plain version, its 'pallas' the kernel)
EDGE_KERNELS = {"auto": "wrapper", "pallas": "kernel", "xla": "plain",
                "plain": "plain"}
STREAM_IMPLS = ("xla", "packed")


class SAUNet(nn.Module):
    """The JAX SAUNet's constructor surface:

    `edge_kernel`: "auto" runs Canny through its kernel wrapper (the CUDA
    kernel on a GPU, the plain version on the CPU); "xla" and "plain" always
    run the plain version; "pallas" always runs the kernel, which raises
    for a tensor on the CPU. `stream_impl` "xla" or "packed": one math, the
    packed layout being a TPU memory layout. `act` (default ReLU) becomes
    the `act` of every module that holds one of the JAX modules' `act`
    sites. `remat` and `encoder_concat` are the encoder's
    (models/densenet.py: rematerialised dense blocks; their train layout,
    'chain', 'buffer' or 'fused')."""

    space = None

    def __init__(self, num_classes: int = NUM_CLASSES,
                 num_filters: int = NUM_FILTERS,
                 dtype: torch.dtype = torch.float32,
                 act: Callable = F.relu,
                 canny_low: float = 10.0, canny_high: float = 100.0,
                 edge_kernel: str = "auto", remat: bool = False,
                 encoder_concat: str = "chain", stream_impl: str = "xla"):
        super().__init__()
        if edge_kernel not in EDGE_KERNELS:
            raise ValueError(f"edge_kernel must be one of "
                             f"{sorted(EDGE_KERNELS)}, got {edge_kernel!r}")
        if stream_impl not in STREAM_IMPLS:
            raise ValueError(f"stream_impl must be 'xla' or 'packed', "
                             f"got {stream_impl!r}")
        self.stream_impl = stream_impl
        self.num_classes = num_classes
        self.num_filters = num_filters
        self.dtype = dtype
        self.canny_low, self.canny_high = canny_low, canny_high
        self.edge_kernel = edge_kernel
        nf = num_filters

        self.encoder = DenseNetEncoder(remat=remat,
                                       concat_mode=encoder_concat)
        # shape stream; f2..f5 carry 128, 256, 512, 1024 channels
        self.d0 = Conv2d(128, 64)
        self.c3 = Conv2d(256, 1)
        self.c4 = Conv2d(512, 1)
        self.c5 = Conv2d(1024, 1)
        self.res1 = ResBasicBlock(64)
        self.d1 = Conv2d(64, 32)
        self.gate1 = GatedSpatialConv(32, 32)
        self.res2 = ResBasicBlock(32)
        self.d2 = Conv2d(32, 16)
        self.gate2 = GatedSpatialConv(16, 16)
        self.res3 = ResBasicBlock(16)
        self.d3 = Conv2d(16, 8)
        self.gate3 = GatedSpatialConv(8, 8)
        self.fuse = Conv2d(8, 1, bias=False)

        # dual-attention decoder trunk
        self.center = ConvBNRelu(1024, nf * 16, 3)
        self.dec5 = DualAttBlock(nf * 16, 1024, 512)
        self.dec4 = DualAttBlock(512, 512, 256)
        self.dec3 = DualAttBlock(256, 256, 128)
        self.dec2 = DualAttBlock(128, 128, 64)

        # edge fusion + full-resolution tail
        self.cw = Conv2d(2, 1, bias=False)
        self.expand = ConvBNRelu(1, nf, 1)
        self.dec1 = DecoderBlock(64, 48, nf)
        self.dec0 = ConvBNRelu(2 * nf, nf, 3)
        self.final = Conv2d(nf, num_classes)
        self.act = act
        set_act(self, act)

    def _canny(self, gray: torch.Tensor) -> torch.Tensor:
        """NHW1 gray -> NHW1 edges. The input is detached: the kernel has
        no backward, and the reference's cv2 Canny is gradient-opaque."""
        gray = gray.detach()
        route = EDGE_KERNELS[self.edge_kernel]
        if route == "kernel" and not gray.is_cuda:
            raise ValueError(f"edge_kernel 'pallas' runs the Canny kernel, "
                             f"which has no version for {gray.device}")
        edges = canny_edges if route == "plain" else canny_edges_cuda
        with annotate("saunet.canny"):
            if self.space is None:
                return edges(gray, self.canny_low, self.canny_high)
            return canny_rows(gray, self.space, lambda band: edges(
                band, self.canny_low, self.canny_high))

    def _height(self, t: torch.Tensor) -> int:
        """The global rows of NCHW `t`'s level."""
        return t.shape[2] if self.space is None else \
            self.space.level(t.shape[2])

    def forward(self, x: torch.Tensor, return_att: bool = False):
        """x: NCHW image. Returns (logits f32, edge_out[, att maps])."""
        x = x.to(self.dtype)
        with annotate("saunet.encoder"):
            _, f2, f3, f4, f5 = self.encoder(x)
        return self.decode((f2, f3, f4, f5), x, return_att)

    def shape_stream(self, taps: Sequence[torch.Tensor], x: torch.Tensor):
        """(f2..f5, x) -> (edge_out f32 in (0, 1), (g1, g2, g3))."""
        conv2, conv3, conv4, conv5 = taps
        hw, sp = (self._height(x), x.shape[3]), self.space
        with annotate("saunet.stream"):
            ss = resize_bilinear(self.d0(conv2), hw, sp)
            ss = self.d1(self.res1(ss))
            ss, g1 = self.gate1(ss, resize_bilinear(self.c3(conv3), hw, sp))
            ss = self.d2(self.res2(ss))
            ss, g2 = self.gate2(ss, resize_bilinear(self.c4(conv4), hw, sp))
            ss = self.d3(self.res3(ss))
            ss, g3 = self.gate3(ss, resize_bilinear(self.c5(conv5), hw, sp))
            return torch.sigmoid(self.fuse(ss).float()), (g1, g2, g3)

    def shape_stream_inputs(self, taps: Sequence[torch.Tensor],
                            x: torch.Tensor) -> torch.Tensor:
        """The shape-stream kernel's input: the resized 64-channel d0(f2)
        and the resized 1-channel c3(f3), c4(f4), c5(f5), packed into one
        (N, H, W, 67) NHWC tensor in the taps' dtype, channels contiguous
        per pixel (ops/cuda/shape_stream.py reads it so)."""
        conv2, conv3, conv4, conv5 = taps
        hw, sp = (self._height(x), x.shape[3]), self.space
        parts = [resize_bilinear(self.d0(conv2), hw, sp),
                 resize_bilinear(self.c3(conv3), hw, sp),
                 resize_bilinear(self.c4(conv4), hw, sp),
                 resize_bilinear(self.c5(conv5), hw, sp)]
        return torch.cat(parts, dim=1).permute(0, 2, 3, 1).contiguous()

    def _dualatt_decoder(self, taps):
        """center .. dec2. Returns (dec2, (att2, att3, att4, att5))."""
        conv2, conv3, conv4, conv5 = taps

        def up2(t):
            return resize_bilinear(t, (self._height(t) * 2, t.shape[3] * 2),
                                   self.space)

        center = self.center(max_pool_2x2(conv5, self.space))
        dec5, att5 = self.dec5(center, conv5)
        dec4, att4 = self.dec4(dec5, up2(conv4))
        dec3, att3 = self.dec3(dec4, up2(conv3))
        dec2, att2 = self.dec2(dec3, up2(conv2))
        return dec2, (att2, att3, att4, att5)

    def _upsampled_atts(self, atts, gates):
        out = [resize_bilinear(a, (self._height(a) * s, a.shape[3] * s),
                               self.space)
               for a, s in zip(atts, (2, 4, 8, 16))]
        return out + list(gates)

    def decode(self, taps: Sequence[torch.Tensor], x: torch.Tensor,
               return_att: bool = False,
               edge_out: Optional[torch.Tensor] = None):
        """Everything after the encoder: shape stream, Canny edge fusion,
        dual-attention decoder, head. `taps` = (f2, f3, f4, f5) NCHW;
        `x` is the NCHW network input, cast to the model dtype BEFORE the
        gray image is taken from it. `edge_out`, an (N, 1, H, W) edge map
        (NCHW, as `shape_stream` returns it; the shape-stream kernel's
        (N, H, W, 1) output permuted), replaces the shape stream; it has no
        gate maps, so it cannot go with `return_att`."""
        if edge_out is not None and return_att:
            raise ValueError("return_att needs the shape stream's gate "
                             "maps; do not pass edge_out")
        dt = self.dtype
        x = x.to(dt)
        gates = ()
        if edge_out is None:
            edge_out, gates = self.shape_stream(taps, x)

        gray = image_to_gray255(x.permute(0, 2, 3, 1),
                                None if self.space is None
                                else self.space.group)
        canny = self._canny(gray).to(dt).permute(0, 3, 1, 2)
        with annotate("saunet.decoder"):
            acts = torch.sigmoid(self.cw(torch.cat([edge_out.to(dt), canny],
                                                   1)))
            edge = self.expand(acts)

            dec2, atts = self._dualatt_decoder(taps)
            dec1 = self.dec1(dec2)
            dec0 = self.dec0(torch.cat([dec1, edge], dim=1))
            x_out = self.final(dec0).float()
            if return_att:
                return x_out, edge_out, self._upsampled_atts(atts, gates)
            return x_out, edge_out
