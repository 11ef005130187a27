"""SAUNet's operations and bytes in closed form.

`forward_flops(h, w)`: the model FLOPs of one slice's forward, two per
multiply-add of every convolution and transposed convolution (what
`torch.utils.flop_counter` counts of the model: normalisation, activations,
resizes, pooling and Canny add none).

`encoder_work(n, h, w, elem)`: the operations of the DenseNet-121 encoder
on a batch of n slices and its least device-memory traffic in bytes, each
stage's input read once and output written once in the compute type
(`elem` bytes an element), its weights read once: the stem (conv0 +
norm0), the four dense blocks, the three transitions (conv and 2x2 pool)
and norm5.
"""
from __future__ import annotations

BLOCKS = (6, 12, 24, 16)
GROWTH, HIDDEN, STEM = 32, 128, 64


def _conv(cin: int, cout: int, k: int, px: int) -> int:
    return 2 * cin * cout * k * k * px


def _convt(cin: int, cout: int, px_in: int) -> int:
    # kernel 4, stride 2: each input pixel meets cout * 16 taps
    return 2 * cin * cout * 16 * px_in


def _px(h: int, w: int, level: int) -> int:
    return (h >> level) * (w >> level)


def encoder_flops(h: int, w: int) -> int:
    flops = _conv(3, STEM, 7, _px(h, w, 1))
    c = STEM
    for i, layers in enumerate(BLOCKS):
        px = _px(h, w, i + 1)
        for l in range(layers):
            flops += _conv(c + GROWTH * l, HIDDEN, 1, px) \
                + _conv(HIDDEN, GROWTH, 3, px)
        c += GROWTH * layers
        if i != len(BLOCKS) - 1:
            flops += _conv(c, c // 2, 1, px)
            c //= 2
    return flops


def stream_flops(h: int, w: int) -> int:
    px = _px(h, w, 0)
    flops = (_conv(128, 64, 1, _px(h, w, 2)) + _conv(256, 1, 1, _px(h, w, 3))
             + _conv(512, 1, 1, _px(h, w, 4))
             + _conv(1024, 1, 1, _px(h, w, 4)))
    for c in (64, 32, 16):
        # residual block, 1x1 down to c / 2, gate on c / 2 + 1 channels
        half = c // 2
        flops += 2 * _conv(c, c, 3, px) + _conv(c, half, 1, px)
        flops += (_conv(half + 1, half + 1, 1, px)
                  + _conv(half + 1, 1, 1, px) + _conv(half, half, 1, px))
    return flops + _conv(8, 1, 1, px)


def decoder_flops(h: int, w: int, nf: int = 32, classes: int = 4) -> int:
    px = _px(h, w, 0)
    flops = _conv(1024, nf * 16, 3, _px(h, w, 5))
    # (coarse, skip, out, output level) of dec5 .. dec2
    for coarse, skip, out, level in ((nf * 16, 1024, 512, 4),
                                     (512, 512, 256, 3),
                                     (256, 256, 128, 2), (128, 128, 64, 1)):
        po = _px(h, w, level)
        flops += (_convt(coarse, coarse, _px(h, w, level + 1))
                  + _conv(skip + coarse, out, 3, po)
                  + _conv(out, out // 4, 1, po) + _conv(out // 4, 1, 1, po)
                  + _conv(out, out // 16, 1, 1) + _conv(out // 16, out, 1, 1))
    flops += _conv(2, 1, 1, px) + _conv(1, nf, 1, px)
    flops += _conv(64, 48, 3, _px(h, w, 1)) + _convt(48, nf, _px(h, w, 1))
    return flops + _conv(2 * nf, nf, 3, px) + _conv(nf, classes, 1, px)


def forward_flops(h: int, w: int, nf: int = 32, classes: int = 4) -> int:
    return (encoder_flops(h, w) + stream_flops(h, w)
            + decoder_flops(h, w, nf, classes))


def encoder_work(n: int, h: int, w: int, elem: int = 2):
    """(operations, bytes) of the encoder on n slices of h x w. A stage's
    bytes: its input read and its output written (`elem` bytes an
    element), its convolution weights (`elem` bytes each) and two float32
    values a channel of each BatchNorm it applies (the folded scale and
    shift)."""
    px0, px1 = _px(h, w, 0), _px(h, w, 1)
    nbytes = elem * (n * (3 * px0 + STEM * px1) + 3 * STEM * 49)  # conv0
    nbytes += 2 * elem * n * STEM * px1 + 4 * 2 * STEM           # norm0
    c = STEM
    for i, layers in enumerate(BLOCKS):
        px = _px(h, w, i + 1)
        out = c + GROWTH * layers
        weights = sum((c + GROWTH * l) * HIDDEN + HIDDEN * GROWTH * 9
                      for l in range(layers))
        norms = sum((c + GROWTH * l) + HIDDEN for l in range(layers))
        nbytes += elem * (n * (c + out) * px + weights) + 4 * 2 * norms
        c = out
        if i != len(BLOCKS) - 1:                                  # transition
            nbytes += elem * (n * (c * px + (c // 2) * (px // 4))
                              + c * (c // 2)) + 4 * 2 * c
            c //= 2
    nbytes += 2 * elem * n * c * _px(h, w, 4) + 4 * 2 * c        # norm5
    return n * encoder_flops(h, w), nbytes
