"""Residual-lean dense block for training, NCHW (counterpart of
saunet_tpu/ops/dense_block_train.py, the 'fused' train layout).

A dense block's concat is never overwritten: layer l reads channels
[0, C_l) and appends GROWTH more. So

  * every layer's input is a prefix of the FINAL concat, and
  * the batch statistics layer l's norm1 needs are those of each channel
    group at the moment it was produced.

`dense_block_train` is an autograd Function built on both facts. Its
forward writes each layer's GROWTH new channels into one preallocated
(N, Cmax, H, W) buffer and takes each group's statistics once, when it is
produced (flax's f32 fast variance, clipped at 0; over the ranks of a
process group with one all-reduce a statistic); layer l's norm1 statistics
are the leading C_l entries. It saves only the final buffer and the
weights. Its backward runs the layers in reverse: each is recomputed from
the buffer's prefix under autograd, its statistics taken from the prefix
again so that BatchNorm's batch-statistic gradient terms are exact (not
straight-through), and its input cotangent is accumulated into the
gradient buffer's prefix. The forward returns the statistics; the caller
folds them into the running averages.

On the 'space' axis (`space`, a parallel.mesh.SpaceShard) each layer's 3x3
conv is the space-aware conv of models/blocks.py, fetching its halo rows
(`exchange_rows`) in the forward and again in the backward's recompute;
every rank issues the same collectives in the same order.

The JAX function keeps its concat as 128-lane chunks, because narrow
channel slices of a wider array are lane-unaligned in TPU HBM; that layout
is not ported (the port is held against the JAX function's values).
`dense_block_eval` normalises with the running statistics under plain
autograd: the fused block in eval mode, and so under `--fix_bn`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.blocks import conv2d_rows
from ..models.norm import batch_stats

GROWTH = 32

#: one layer's weights: norm1 scale and bias (C_l), conv1 (hidden, C_l, 1,
#: 1), norm2 scale and bias (hidden), conv2 (GROWTH, hidden, 3, 3); f32
Layer = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class Config:
    """eps of both norms; `group`, the process group the statistics are
    taken over (None: this process's batch); `space`, the rank's
    SpaceShard (None: whole images); `act`, the layers' activation."""
    eps: float
    group: object = None
    space: object = None
    act: Callable = F.relu


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def new_buffer(x: torch.Tensor, channels: int) -> torch.Tensor:
    """An uninitialised (N, `channels`, H, W) tensor in `x`'s dtype, device
    and memory format (channels-last where `x` is: the convs of a model fed
    NHWC images run channels-last, and `torch.cat` keeps that format)."""
    n, _, h, w = x.shape
    fmt = (torch.channels_last
           if not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return torch.empty((n, channels, h, w), dtype=x.dtype, device=x.device,
                       memory_format=fmt)


def _layer(prefix: torch.Tensor, p: Layer, cfg: Config,
           stats1=None, stats2=None):
    """One dense layer of the live `prefix` (N, C_l, H, W): (the GROWTH new
    channels, (norm2 mean, var)). `stats1`/`stats2`: the norms' (mean, var);
    None takes them from this batch (`batch_stats`), so that autograd
    carries their dependence on the input. The op order is the JAX
    function's: norm1 as an f32 affine, the 1x1 conv in the model dtype,
    norm2 in f32."""
    n1s, n1b, w1, n2s, n2b, w2 = p
    dtype = prefix.dtype
    mu1, var1 = batch_stats(prefix, cfg.group) if stats1 is None else stats1
    a = torch.rsqrt(var1 + cfg.eps) * n1s
    b = n1b - mu1 * a
    u = cfg.act((prefix.float() * _channel(a) + _channel(b)).to(dtype))
    t = F.conv2d(u, w1.to(dtype))
    mu2, var2 = batch_stats(t, cfg.group) if stats2 is None else stats2
    s = (t.float() - _channel(mu2)) * _channel(torch.rsqrt(var2 + cfg.eps)
                                               * n2s) + _channel(n2b)
    s = cfg.act(s.to(dtype))
    w2 = w2.to(dtype)
    if cfg.space is None:
        new = F.conv2d(s, w2, padding=1)
    else:
        new = conv2d_rows(s, w2, None, 1, (1, 1), cfg.space)
    return new, (mu2, var2)


def _forward(x: torch.Tensor, layers: Sequence[Layer], cfg: Config):
    c0, num_layers = x.shape[1], len(layers)
    buf = new_buffer(x, c0 + num_layers * GROWTH)
    buf[:, :c0] = x
    mu, var = batch_stats(x, cfg.group)
    g_mu, g_var, mu2s, var2s = [mu], [var], [], []
    for l, p in enumerate(layers):
        cl = c0 + l * GROWTH
        stats1 = (torch.cat(g_mu), torch.cat(g_var))
        new, (mu2, var2) = _layer(buf[:, :cl], p, cfg, stats1)
        buf[:, cl:cl + GROWTH] = new
        mu2s.append(mu2)
        var2s.append(var2)
        # the last group's statistics are the next BatchNorm's to take
        if l < num_layers - 1:
            mu, var = batch_stats(new, cfg.group)
            g_mu.append(mu)
            g_var.append(var)
    return buf, (torch.cat(g_mu), torch.cat(g_var), torch.stack(mu2s),
                 torch.stack(var2s))


class _DenseBlockTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, cfg, *flat):
        layers = [flat[i:i + 6] for i in range(0, len(flat), 6)]
        buf, stats = _forward(x, layers, cfg)
        ctx.cfg, ctx.c0 = cfg, x.shape[1]
        ctx.save_for_backward(buf, *flat)
        ctx.mark_non_differentiable(*stats)
        return (buf, *stats)

    @staticmethod
    def backward(ctx, gbuf, *_):
        buf, *flat = ctx.saved_tensors
        cfg, c0 = ctx.cfg, ctx.c0
        num_layers = len(flat) // 6
        buf = buf.detach()
        gacc = gbuf.clone()
        grads: List[Optional[torch.Tensor]] = [None] * len(flat)
        for l in reversed(range(num_layers)):
            cl = c0 + l * GROWTH
            with torch.enable_grad():
                prefix = buf[:, :cl].requires_grad_()
                p = [t.detach().requires_grad_()
                     for t in flat[6 * l:6 * l + 6]]
                new, _ = _layer(prefix, p, cfg)
                dprefix, *dp = torch.autograd.grad(
                    new, [prefix, *p], gacc[:, cl:cl + GROWTH])
            gacc[:, :cl] += dprefix
            grads[6 * l:6 * l + 6] = dp
        return (gacc[:, :c0], None, *grads)


def dense_block_train(x: torch.Tensor, layers: Sequence[Layer],
                      cfg: Config):
    """Train-mode dense block of NCHW `x` (the model dtype): returns (the
    (N, Cmax, H, W) concat, (norm1 mean, norm1 var, norm2 means, norm2
    vars)), the f32 batch statistics the caller folds into the running
    averages: layer l's norm1 statistics are the leading C_l entries of
    the first two (Cmax - GROWTH each), its norm2 statistics row l of the
    last two (L, hidden). Gradients reach `x` and every weight."""
    flat = [t for p in layers for t in p]
    buf, *stats = _DenseBlockTrain.apply(x, cfg, *flat)
    return buf, tuple(stats)


def dense_block_eval(x: torch.Tensor, layers: Sequence[Layer],
                     running: Sequence[Tuple[torch.Tensor, ...]],
                     cfg: Config) -> torch.Tensor:
    """Eval-mode dense block: each layer normalised with its running
    statistics `running[l]` = (norm1 mean, var, norm2 mean, var), plain
    autograd (the statistics are constants)."""
    for p, (m1, v1, m2, v2) in zip(layers, running):
        new, _ = _layer(x, p, cfg, (m1, v1), (m2, v2))
        x = torch.cat([x, new], dim=1)
    return x
