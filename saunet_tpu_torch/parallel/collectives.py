"""Collectives the data-parallel steps use: a differentiable all-reduce
and the generator fold-in (counterparts of `lax.psum` under autodiff and of
`jax.random.fold_in`).

Only `all_reduce` and `broadcast` are used, so that the gloo backend runs
them on CUDA tensors as well as on CPU ones.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group forward, and SUM of the gradient backward.

    In a global-batch step every rank computes the same global loss, so
    the backward hands each rank `world x` its share of the true gradient;
    averaging the parameter gradients over the ranks (as
    DistributedDataParallel does) then gives the true gradient once."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable; `x` itself
    when `group` is None (one process, no collective)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def fold_in(gen: torch.Generator, index: int) -> torch.Generator:
    """A new generator on `gen`'s device, seeded from one draw of `gen` and
    `index`: ranks holding generators in the same state get distinct
    streams (the counterpart of `jax.random.fold_in(rng, axis_index)`).
    Advances `gen` by one draw."""
    base = int(torch.randint(0, 2**62, (), generator=gen, device=gen.device))
    seed = (base ^ (index * 0x9E3779B97F4A7C15)) & (2**63 - 1)
    return torch.Generator(device=gen.device).manual_seed(seed)
