"""Collectives the parallel steps use: a differentiable all-reduce, the
differentiable row exchange of the 'space' axis, and the generator fold-in
(counterparts of `lax.psum` under autodiff, of the halo exchanges XLA's
spatial partitioner inserts, and of `jax.random.fold_in`).

Only `all_reduce` and `broadcast` are used, so that the gloo backend runs
them on CUDA tensors as well as on CPU ones: the row exchange is one
all-reduce of a zero-filled buffer with a slot a rank (a point-to-point
exchange for NCCL is queued in ROADMAP.md section 2).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

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


Rows = Tuple[int, int]


class _ExchangePlan:
    """Where every row of a row exchange comes from and goes to.

    owned[q] are the global rows rank q holds, windows[q] the rows
    [a, b) rank q asks for. Rank q's window is, in order: zero rows above
    row 0, the rows above its own that others hold (`top`), its own rows,
    the rows below its own that others hold, zero rows below the level.
    Slot q of the exchange buffer carries q's top rows then its bottom
    rows; `sends` lists the (slot, slot offset, local offset, count) runs
    this rank fills from its own rows."""

    def __init__(self, owned: Sequence[Rows], windows: Sequence[Rows],
                 index: int):
        h = owned[-1][1]
        self.index = index
        self.parts = []
        sends = []
        for q, ((a, b), (lo, hi)) in enumerate(zip(windows, owned)):
            ca = min(max(a, 0), b)
            cb = max(min(b, h), ca)
            top = (ca, max(ca, min(cb, lo)))
            bottom = (min(cb, max(ca, hi)), cb)
            self.parts.append((ca - a, top, (max(ca, lo), min(cb, hi)),
                               bottom, b - cb))
            slot = 0
            for run in (top, bottom):
                own_lo, own_hi = owned[index]
                r_lo, r_hi = max(run[0], own_lo), min(run[1], own_hi)
                if q != index and r_lo < r_hi:
                    sends.append((q, slot + r_lo - run[0], r_lo - own_lo,
                                  r_hi - r_lo))
                slot += run[1] - run[0]
        self.sends = sends
        self.slot_rows = max(t[1] - t[0] + bt[1] - bt[0]
                             for _, t, _, bt, _ in self.parts)
        self.own_lo = owned[index][0]

    def buffer(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] = self.slot_rows
        return x.new_zeros([len(self.parts)] + shape)

    def reduce(self, buf: torch.Tensor, group) -> None:
        nbytes = buf.numel() * buf.element_size()
        trace = exchange_rows.trace
        if trace is not None:
            # the exchange alone: the device work queued before it first
            if buf.is_cuda:
                torch.cuda.synchronize(buf.device)
            t0 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        exchange_rows.calls += 1
        exchange_rows.bytes += nbytes
        if trace is not None:
            trace.append((tuple(buf.shape), nbytes,
                          time.perf_counter() - t0))

    def gather(self, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        zeros_above, top, mid, bottom, zeros_below = self.parts[self.index]
        pieces = []
        if zeros_above:
            pieces.append(_zero_rows(x, dim, zeros_above))
        n_top, n_bottom = top[1] - top[0], bottom[1] - bottom[0]
        buf = None
        if self.slot_rows:
            buf = self.buffer(x, dim)
            for q, at, local, n in self.sends:
                buf[q].narrow(dim, at, n).copy_(x.narrow(dim, local, n))
            self.reduce(buf, group)
        if n_top:
            pieces.append(buf[self.index].narrow(dim, 0, n_top))
        if mid[1] > mid[0]:
            pieces.append(x.narrow(dim, mid[0] - self.own_lo,
                                   mid[1] - mid[0]))
        if n_bottom:
            pieces.append(buf[self.index].narrow(dim, n_top, n_bottom))
        if zeros_below:
            pieces.append(_zero_rows(x, dim, zeros_below))
        return torch.cat(pieces, dim)

    def scatter_add(self, g: torch.Tensor, shape: torch.Size, dim: int,
                    group) -> torch.Tensor:
        """The transpose of `gather`: each row's gradient added to the rank
        that holds it; `shape` is the shape of the gathered-from tensor."""
        zeros_above, top, mid, bottom, _ = self.parts[self.index]
        grad = g.new_zeros(shape)
        n_top, n_bottom = top[1] - top[0], bottom[1] - bottom[0]
        n_mid = mid[1] - mid[0]
        if n_mid > 0:
            grad.narrow(dim, mid[0] - self.own_lo, n_mid).copy_(
                g.narrow(dim, zeros_above + n_top, n_mid))
        if self.slot_rows:
            buf = self.buffer(g, dim)
            if n_top:
                buf[self.index].narrow(dim, 0, n_top).copy_(
                    g.narrow(dim, zeros_above, n_top))
            if n_bottom:
                buf[self.index].narrow(dim, n_top, n_bottom).copy_(
                    g.narrow(dim, zeros_above + n_top + max(n_mid, 0),
                             n_bottom))
            self.reduce(buf, group)
            for q, at, local, n in self.sends:
                grad.narrow(dim, local, n).add_(buf[q].narrow(dim, at, n))
        return grad


def _zero_rows(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


class _RowExchange(torch.autograd.Function):
    """`plan.gather` forward; its transpose, `plan.scatter_add`, backward:
    the gradient of every fetched row goes back to the rank that holds the
    row and is added there."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: _ExchangePlan, dim: int,
                group) -> torch.Tensor:
        ctx.plan, ctx.dim, ctx.group = plan, dim, group
        ctx.shape = x.shape
        return plan.gather(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return (ctx.plan.scatter_add(g.contiguous(), ctx.shape, ctx.dim,
                                     ctx.group), None, None, None)


def exchange_rows(x: torch.Tensor, owned: Sequence[Rows],
                  windows: Sequence[Rows], index: int, group,
                  dim: int = 2) -> torch.Tensor:
    """Rows windows[index] = [a, b) of a tensor split along `dim` over the
    ranks of `group`: rank q holds global rows owned[q] (contiguous, in
    rank order) and asks for windows[q]; `x` holds this rank's. Rows
    outside the level (below 0, at or above owned[-1][1]) are zeros.
    Differentiable: the backward sends each fetched row's gradient to the
    rank that holds the row and adds it there.

    Every rank of `group` calls it with the same `owned` and `windows`. One
    all-reduce of a buffer with a slot a rank (the rows each rank asks of
    the others) runs forward and one backward; none when every window lies
    inside its rank's own rows. `exchange_rows.calls` and `.bytes` count
    those all-reduces and their buffers' bytes; while `exchange_rows.trace`
    is a list, each appends (buffer shape, bytes, host seconds), timed
    after a device synchronise (which slows the step)."""
    plan = _ExchangePlan(owned, windows, index)
    return _RowExchange.apply(x, plan, dim, group)


exchange_rows.calls = 0
exchange_rows.bytes = 0
exchange_rows.trace = None


def fold_in(gen: torch.Generator, index: int) -> torch.Generator:
    """A new generator on `gen`'s device, seeded from one draw of `gen` and
    `index`: ranks holding generators in the same state get distinct
    streams (the counterpart of `jax.random.fold_in(rng, axis_index)`).
    Advances `gen` by one draw."""
    base = int(torch.randint(0, 2**62, (), generator=gen, device=gen.device))
    seed = (base ^ (index * 0x9E3779B97F4A7C15)) & (2**63 - 1)
    return torch.Generator(device=gen.device).manual_seed(seed)
