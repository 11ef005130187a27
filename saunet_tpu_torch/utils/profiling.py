"""Tracing and step timing (counterpart of saunet_tpu/utils/profiling.py):

  trace(dir):      a torch.profiler window over the host and the card,
                   written to `dir` as a TensorBoard-loadable trace.
  annotate(name):  a named region: a profiler range, and an NVTX range
                   when a card is present.
  StepTimer:       host-clock step timing that synchronises the card at
                   both ends of a step, excludes the first `skip` steps
                   (warm-up) and summarises percentiles.

The card-side measurement helpers that chip_smoke.py and the profilers
(`saunet_tpu_torch.profile`) share:

  cuda_ms(fn):              median ms of `fn()` over CUDA-event runs.
  device_ms_by_kernel(fn):  device ms per call of each kernel `fn`
                            launches, by short name (torch.profiler).
  profile_window(fn):       torch.profiler over a few calls: device busy
                            time, idle share, top operations.
  device_idle_share(fn):    the card's idle share over one call, tracing
                            the device alone.
  bound(nbytes, ops, rate): the least time for that traffic and work on
                            the H100's published peaks.
  card():                   the card's name and power limit, as
                            `nvidia-smi` prints them.
  Segments:                 named cut points inside one eager pass (CUDA
                            events on the card, the host clock on the
                            CPU) and the ms of each segment.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when a card is present) and write
    its trace into `log_dir`."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's trace and, on a card, in NVTX."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Host-clock step timing, `with timer: step()`; the first `skip`
    steps are excluded. `sync` (default: whether a card is present)
    synchronises the card as a step starts and ends, so a step's time is
    its device work and not its enqueue."""

    def __init__(self, skip: int = 1, sync: Optional[bool] = None):
        self.skip = skip
        self.sync = torch.cuda.is_available() if sync is None else sync
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        if self.sync:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip:
            self.times.append(dt)
        return False

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {"steps": len(t), "mean_s": float(t.mean()),
                "p50_s": float(np.percentile(t, 50)),
                "p95_s": float(np.percentile(t, 95)),
                "items_per_sec": float(items_per_step / t.mean())}


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the least time for `nbytes` of device memory
    traffic and `ops` operations on the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn: Callable, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` over `runs` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(fn: Callable, calls: int = 5) -> dict:
    """Device ms per call of `fn` for each CUDA kernel (and copy) it
    launches, by short kernel name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ("device_time_total" if hasattr(events[0], "device_time_total")
           else "cuda_time_total")
    out = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        base = (e.key.replace("(anonymous namespace)::", "").split("(")[0]
                .strip().removeprefix("void "))
        head, _, tmpl = base.partition("<")
        if len(tmpl) > 24:
            tmpl = tmpl[:20] + "...>"
        name = head.split("::")[-1] + ("<" + tmpl if tmpl else "")
        out[name] = out.get(name, 0.0) + getattr(e, key) / calls / 1e3
    return out


def profile_window(fn: Callable, steps: int = 2,
                   table_path: Optional[str] = None) -> dict:
    """torch.profiler over `steps` calls of `fn` on the card: the device's
    busy time (the union of kernel intervals) against the host window, its
    idle share, and the top operations by self device time (the whole
    table written to `table_path` when given)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    n_kernels, busy_ms = _device_busy(prof)
    averages = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    if table_path is not None:
        os.makedirs(os.path.dirname(table_path) or ".", exist_ok=True)
        with open(table_path, "w") as f:
            f.write(averages.table(sort_by=key, row_limit=40))
    top = sorted(((getattr(e, key), e.key) for e in averages
                  if e.device_type != DeviceType.CUDA
                  and getattr(e, key) > 0), reverse=True)[:12]
    return {"window_ms": window_ms, "steps": steps,
            "kernels": n_kernels, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / window_ms) if n_kernels
            else None,
            "top_ops_self_device_ms": [[k, t / 1e3 / steps] for t, k in top]}


def _device_busy(prof):
    """(kernels, ms): the device events of a torch.profiler window and
    the union of their intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return len(spans), busy_us / 1e3


def device_idle_share(fn: Callable) -> float:
    """The share of one call of `fn` (host clock, synchronised) in which
    the card runs no kernel, from a torch.profiler window that traces the
    device alone (`profile_window` also traces the host's operations,
    whose bookkeeping takes seconds over a call of some 10^4 launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    return 1 - _device_busy(prof)[1] / window_ms


def card() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (its
    first line); raises when nvidia-smi fails."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


class Segments:
    """Named segments of one eager pass. `begin(name)` starts a segment
    (ending the one before), `end()` ends the last; `inside(name)` gives
    the time of a nested region (the resizes inside a stream, say) to
    `name` and then returns to the enclosing segment. `ms()` -> ({name:
    ms}, in the order first begun, a name begun twice summed; the whole
    pass's ms).

    On the card each boundary is a CUDA event, so a segment is the device
    time between two events: eager PyTorch does not fuse across them, so a
    segment times its own work (the stream's order puts any device idle
    time between launches into the segment it falls in). On the CPU the
    boundaries are the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: List[tuple] = []

    def _mark(self, name: Optional[str]) -> None:
        if self.cuda:
            now = torch.cuda.Event(enable_timing=True)
            now.record()
        else:
            now = time.perf_counter()
        self._marks.append((name, now))

    @property
    def current(self) -> Optional[str]:
        return self._marks[-1][0] if self._marks else None

    def begin(self, name: str) -> None:
        self._mark(name)

    def end(self) -> None:
        self._mark(None)

    @contextlib.contextmanager
    def inside(self, name: str):
        outer = self.current
        self._mark(name)
        try:
            yield
        finally:
            self._mark(outer)

    @contextlib.contextmanager
    def at_modules(self, before: Dict[torch.nn.Module, str],
                   after: Optional[Dict[torch.nn.Module, str]] = None):
        """Within the block, a call of each module of `before` begins its
        segment as the module starts, and each module of `after` begins
        its segment as the module returns (forward hooks: the modules'
        own code runs unchanged)."""
        handles = []
        try:
            for m, name in before.items():
                handles.append(m.register_forward_pre_hook(
                    lambda *_, name=name: self.begin(name)))
            for m, name in (after or {}).items():
                handles.append(m.register_forward_hook(
                    lambda *_, name=name: self.begin(name)))
            yield self
        finally:
            for h in handles:
                h.remove()

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for (name, a), (_, b) in zip(self._marks, self._marks[1:]):
            if name is None:
                continue
            d = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + d
        first, last = self._marks[0][1], self._marks[-1][1]
        whole = (first.elapsed_time(last) if self.cuda
                 else (last - first) * 1e3)
        return out, whole
