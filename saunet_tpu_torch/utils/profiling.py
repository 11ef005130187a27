"""Tracing and step timing (counterpart of saunet_tpu/utils/profiling.py):

  trace(dir):      a torch.profiler window over the host and the card,
                   written to `dir` as a TensorBoard-loadable trace.
  annotate(name):  a named region: a profiler range, and an NVTX range
                   when a card is present.
  StepTimer:       host-clock step timing that synchronises the card at
                   both ends of a step, excludes the first `skip` steps
                   (warm-up) and summarises percentiles.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


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
