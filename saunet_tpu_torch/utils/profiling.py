"""Tracing and step timing (counterpart of saunet_tpu/utils/profiling.py):

  trace(dir):      a torch.profiler window over the host and the card,
                   written to `dir` as a TensorBoard-loadable trace.
  annotate(name):  the program's span: host clock at both ends into a
                   bounded ring, always; a profiler range while a
                   torch.profiler session is active. `span_records()`
                   reads the ring, `clear_spans()` empties it,
                   `span_device_times(events)` finds what the card did
                   under the spans in a session's events, and
                   `span_summary()` sums it all up by name.

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

import bisect
import contextlib
import itertools
import os
import statistics
import subprocess
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

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


#: records the span ring keeps, the oldest dropped first: a 51 s window of
#: some 2 500 volumes at six spans a volume fills a quarter of it
SPAN_RING = 65536


class SpanRecord(NamedTuple):
    """One span: its request (the id its outermost span opened), name, the
    enclosing span's name (None for the outermost) and the host clock at
    both ends (`time.perf_counter_ns`)."""
    request: int
    name: str
    parent: Optional[str]
    t0_ns: int
    t1_ns: int

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


# The ring is process-wide, as torch.profiler's own state is: the
# benchmark's readers find the records without a handle through the steps.
# Each thread nests its own spans.
_ring: deque = deque(maxlen=SPAN_RING)
_threads = threading.local()
_requests = itertools.count(1)


#: the span's profiler range: an operation on the host's timeline.
#: `torch.profiler.record_function` would also put a user annotation on the
#: device's timeline over the kernels it enqueues, which a reader of the
#: device's events (portbench/trace.py) takes for device work, filling the
#: idle gaps the span is there to name.
_profiler_range = torch._C._profiler._RecordFunctionFast


class Span:
    """`with annotate(name):` see `annotate`."""

    __slots__ = ("name", "_request", "_parent", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _threads.__dict__.setdefault("open", [])
        if stack:
            self._request, self._parent = stack[-1]
        else:
            self._request, self._parent = next(_requests), None
        stack.append((self._request, self.name))
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _threads.open.pop()
        _ring.append(SpanRecord(self._request, self.name, self._parent,
                                self._t0, t1))
        return False


def annotate(name: str) -> Span:
    """The program's span: `with annotate(name): ...`. It always takes the
    host clock at both ends and appends one record to the span ring (no
    I/O, no device memory, no synchronize); the outermost open span of a
    thread opens a new request id, and a nested one takes that id and its
    parent's name. While a torch.profiler session is active it also opens
    a profiler range of that name, so the span sits in the trace beside
    the operations it runs and the kernels they launch
    (`span_device_times` reads them from there)."""
    return Span(name)


def span_records() -> List[SpanRecord]:
    """The ring's records, oldest first."""
    return list(_ring)


def clear_spans() -> None:
    """Empty the span ring."""
    _ring.clear()


def span_device_times(events, names) -> tuple:
    """What the card did under the spans named in `names`, from a
    torch.profiler session's events (host and card, `prof.events()`):
    ({name: [device ms of the kernels and copies launched inside each of
    its ranges, nested spans' included]}, {name: ms the device idled while
    that span was the innermost one open on the host}, with the idle
    outside every span under None). A kernel or copy is placed at the
    runtime call that launched it (`cudaLaunchKernel`, `cudaMemcpyAsync`:
    the host event with its correlation id)."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in host if e.name in names]
    calls = {e.id: e.time_range.start for e in host
             if e.name.startswith("cu")}
    launches = [(calls.get(e.id), e.time_range.start, e.time_range.end)
                for e in events if e.device_type == DeviceType.CUDA]
    return attribute_to_spans(spans, launches) if launches else ({}, {})


def attribute_to_spans(spans, launches) -> tuple:
    """`span_device_times` on plain intervals: `spans` [(t0, t1, name)],
    properly nested, and `launches` [(launched at or None, start, end)] on
    the device, all on one clock."""
    at = sorted((t, b - a) for t, a, b in launches if t is not None)
    times = [t for t, _ in at]
    total = np.concatenate([[0.0], np.cumsum([d for _, d in at])])
    device: Dict[str, List[float]] = {}
    for t0, t1, name in spans:
        lo, hi = bisect.bisect_left(times, t0), bisect.bisect_right(times, t1)
        device.setdefault(name, []).append(float(total[hi] - total[lo]) / 1e3)

    gaps, end = [], None
    for _, a, b in sorted(launches, key=lambda k: k[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    idle: Dict[Optional[str], float] = {}
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, k = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(ordered) and ordered[k][0] <= mid:
            while stack and stack[-1][1] < ordered[k][0]:
                stack.pop()
            stack.append(ordered[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else None
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e3
    return device, idle


def span_summary(events=None) -> dict:
    """{name: {count, parent, host_ms_median, host_ms_p95[,
    device_ms_median, idle_ms]}} over the ring's records; with the events
    of the spans' torch.profiler session, where it traced the card
    (`events`), each span's median device ms and the ms the device idled
    under it (`span_device_times`), and the idle outside every span as
    the row "(outside the spans)"."""
    by_name: Dict[str, List[SpanRecord]] = {}
    for r in span_records():
        by_name.setdefault(r.name, []).append(r)
    device, idle = (span_device_times(events, set(by_name))
                    if events is not None else ({}, {}))
    out = {}
    for name, rs in by_name.items():
        host = [r.host_ms for r in rs]
        row = {"count": len(rs), "parent": rs[0].parent,
               "host_ms_median": statistics.median(host),
               "host_ms_p95": float(np.percentile(host, 95))}
        if name in device:
            row["device_ms_median"] = statistics.median(device[name])
            row["idle_ms"] = idle.get(name, 0.0)
        out[name] = row
    if device:
        out["(outside the spans)"] = {"idle_ms": idle.get(None, 0.0)}
    return out


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
