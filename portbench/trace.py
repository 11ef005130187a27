"""What the traced run records: named marks in each step (CUDA events on
the card, the host clock elsewhere) and a torch.profiler window.

`Marks` keeps, for every step or request, the marks set at the layer
boundaries (forward hooks of the model's own modules, the optimizer's step
hooks, calls the harness wraps); `Marks.spans(pairs)` turns them into each
step's milliseconds between two named marks once the window has closed. A
CUDA event costs the card nothing, so the traced window runs as the timed
one does.

`profile(fn)` runs `fn` under torch.profiler and returns the device's busy
time (the union of its kernels' intervals, from a pass that traces the
device alone), the window's host-clock length, the device operations that
took most time, and the longest idle gaps of the device by what the host
was running then (from a second pass that traces the host too).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch


class Marks:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.active = False
        self.steps: List[List[Tuple[str, object]]] = []

    def new_step(self) -> None:
        """Begin the next step's marks (and start marking)."""
        self.active = True
        self.steps.append([])

    def mark(self, name: str) -> None:
        if not self.active:
            return
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        else:
            event = time.perf_counter()
        self.steps[-1].append((name, event))

    def spans(self, pairs: Dict[str, Tuple[str, str]]
              ) -> List[Dict[str, float]]:
        """Each step's {span: ms from its first mark to its second}; a span
        whose marks a step lacks is left out of that step."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for marks in self.steps:
            at = dict(marks)
            step = {}
            for span, (a, b) in pairs.items():
                if a in at and b in at:
                    step[span] = (at[a].elapsed_time(at[b]) if self.cuda
                                  else (at[b] - at[a]) * 1e3)
            out.append(step)
        return out


def _short(name: str) -> str:
    base = (name.replace("(anonymous namespace)::", "").split("(")[0]
            .strip().removeprefix("void "))
    head, _, tmpl = base.partition("<")
    return head.split("::")[-1] + ("<" + tmpl[:20] + ">" if tmpl else "")


def _union(spans):
    busy, end = 0.0, None
    gaps = []
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def _window(fn, activities):
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof.events(), window_s


def profile(fn: Callable[[], None], top: int = 10) -> Optional[dict]:
    """Run `fn` twice under torch.profiler on the card: once tracing the
    device alone, for its busy time against the window (tracing the host's
    operations too slows the host by a fifth and would read as idle
    device), then host and device, for the operations that took most time
    and what the host ran during the device's idle gaps. {busy_s,
    window_s, device_ops, idle_gaps}; None without a card."""
    if not torch.cuda.is_available():
        fn()
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    events, window_s = _window(fn, [ProfilerActivity.CUDA])
    busy_us, _ = _union((e.time_range.start, e.time_range.end)
                        for e in events if e.device_type == DeviceType.CUDA)
    events, _ = _window(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    _, gaps = _union((e.time_range.start, e.time_range.end) for e in device)
    by_op: Dict[str, float] = defaultdict(float)
    for e in device:
        by_op[_short(e.name)] += (e.time_range.end - e.time_range.start) / 1e6
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type == DeviceType.CPU]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
        mid = (a + b) / 2
        inner = min(((e - s, n) for s, e, n in host if s <= mid <= e),
                    default=(0, "python (no profiled host op)"))
        by_host[inner[1]] += (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                key=lambda kv: -kv[1])[:top]}
