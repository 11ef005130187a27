"""What the profilers share: the JAX tools' default geometry, the seeded
full-width model and synthetic batch, the timing of a whole function and
of a segmented pass, the launch-count check, and the report (a readable
table and one JSON line a mode).

On the card a time is a median of CUDA-event runs (device time between
the events of one stream); on the CPU it is the host clock, and the
report says so: a CPU time is never a device time.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from ..models import build_unet
from ..models.init import calibrate_bn_, init_random_
from ..ops.cuda import launches, zero_launches
from ..train.state import resolve_device
from ..utils import profiling
from ..utils.profiling import Segments

#: the JAX tools' defaults (PROF_BATCH, PROF_HW)
PROF_BATCH, PROF_HW = 64, 224
#: slices that set the random model's BatchNorm statistics
CALIBRATION_SLICES = 8
#: every mode's weights and data come from generators seeded from this
SEED = 0


class _NoSegments:
    """A `Segments` that records nothing: the same pass, uninstrumented."""

    def begin(self, name):
        pass

    def end(self):
        pass

    def inside(self, name):
        return contextlib.nullcontext()

    def at_modules(self, before, after=None):
        return contextlib.nullcontext()


NO_SEGMENTS = _NoSegments()


def device_of(name: Optional[str]) -> torch.device:
    """The profilers' device: the card unless another is named (raises
    without a card)."""
    return resolve_device(name)


def synthetic_batch(gen: torch.Generator, n: int, hw: int,
                    device) -> Dict[str, torch.Tensor]:
    """The JAX tools' batch, drawn from `gen`: images uniform in [0, 1)
    (n, hw, hw, 3), labels uniform in 0..3, edge targets 1 where a uniform
    draw passes 0.8."""
    image = torch.rand((n, hw, hw, 3), generator=gen)
    label = torch.randint(0, 4, (n, hw, hw), generator=gen,
                          dtype=torch.int32)
    edge = (torch.rand((n, hw, hw, 1), generator=gen) > 0.8).float()
    return {k: v.to(device) for k, v in
            (("image", image), ("label", label), ("edge", edge))}


def seeded_model(device, hw: int, gen: torch.Generator,
                 dtype: str = "bfloat16", **kwargs):
    """The full-width SAUNet (`build_unet(dtype=dtype, **kwargs)`) with
    weights drawn from `gen` and BatchNorm statistics taken from
    CALIBRATION_SLICES synthetic slices (random statistics let activations
    grow without bound through the encoder), on `device`, in eval mode."""
    model = init_random_(build_unet(dtype=dtype, **kwargs), gen).to(device)
    calib = synthetic_batch(gen, CALIBRATION_SLICES, hw, device)["image"]
    return calibrate_bn_(model, calib.permute(0, 3, 1, 2)).eval()


def whole_ms(fn: Callable, device: torch.device, steps: int) -> float:
    """Median ms of `fn()` over `steps` runs: CUDA events after one
    warm-up on the card (cuDNN's algorithm choice and the kernels' builds
    fall in the first call); the host clock on the CPU, with no warm-up
    (a CPU time is no device measurement, and the tests run every mode
    there)."""
    if device.type == "cuda":
        return profiling.cuda_ms(fn, runs=steps, warmup=1)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def segment_ms(pass_fn: Callable[[Segments], object], device: torch.device,
               steps: int):
    """`pass_fn(segments)` `steps` times (after one warm-up pass on the
    card): ({segment: median ms}, median of the passes' wholes)."""
    if device.type == "cuda":
        pass_fn(Segments(device))
    runs, wholes = [], []
    for _ in range(steps):
        seg = Segments(device)
        pass_fn(seg)
        ms, whole = seg.ms()
        runs.append(ms)
        wholes.append(whole)
    names = list(runs[0])
    return ({n: statistics.median(r[n] for r in runs) for n in names},
            statistics.median(wholes))


def route_rows(passes: Dict[str, Callable], device: torch.device,
               steps: int, jax_names: Dict[str, str], whole_jax: str):
    """Each route's segments (`pass_fn(segments)`, its segments' medians)
    and the route timed whole, uninstrumented (`pass_fn()`): (rows,
    {route: {segments_ms, whole_ms, ratio}})."""
    rows, routes = [], {}
    for name, fn in passes.items():
        segs, _ = segment_ms(fn, device, steps)
        whole = whole_ms(fn, device, steps)
        total = sum(segs.values())
        routes[name] = {"segments_ms": total, "whole_ms": whole,
                        "ratio": total / whole}
        rows += [row(f"{name}/{s}", ms, jax_names[s])
                 for s, ms in segs.items()]
        rows.append(row(f"{name}_route", whole, whole_jax,
                        segments_sum_ms=total))
    return rows, routes


def check_launches(fn: Callable, expected: Dict[str, int],
                   device: torch.device, what: str) -> Optional[dict]:
    """On the card: zero the kernel counters, call `fn()` once and require
    exactly `expected` launches (a kernel not named: none); returns the
    counts. On the CPU the wrappers run their plain versions and count
    nothing, so there is nothing to check: None."""
    if device.type != "cuda":
        return None
    zero_launches()
    fn()
    torch.cuda.synchronize()
    got = launches()
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise RuntimeError(f"{what}: kernel launches {got}, expected {want}")
    return got


def card_of(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or what a CPU time
    is."""
    if device.type == "cuda":
        return profiling.card()
    return "cpu: host-clock times, not device times"


def row(name: str, ms: Optional[float], jax: str, **extra) -> dict:
    """One line of a report: the port's segment, its ms and the row of
    the JAX tool that it answers to."""
    return {"name": name, "ms": ms, "jax": jax, **extra}


def report(mode: str, device: torch.device, tool: str, rows: List[dict],
           **extra) -> dict:
    return {"profile": mode, "device": str(device), "card": card_of(device),
            "jax_tool": tool, **extra, "rows": rows}


def print_table(result: dict) -> None:
    """The report as a readable table: the mode, the card, then a line a
    row (segment, ms, [the JAX tool's row], anything more)."""
    head = {k: v for k, v in result.items()
            if k not in ("rows", "profile", "card", "jax_tool")
            and not isinstance(v, (dict, list))}
    print(f"== {result['profile']} ({result['jax_tool']}): {head}")
    print(result["card"])
    for r in result["rows"]:
        ms = "" if r["ms"] is None else f"{r['ms']:10.3f} ms"
        more = {k: v for k, v in r.items() if k not in ("name", "ms", "jax")}
        extra = "  " + json.dumps(more) if more else ""
        print(f"{r['name']:<34s} {ms:>13s}   [{r['jax']}]{extra}")
    sys.stdout.flush()


def print_report(result: dict) -> None:
    """The table, then the JSON line."""
    print_table(result)
    print(json.dumps(result), flush=True)
