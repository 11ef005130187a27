"""One serving window of a benchmark cell as the benchmark's untraced run
serves it, with the infer step's counters read around the window:

    python -m saunet_tpu_torch.profile.serve_window <workload> \\
        [--seed N] [--seconds S] [--profile]

from the root of the repo, on the card. It runs the cell's own driver
(portbench/drivers/) unchanged and prints one JSON line: the card, the
window's end-to-end readings, its steps (`attempted`), the infer step's
`eager_calls`, `captures` and `replays` inside the window and in all, the
share of the window's steps that replayed a graph, the allocated peak of
the window and the bytes reserved at its end (the graphs' memory pool is
reserved at capture, in set-up, so the allocated peak leaves it out), the
`correct` checks and the set-up seconds.

With `--profile` the cell's traced run is made with its forward hooks left
unregistered, so the step runs as in the untraced window (graphed), and
portbench/trace.py's `profile` of the volumes after the window adds the
device's idle share, its busy ops and its idle gaps by host op.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from .. import train
from . import common

COUNTERS = ("eager_calls", "captures", "replays")


class _Dropped:
    def remove(self) -> None:
        pass


@contextlib.contextmanager
def _patched(obj, **attrs):
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


def run(workload: str, seed: int, seconds: float,
        profile: bool = False) -> dict:
    from portbench import harness
    from portbench.drivers.common import Cell

    t0 = time.perf_counter()
    cell = harness.find_cell(harness.spec(), workload)
    driver = harness.driver_module(cell["driver"])
    device = torch.device("cuda", 0)
    steps, at = [], {}
    make, reset, peak = (train.make_infer_step, driver.peak_reset,
                         driver.peak_bytes)

    def counts() -> dict:
        return {k: sum(getattr(s, k) for s in steps) for k in COUNTERS}

    def made(*args, **kwargs):
        steps.append(make(*args, **kwargs))
        return steps[-1]

    def window_starts(dev):  # the driver resets the peak just before
        at["start"] = counts()
        reset(dev)

    def window_ends(dev):  # and reads it just after
        at["end"] = counts()
        at["reserved"] = torch.cuda.memory_reserved(dev)
        return peak(dev)

    hooks = ({"register_forward_hook": lambda *a, **k: _Dropped(),
              "register_forward_pre_hook": lambda *a, **k: _Dropped()}
             if profile else {})
    with _patched(train, make_infer_step=made), \
            _patched(driver, peak_reset=window_starts,
                     peak_bytes=window_ends), \
            _patched(torch.nn.Module, **hooks):
        out = driver.run(Cell(name=workload, config=cell["config"],
                              traffic=cell["traffic"], limits=cell["limits"],
                              seed=seed, seconds=seconds, trace=profile,
                              device=device))
    window = {k: at["end"][k] - at["start"][k] for k in COUNTERS}
    result = {"card": common.card_of(device), "workload": workload,
              "seed": seed, "seconds": seconds, "profile": profile,
              "e2e": out["e2e"], "attempted": out["attempted"],
              "window": window, "total": counts(),
              "replayed_share": window["replays"] / max(out["attempted"], 1),
              "peak_bytes": out["peak_bytes"],
              "reserved_bytes": at["reserved"],
              "checks": out["checks"],
              "setup_s": out["window_start"] - t0 - out["reference_setup_s"]}
    prof = out.get("profile")
    if prof:
        result.update(idle_pct=100 * (1 - prof["busy_s"] / prof["window_s"]),
                      busy_s=prof["busy_s"], window_s=prof["window_s"],
                      device_ops=prof["device_ops"],
                      idle_gaps=prof["idle_gaps"])
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workload", help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, default=1618033988)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--profile", action="store_true",
                   help="the traced run, its hooks left unregistered")
    args = p.parse_args(argv)
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         args.profile)))


if __name__ == "__main__":
    main()
