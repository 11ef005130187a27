"""One run of one cell: find its files by the names in `BENCHMARK.json`,
run its driver, read its metrics, print the result.

    BENCHMARK.json workloads[i]   {name, config, traffic, chips, why}
    configs/<config>.json         the configuration as it is run
    traffic/<traffic>.json        the mix; its "driver" names a file of
                                  drivers/
    limits/<workload>.json        the limit of each number `correct` compares
    metrics/<metric>.py           a per-layer metric's reader: read(record)

With `--trace 0` the result's metrics are the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read from the traced window's
record by each metric's own file (a reader that finds nothing to read
returns None, and the metric is left out of the line).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that may not be loaded by the time the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "saunet_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The port's benchmark: one run "
                                            "of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """{workload, config, traffic, limits, driver, e2e, per_layer} of the
    cell `name`: its entries and its files, found by name under `root`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / "portbench"

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    return {"workload": w,
            "config": load_json(root / configs[w["config"]]["file"]),
            "traffic": traffic,
            "limits": load_json(bench_dir / "limits" / f"{name}.json"),
            "driver": traffic["driver"], "e2e": e2e,
            "per_layer": [m for m in bench["per_layer"]
                          if applies(m) and m["moves"] in moved]}


def driver_module(name: str):
    """drivers/<name>.py, the general generator a mix names."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """metrics/<name>.py (a metric's name holds dots, so the file is loaded
    by its path)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    module = f"portbench_metric_{abs(hash(str(path)))}"
    if module in sys.modules:
        return sys.modules[module]
    spec_ = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[module] = mod
    spec_.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: dict, out: dict, setup_s: float, trace: bool,
                device_info: dict, root: Path = ROOT) -> dict:
    """The contract's last line: correct, attempted, failed, metrics,
    device, breakdown (traced runs) and, last, the numbers compared."""
    from .reference.judge import passed

    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = metric_reader(m["name"], root).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell["e2e"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=out["peak_bytes"])
    line = {"correct": passed(out["checks"]) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    prof = out.get("profile")
    if trace and prof is not None:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out["checks"]}
    return line
