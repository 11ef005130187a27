"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout (BENCHMARK.json, portbench/, and the port,
saunet_tpu_torch/). The last line of standard output is the result (see
portbench/harness.py); the numbers that decide `correct` are the last lines
of standard error. Exits 2 without a result when there is no CUDA card or
fewer cards than the cell asks for, 3 when a JAX module was loaded by the
time the result would print. The kernel and compiler caches are kept in
the checkout, under build/portbench/, at fixed paths.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from portbench import harness
    from portbench.drivers.common import Cell

    args = harness.parse_args(argv)
    cell = harness.find_cell(harness.spec(), args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    run = Cell(name=args.workload, config=cell["config"],
               traffic=cell["traffic"], limits=cell["limits"],
               seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
               device=torch.device("cuda", 0))
    out = harness.driver_module(cell["driver"]).run(run)
    # set-up without the reference's calibration forward, which only the
    # benchmark runs
    setup_s = out["window_start"] - T_START - out["reference_setup_s"]
    bad = harness.forbidden_loaded()
    if bad:
        print(f"JAX modules loaded in the benchmark's process: {bad}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    line = harness.result_line(cell, out, setup_s, bool(args.trace), info)
    sys.stdout.flush()
    print(f"set-up {setup_s!r} s; the reference's calibration "
          f"{out['reference_setup_s']!r} s, left out", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
