"""Read the numbers that `correct` compares over many seeds in one
process, for setting and checking their limits (not run by the benchmark's
own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control fp8|bf16] [--fault altered_answer]

For each seed it runs the cell's driver with a short window and prints one
JSON line: the seed, the program's readings against the reference and,
with `--control`, the control's (the reference with its convolutions'
operands in that precision, in the program's place); with `--fault`, the
program runs with that fault planted (portbench/faults.py).
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from portbench import faults, harness
    from portbench.drivers.common import Cell
    from portbench.reference import judge

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    cell = harness.find_cell(harness.spec(), args.workload)
    driver = harness.driver_module(cell["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Cell(name=args.workload, config=cell["config"],
                   traffic=cell["traffic"], limits=cell["limits"], seed=seed,
                   seconds=args.seconds, device=torch.device(args.device),
                   control=args.control)
        planted = (faults.FAULTS[args.fault]() if args.fault
                   else contextlib.nullcontext())
        with planted:
            out = driver.run(run)
        line = {"seed": seed, "fault": args.fault,
                "checks": {n: v for n, v, _ in out["checks"]},
                "correct": judge.passed(out["checks"]),
                "seconds": time.perf_counter() - t0}
        line.update(out["readings"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
