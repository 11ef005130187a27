"""How far the port's long-run check (saunet_tpu_torch/cli/fidelity.py)
moves with the summation order alone: the spreads that `STAT_BOUNDS` and
tests/test_torch_convergence.py's logits tolerances are set from.

    python tests/torch_golden/spread_stat.py                # 'stat-cpu'
    python tests/torch_golden/spread_stat.py --device cuda  # 'stat'
    python tests/torch_golden/spread_stat.py --goldens A B  # two goldens

`--device cpu` (the default) runs 'stat-cpu' on one intra-op thread, with
oneDNN off, on three threads and on eight (about a minute on the CPU).
`--device cuda` runs 'stat' on the card under cuDNN's three algorithm
choices: its heuristic, `deterministic` and `benchmark` (TF32 off, as in
the gate; about 50 s each). `--goldens` trains nothing and reads 'stat'
records that make_convergence.py wrote (`--out`) on other core counts.

For each run or golden it prints the final mIoU under the running and
under the batch statistics, and the largest relative loss difference
from the committed golden over the config's `loss_steps`; for each pair,
the largest relative loss difference over those steps, the final mIoU
differences and, where both records hold them, the last eval point's
largest logits difference over max|ref|; then the largest of each over
the pairs. The last line is all of it as one JSON object.
"""
import argparse
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from saunet_tpu_torch.cli import fidelity as gate  # noqa: E402

# name -> (intra-op threads, oneDNN on)
CPU_ORDERS = {"1 thread": (1, True), "oneDNN off": (1, False),
              "3 threads": (3, True), "8 threads": (8, True)}
# name -> (cudnn.deterministic, cudnn.benchmark)
CUDNN_ORDERS = {"cuDNN heuristic": (False, False),
                "cuDNN deterministic": (True, False),
                "cuDNN benchmark": (False, True)}


def cpu_runs() -> dict:
    runs = {}
    for name, (threads, mkldnn) in CPU_ORDERS.items():
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = mkldnn
        runs[name] = gate.run_convergence("stat-cpu", "cpu",
                                          return_logits=True)
    return runs


def card_runs() -> dict:
    runs = {}
    for name, (deterministic, benchmark) in CUDNN_ORDERS.items():
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
        runs[name] = gate.run_convergence("stat", "cuda")
    return runs


def spreads(config: str, runs: dict) -> dict:
    n = gate.STAT_BOUNDS[config]["loss_steps"]

    def loss_rel(a, b) -> float:
        ref = np.asarray(b["loss"][:n], np.float64)
        return float(np.max(np.abs(np.asarray(a["loss"][:n]) - ref)
                            / np.abs(ref)))

    golden = gate.load_golden(config)
    out = {"config": config, "loss_steps": n, "runs": {}, "pairs": {}}
    for name, r in runs.items():
        rec = {"final_miou_running": float(r["miou_running"][-1]),
               "final_miou_batch": float(r["miou_batch"][-1]),
               "loss_rel_to_golden": loss_rel(r, golden)}
        out["runs"][name] = rec
        print(f"{name}: final mIoU running {rec['final_miou_running']:.6f}"
              f" batch {rec['final_miou_batch']:.6f}; loss against the "
              f"golden {rec['loss_rel_to_golden']:.4e}")
    for a, b in itertools.combinations(runs, 2):
        ra, rb = runs[a], runs[b]
        rec = {"loss_rel": loss_rel(ra, rb)}
        for kind in ("running", "batch"):
            rec[f"miou_{kind}"] = abs(float(ra[f"miou_{kind}"][-1])
                                      - float(rb[f"miou_{kind}"][-1]))
            if f"logits_{kind}" in ra and f"logits_{kind}" in rb:
                la, lb = ra[f"logits_{kind}"], rb[f"logits_{kind}"]
                rec[f"logits_{kind}"] = float(np.abs(la - lb).max()
                                              / np.abs(lb).max())
        out["pairs"][f"{a} vs {b}"] = rec
        print(f"{a} vs {b}: " + "; ".join(f"{k} {v:.4e}"
                                           for k, v in rec.items()))
    out["largest"] = {k: max(p[k] for p in out["pairs"].values())
                      for k in next(iter(out["pairs"].values()))}
    print("largest: " + "; ".join(f"{k} {v:.4e}"
                                  for k, v in out["largest"].items()))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--goldens", nargs="+", metavar="NPZ",
                   help="'stat' records to hold against each other (no "
                        "training)")
    args = p.parse_args(argv)
    if args.goldens:
        config = "stat"
        runs = {path: gate.load_golden(config, path)
                for path in args.goldens}
    elif args.device == "cuda":
        config, runs = "stat", card_runs()
    else:
        config, runs = "stat-cpu", cpu_runs()
    print(json.dumps(spreads(config, runs)))


if __name__ == "__main__":
    main()
