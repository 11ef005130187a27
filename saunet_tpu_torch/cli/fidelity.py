"""Trajectory gate: `python -m saunet_tpu_torch.cli.fidelity [--config
card|cpu] [--golden PATH] [--device cuda|cpu]` (counterpart of
tools/fidelity.py::run_deterministic).

The port trains an f32 SAUNet from the JAX package's golden weights over
the golden's phantom batches and holds each step's loss against the JAX
package's, read from tests/torch_golden/trajectory.npz
(tests/torch_golden/make_trajectory.py writes it with the JAX
`make_train_step`). The same init on both sides: `fill_from_seed_` draws
the numpy weights that the JAX run started from (WEIGHT_SEED, the `fuse`
kernel scaled by FUSE_SCALE), so no jax is needed here. The data: phantom
slices (`make_phantom_set`, PHANTOM_SEED), their edge ground truth, the
batch order of `batches` (SCHEDULE_SEED), radam(LR), no augmentation (the
two frameworks' generators differ). The configs: 'card', 50 steps at 64^2,
batch 4 of 16 slices (docs/FIDELITY.md §1); 'cpu', the CPU test's 8 steps
at 64^2, batch 2 of 8. RAdam takes its momentum-SGD branch for updates 1-5
and the rectified one from update 6 (n_sma 4.996, then 5.994), so the
losses of steps 7 and 8 are the first to show the rectified step. Not the
JAX CPU gate's 32^2 (tests/test_fidelity.py): there the center block's
BatchNorm normalises 2 values a channel (1x1 maps), and the port's own
losses move by 2.3e-2 with the summation order alone (intra-op threads,
oneDNN on or off) over 12 steps, more than the bound; at 64^2 (2x2 maps, 8
values), by at most 4.4e-4 over these 8.

It prints each step's loss beside the golden's and their relative
difference, and exits 1 when the largest difference passes the config's
MAX_REL_DIFF or the first step's passes FIRST_REL_DIFF. The card's bounds
are tests/test_fidelity.py's (0.02, 2e-3). The 'cpu' config's per-step
bound is 2e-3: over 8 steps the port differs from itself under another
summation order by at most 4.4e-4, while a RAdam switch one update early or
late, or a step count off by one, moves some step's loss by 5.3e-3 to
1.2e-2, which the 0.02 bound would let through.
It runs on the card (TF32 off) unless `--device` names another device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..data import edge_ground_truth, make_phantom_set
from ..models import build_unet
from ..models.init import fill_from_seed_
from ..train import create_train_state, make_train_step, radam
from ..train.state import resolve_device

CONFIGS = {"card": {"hw": 64, "batch": 4, "n_train": 16, "steps": 50},
           "cpu": {"hw": 64, "batch": 2, "n_train": 8, "steps": 8}}
LR = 1e-3
PHANTOM_SEED, SCHEDULE_SEED, WEIGHT_SEED = 0, 123, 0
FUSE_SCALE = 0.05
PARTS = ("loss", "ce", "dice", "edge")
MAX_REL_DIFF = {"card": 0.02, "cpu": 2e-3}
FIRST_REL_DIFF = 2e-3
GOLDEN = (Path(__file__).resolve().parents[2] / "tests" / "torch_golden"
          / "trajectory.npz")


def batches(n: int, batch: int, steps: int, seed: int) -> List[np.ndarray]:
    """The index of each step's samples: whole shuffles of range(n), cut
    into batches (a last partial one dropped), `steps` of them
    (tools/fidelity.py::_batches)."""
    rs = np.random.RandomState(seed)
    order = []
    while len(order) < steps:
        idx = np.arange(n)
        rs.shuffle(idx)
        order.extend(idx[i:i + batch]
                     for i in range(0, n - n % batch, batch))
    return order[:steps]


def phantom_data(hw: int, n_train: int) -> Dict[str, np.ndarray]:
    """The gate's slices: image (n, hw, hw, 3) f32 (the z-scored phantom
    in 3 channels), label (n, hw, hw) int32, edge (n, hw, hw, 1) f32."""
    imgs, labels = make_phantom_set(n_train, hw=hw, seed=PHANTOM_SEED)
    edge = edge_ground_truth(torch.from_numpy(labels)).numpy()
    return {"image": np.repeat(imgs[..., None], 3, axis=-1),
            "label": labels, "edge": edge}


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convs and matmuls inside the block."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def run_trajectory(config: str, device=None, **model_kwargs
                   ) -> Dict[str, list]:
    """Train the port for the config's steps; returns each step's loss
    parts ({'loss': [...], 'ce': ..., 'dice': ..., 'edge': ...}) and its
    seconds ('seconds', host clock after a synchronise)."""
    cfg = CONFIGS[config]
    device = resolve_device(device)
    model = build_unet(dtype="float32", **model_kwargs)
    fill_from_seed_(model, WEIGHT_SEED, FUSE_SCALE)
    tx = radam(LR)
    state = create_train_state(model, tx, device)
    step = make_train_step(model, tx)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in phantom_data(cfg["hw"], cfg["n_train"]).items()}
    out: Dict[str, list] = {k: [] for k in PARTS + ("seconds",)}
    with full_f32():
        for sel in batches(cfg["n_train"], cfg["batch"], cfg["steps"],
                           SCHEDULE_SEED):
            t0 = time.perf_counter()
            idx = torch.from_numpy(np.asarray(sel)).to(device)
            state, metrics = step(state, {k: v[idx]
                                          for k, v in data.items()})
            for k in PARTS:
                out[k].append(float(metrics[k]))
            out["seconds"].append(time.perf_counter() - t0)
    return out


def load_golden(config: str, path=GOLDEN) -> Dict[str, np.ndarray]:
    """The JAX package's per-step loss parts of `config`; raises when the
    file was written for another config."""
    with np.load(path) as z:
        golden = {k: z[f"{config}/{k}"] for k in PARTS}
        written = {k: int(z[f"{config}/{k}"]) for k in CONFIGS[config]}
    if written != CONFIGS[config]:
        raise ValueError(f"{path} holds config {written}, not "
                         f"{CONFIGS[config]}")
    return golden


def compare(port: Dict[str, list], golden: Dict[str, np.ndarray],
            config: str) -> dict:
    """Relative differences of the port's per-step losses from the
    golden's, the largest and the first, and whether they meet the
    config's bounds."""
    ref = golden["loss"].astype(np.float64)
    rel = np.abs(np.asarray(port["loss"]) - ref) / np.maximum(np.abs(ref),
                                                              1e-8)
    return {"rel_diff": rel.tolist(), "max_rel_diff": float(rel.max()),
            "first_rel_diff": float(rel[0]),
            "ok": bool(rel.max() < MAX_REL_DIFF[config]
                       and rel[0] < FIRST_REL_DIFF)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Hold the port's training trajectory against the JAX "
                    "package's")
    p.add_argument("--config", default="card", choices=sorted(CONFIGS))
    p.add_argument("--golden", default=str(GOLDEN))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    golden = load_golden(args.config, args.golden)
    t0 = time.perf_counter()
    port = run_trajectory(args.config, args.device)
    seconds = time.perf_counter() - t0
    res = compare(port, golden, args.config)
    for i, (a, b, r) in enumerate(zip(port["loss"], golden["loss"],
                                      res["rel_diff"]), 1):
        print(f"step {i:3d}: port {a:.6f} jax {float(b):.6f} "
              f"rel {r:.3e}")
    print(json.dumps({"config": args.config, **CONFIGS[args.config],
                      "max_rel_diff": res["max_rel_diff"],
                      "first_rel_diff": res["first_rel_diff"],
                      "bounds": [MAX_REL_DIFF[args.config],
                                 FIRST_REL_DIFF],
                      "seconds": seconds, "ok": res["ok"]}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
