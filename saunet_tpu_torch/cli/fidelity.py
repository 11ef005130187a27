"""Fidelity gates: `python -m saunet_tpu_torch.cli.fidelity [--config
card|cpu|card256|stat|stat-cpu] [--golden PATH] [--device cuda|cpu]`
(counterpart of tools/fidelity.py's run_deterministic and run, and of
tools/probe_bn_transient.py).

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
1.2e-2, which the 0.02 bound would let through. 'card256' is the same gate
at the reference's own 256^2 geometry (docs/FIDELITY.md §1b: 20 steps,
batch 4 of 8 slices; the decoder's resizes and the center block at 8x8),
held to the card's bounds against tests/torch_golden/trajectory_256.npz.

The long-run check ('stat': tools/fidelity.py::run's 300 steps at 64^2,
batch 8 of 64 training slices, the 16 validation slices scored every 30
steps; 'stat-cpu': 8 steps at 64^2, batch 2 of 8, 4 validation slices,
scored at steps 4 and 8) trains from the same init on the same data and
scores the validation slices twice at each eval point: through
`make_eval_step` (the running statistics) and through `eval_batch_stats`
(each batch's own statistics, tools/probe_bn_transient.py's probe of the
running statistics' transients). The golden
(tests/torch_golden/convergence.npz) holds the JAX package's run of both.
It prints one line per eval point, the port's loss and mIoU beside the
JAX package's, and exits 1 when a check of `compare_convergence` fails:
for 'stat' tests/test_fidelity.py's floor (the loss falls by 10% between
the first and last eval points, the final mIoU above 0.5 and within 0.15
of the golden's) and STAT_BOUNDS, which PERF.md derives from the spreads
that tests/torch_golden/spread_stat.py measures: of port runs under other
summation orders, and of two goldens written on other core counts.

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
from torch import nn

from ..data import edge_ground_truth, make_phantom_set
from ..models import build_unet
from ..models.init import fill_from_seed_
from ..models.norm import BatchNorm2d, frozen_running_stats
from ..train import (create_train_state, make_eval_step, make_train_step,
                     radam)
from ..train.state import resolve_device

CONFIGS = {"card": {"hw": 64, "batch": 4, "n_train": 16, "steps": 50},
           "cpu": {"hw": 64, "batch": 2, "n_train": 8, "steps": 8},
           "card256": {"hw": 256, "batch": 4, "n_train": 8, "steps": 20}}
# the long-run check (tools/fidelity.py::run): train, and score the
# validation slices every `eval_every` steps and at the last
STAT_CONFIGS = {"stat": {"hw": 64, "batch": 8, "n_train": 64, "n_val": 16,
                         "steps": 300, "eval_every": 30},
                "stat-cpu": {"hw": 64, "batch": 2, "n_train": 8, "n_val": 4,
                             "steps": 8, "eval_every": 4}}
LR = 1e-3
PHANTOM_SEED, SCHEDULE_SEED, WEIGHT_SEED = 0, 123, 0
FUSE_SCALE = 0.05
NUM_CLASS = 4
PARTS = ("loss", "ce", "dice", "edge")
MAX_REL_DIFF = {"card": 0.02, "cpu": 2e-3, "card256": 0.02}
FIRST_REL_DIFF = 2e-3
# the long-run configs' bounds against the golden: the relative loss
# difference over the first `loss_steps` steps, the final mIoU under the
# running and under the batch statistics; 'floor': tests/test_fidelity.py's
# convergence criteria too. Each is at least twice the larger of two
# spreads, rounded up (PERF.md §6, measured by
# tests/torch_golden/spread_stat.py): 'stat', three card runs under cuDNN's
# algorithm choices (largest pair 2.80e-3, 0.0159, 0.0052) and two goldens
# written on 4 and 2 cores (1.54e-3, 0.0247, 0.0045); 'stat-cpu', the port
# under four CPU summation orders (5.6e-4, 1.18e-3, 1.43e-3), its loss
# bound the 'cpu' trajectory's
STAT_BOUNDS = {"stat": {"loss_steps": 50, "loss_rel": 6e-3,
                        "miou_running": 0.05, "miou_batch": 0.02,
                        "floor": True},
               "stat-cpu": {"loss_steps": 8, "loss_rel": 2e-3,
                            "miou_running": 3e-3, "miou_batch": 3e-3,
                            "floor": False}}
_GOLDEN_DIR = Path(__file__).resolve().parents[2] / "tests" / "torch_golden"
GOLDEN = _GOLDEN_DIR / "trajectory.npz"
GOLDENS = {"card": GOLDEN, "cpu": GOLDEN,
           "card256": _GOLDEN_DIR / "trajectory_256.npz",
           "stat": _GOLDEN_DIR / "convergence.npz",
           "stat-cpu": _GOLDEN_DIR / "convergence.npz"}


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


def stat_data(config: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The long-run check's slices, as tools/fidelity.py::run makes them:
    `phantom_data` of `n_train + n_val` phantoms, the first n_train for
    training ('train': image, label, edge), the rest for validation
    ('val': image, label)."""
    cfg = STAT_CONFIGS[config]
    n = cfg["n_train"]
    data = phantom_data(cfg["hw"], n + cfg["n_val"])
    return {"train": {k: v[:n] for k, v in data.items()},
            "val": {k: data[k][n:] for k in ("image", "label")}}


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


def foreground_miou(preds, labels, num_class: int = NUM_CLASS,
                    per_class: bool = False):
    """Mean IoU over the foreground classes 1..num_class-1 (a class whose
    union is empty counts 0), and with `per_class` the list of each
    class's IoU beside it (tools/fidelity.py::_iou). `preds` and `labels`
    are numpy arrays or tensors (on any device) of one shape."""
    if isinstance(preds, torch.Tensor) or isinstance(labels, torch.Tensor):
        dev = (preds if isinstance(preds, torch.Tensor) else labels).device
        preds, labels = (torch.as_tensor(preds, device=dev),
                         torch.as_tensor(labels, device=dev))
    ious = []
    for c in range(1, num_class):
        p, lab = preds == c, labels == c
        inter, union = int((p & lab).sum()), int((p | lab).sum())
        ious.append(inter / union if union else 0.0)
    mean = float(np.mean(ious))
    return (mean, ious) if per_class else mean


def eval_batch_stats(model: nn.Module, images: torch.Tensor,
                     return_logits: bool = False):
    """The argmax (N, H, W) of a forward of NHWC `images` in which every
    BatchNorm normalises with this batch's own statistics
    (tools/probe_bn_transient.py: the train-mode apply with the updated
    statistics thrown away); with `return_logits`, (argmax, NCHW logits).
    The running statistics and `num_batches_tracked` are not written
    (`frozen_running_stats`: nothing is copied or restored), and every
    module is left in the mode it was in."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    if not all(isinstance(m, BatchNorm2d) for m in bns):
        raise TypeError("eval_batch_stats: the model has a BatchNorm that "
                        "is not models.norm.BatchNorm2d")
    modes = [(m, m.training) for m in model.modules()]
    model.train()
    try:
        with torch.no_grad(), frozen_running_stats(model):
            seg = model(images.permute(0, 3, 1, 2))[0]
    finally:
        for m, training in modes:
            m.training = training
    preds = seg.argmax(dim=1)
    return (preds, seg) if return_logits else preds


def _score(model, state, eval_step, val: Dict[str, torch.Tensor],
           batch: int, keep_logits: bool):
    """The validation slices in batches of `batch`: the argmax under the
    running statistics (`eval_step`) and under each batch's own
    (`eval_batch_stats`), each {'running', 'batch'} -> (N, H, W); with
    `keep_logits` also both NCHW logits (else {})."""
    preds = {"running": [], "batch": []}
    logits = {"running": [], "batch": []}
    for i in range(0, len(val["image"]), batch):
        images = val["image"][i:i + batch]
        _, p, _ = eval_step(state, {
            "image": images, "label": val["label"][i:i + batch],
            "edge": images.new_zeros(images.shape[:3] + (1,))})
        preds["running"].append(p)
        p, seg = eval_batch_stats(model, images, return_logits=True)
        preds["batch"].append(p)
        if keep_logits:
            logits["batch"].append(seg)
            model.eval()
            with torch.inference_mode():
                logits["running"].append(
                    model(images.permute(0, 3, 1, 2))[0])
    return ({k: torch.cat(v) for k, v in preds.items()},
            {k: torch.cat(v) for k, v in logits.items() if v})


def run_convergence(config: str, device=None, return_logits: bool = False
                    ) -> Dict[str, list]:
    """The long-run check (tools/fidelity.py::run_jax): train the f32 port
    from `fill_from_seed_` over `stat_data`'s training slices in the order
    of `batches`, radam(LR), no augmentation, TF32 off; every
    `eval_every` steps and at the last, score the validation slices in
    batches of `batch` through `make_eval_step` (running statistics) and
    through `eval_batch_stats` (each batch's own).

    Returns each step's loss parts and seconds, and for each eval point
    'eval_step', 'miou_running', 'miou_batch', 'iou_pc_running',
    'iou_pc_batch' (classes 1..3) and 'eval_seconds'; with
    `return_logits`, also the last eval point's validation logits (NHWC
    numpy) under both statistics ('logits_running', 'logits_batch')."""
    cfg = STAT_CONFIGS[config]
    device = resolve_device(device)
    model = build_unet(dtype="float32")
    fill_from_seed_(model, WEIGHT_SEED, FUSE_SCALE)
    tx = radam(LR)
    state = create_train_state(model, tx, device)
    step = make_train_step(model, tx)
    eval_step = make_eval_step(model)
    data = {part: {k: torch.from_numpy(v).to(device) for k, v in d.items()}
            for part, d in stat_data(config).items()}
    batch, steps = cfg["batch"], cfg["steps"]
    out: Dict[str, list] = {k: [] for k in PARTS + (
        "seconds", "eval_step", "miou_running", "miou_batch",
        "iou_pc_running", "iou_pc_batch", "eval_seconds")}
    with full_f32():
        for s, sel in enumerate(batches(cfg["n_train"], batch, steps,
                                        SCHEDULE_SEED), 1):
            t0 = time.perf_counter()
            idx = torch.from_numpy(np.asarray(sel)).to(device)
            state, metrics = step(state, {k: v[idx]
                                          for k, v in data["train"].items()})
            for k in PARTS:
                out[k].append(float(metrics[k]))
            out["seconds"].append(time.perf_counter() - t0)
            if s % cfg["eval_every"] and s != steps:
                continue
            t0 = time.perf_counter()
            preds, logits = _score(model, state, eval_step, data["val"],
                                   batch, return_logits and s == steps)
            for kind, p in preds.items():
                mean, per_class = foreground_miou(p, data["val"]["label"],
                                                  per_class=True)
                out[f"miou_{kind}"].append(mean)
                out[f"iou_pc_{kind}"].append(per_class)
            for kind, seg in logits.items():
                out[f"logits_{kind}"] = seg.permute(0, 2, 3, 1).cpu().numpy()
            out["eval_step"].append(s)
            out["eval_seconds"].append(time.perf_counter() - t0)
    return out


def load_golden(config: str, path=None) -> Dict[str, np.ndarray]:
    """The JAX package's record of `config` (default file:
    GOLDENS[config]): each step's loss parts, and for a long-run config
    also its eval points ('eval_step', 'miou_*', 'iou_pc_*', and the
    logits where stored); raises when the file was written for another
    config."""
    cfg = CONFIGS.get(config) or STAT_CONFIGS[config]
    path = GOLDENS[config] if path is None else path
    with np.load(path) as z:
        golden = {k.split("/", 1)[1]: z[k] for k in z.files
                  if k.startswith(config + "/")}
    written = {k: int(golden[k]) for k in cfg}
    if written != cfg:
        raise ValueError(f"{path} holds config {written}, not {cfg}")
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


def compare_convergence(port: Dict[str, list], golden: Dict[str, np.ndarray],
                        config: str) -> dict:
    """The long-run check's verdict. 'floor' (the 'stat' config only):
    tests/test_fidelity.py's criteria, the port's loss at the last eval
    point under 0.9 times its loss at the first, its final mIoU (running
    statistics) above 0.5 and within 0.15 of the golden's. 'bounds': the
    final mIoU under each statistic within STAT_BOUNDS of the golden's,
    and the relative loss difference over the first `loss_steps` steps
    within its bound. 'ok' when every check passes."""
    bounds = STAT_BOUNDS[config]
    if list(port["eval_step"]) != golden["eval_step"].tolist():
        raise ValueError("the port and the golden evaluated at other steps")
    n = bounds["loss_steps"]
    ref = golden["loss"][:n].astype(np.float64)
    rel = np.abs(np.asarray(port["loss"][:n]) - ref) / np.abs(ref)
    loss_at = [float(port["loss"][s - 1]) for s in port["eval_step"]]
    final_run = float(port["miou_running"][-1])
    final_bat = float(port["miou_batch"][-1])
    d_run = abs(final_run - float(golden["miou_running"][-1]))
    d_bat = abs(final_bat - float(golden["miou_batch"][-1]))
    checks = {"loss_rel": float(rel.max()) <= bounds["loss_rel"],
              "miou_running": d_run <= bounds["miou_running"],
              "miou_batch": d_bat <= bounds["miou_batch"]}
    if bounds["floor"]:
        checks.update({"loss_falls": loss_at[-1] < 0.9 * loss_at[0],
                       "miou_above_half": final_run > 0.5,
                       "miou_within_0.15": d_run < 0.15})
    return {"loss_rel_diff": rel.tolist(),
            "max_loss_rel_diff": float(rel.max()),
            "final_miou_running": final_run, "final_miou_batch": final_bat,
            "jax_final_miou_running": float(golden["miou_running"][-1]),
            "jax_final_miou_batch": float(golden["miou_batch"][-1]),
            "miou_running_diff": d_run, "miou_batch_diff": d_bat,
            "loss_ratio": loss_at[-1] / loss_at[0],
            "checks": checks, "bounds": bounds, "ok": all(checks.values())}


def eval_lines(port: Dict[str, list], golden: Dict[str, np.ndarray]):
    """One line an eval point: the loss and the mIoU under each statistic
    of the run beside the reference's, the run's per-class IoU."""
    for i, s in enumerate(port["eval_step"]):
        yield (f"step {s:3d}: loss port {float(port['loss'][s - 1]):.6f} "
               f"jax {float(golden['loss'][s - 1]):.6f}; mIoU running port "
               f"{float(port['miou_running'][i]):.4f} jax "
               f"{float(golden['miou_running'][i]):.4f}; batch statistics "
               f"port {float(port['miou_batch'][i]):.4f} jax "
               f"{float(golden['miou_batch'][i]):.4f}; per class port "
               + "/".join(f"{float(v):.3f}"
                          for v in port["iou_pc_running"][i]))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Hold the port's training trajectory (--config card, "
                    "cpu, card256) or its long-run convergence (--config "
                    "stat, stat-cpu) against the JAX package's")
    p.add_argument("--config", default="card",
                   choices=sorted(CONFIGS) + sorted(STAT_CONFIGS))
    p.add_argument("--golden", default=None,
                   help="the JAX record (default: the config's file under "
                        "tests/torch_golden)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    return p.parse_args(argv)


def _main_trajectory(args) -> dict:
    golden = load_golden(args.config, args.golden)
    port = run_trajectory(args.config, args.device)
    res = compare(port, golden, args.config)
    for i, (a, b, r) in enumerate(zip(port["loss"], golden["loss"],
                                      res["rel_diff"]), 1):
        print(f"step {i:3d}: port {a:.6f} jax {float(b):.6f} "
              f"rel {r:.3e}")
    return {"max_rel_diff": res["max_rel_diff"],
            "first_rel_diff": res["first_rel_diff"],
            "bounds": [MAX_REL_DIFF[args.config], FIRST_REL_DIFF],
            "ok": res["ok"]}


def _main_convergence(args) -> dict:
    golden = load_golden(args.config, args.golden)
    port = run_convergence(args.config, args.device)
    res = compare_convergence(port, golden, args.config)
    for line in eval_lines(port, golden):
        print(line)
    summary = {k: res[k] for k in res if k != "loss_rel_diff"}
    summary.update({k: np.asarray(port[k]).tolist() for k in (
        "loss", "miou_running", "miou_batch", "iou_pc_running",
        "iou_pc_batch")})
    summary.update(train_seconds=float(np.sum(port["seconds"])),
                   eval_seconds=float(np.sum(port["eval_seconds"])))
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    if args.config in STAT_CONFIGS:
        res = _main_convergence(args)
        cfg = STAT_CONFIGS[args.config]
    else:
        res = _main_trajectory(args)
        cfg = CONFIGS[args.config]
    print(json.dumps({"config": args.config, **cfg, **res,
                      "seconds": time.perf_counter() - t0}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
