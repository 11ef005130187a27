"""Write tests/torch_golden/convergence.npz: the JAX package's long-run
check (tools/fidelity.py::run_jax, with the golden weights) that
saunet_tpu_torch/cli/fidelity.py's 'stat' and 'stat-cpu' configs hold the
port against, and the batch-statistics evaluation of
tools/probe_bn_transient.py at every eval point.

For each config of `STAT_CONFIGS` ('stat': 300 steps at 64^2, batch 8 of
64 training slices, 16 validation slices, eval every 30; 'stat-cpu': 8
steps at 64^2, batch 2 of 8, 4 validation slices, eval at 4 and 8), the
JAX `make_train_step` of an f32 SAUNet (edge_kernel 'xla', stream_impl
'xla', radam(LR), no augmentation) runs from `golden_variables`
(WEIGHT_SEED 0, `fuse` scaled by FUSE_SCALE) over `make_phantom_set(n_train
+ n_val)` (PHANTOM_SEED), split as tools/fidelity.py::run splits it, with
the JAX edge ground truth, in the batch order of tools/fidelity.py::_batches
(SCHEDULE_SEED). At every eval point it scores the validation slices in
batches of `batch` twice: through `make_eval_step(model,
fused_encoder=False)` (running statistics) and through the train-mode
apply of probe_bn_transient.py (each batch's own statistics, the updated
statistics thrown away), both by tools/fidelity.py::_iou.

Stored, under '<config>/': each step's loss, ce, dice and edge; the eval
points' 'eval_step', 'miou_running', 'miou_batch', 'iou_pc_running',
'iou_pc_batch' (per class 1..3); the config's numbers and 'lr'; for
'stat-cpu' also the last eval point's validation logits (NHWC) under both
statistics ('logits_running', 'logits_batch'). 'meta/cores' is the number
of cores the run had. No weights. It first checks that the port's jax-free
`fill_from_seed_` draws the same variables and that the port's
`stat_data` equals the JAX tool's data.

    JAX_PLATFORMS=cpu taskset -c 0-3 python tests/torch_golden/make_convergence.py

About 18 minutes on 4 cores (`taskset -c 0-3`, beside two other JAX runs
on the other 4 cores of the machine), nearly all of it 'stat'. `--out
PATH` writes elsewhere and `--configs` picks configs: `taskset -c 6,7
... --configs stat --out <file>` (about 26 minutes on 2 cores) wrote the
second 'stat' golden that PERF.md's spread of the golden compares with
this one (`python tests/torch_golden/spread_stat.py --goldens <file>
tests/torch_golden/convergence.npz`).
"""
import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fidelity import _batches, _edge_targets, _iou  # noqa: E402
from make_trajectory import golden_variables  # noqa: E402
from saunet_tpu.data.phantom import make_phantom_set  # noqa: E402
from saunet_tpu.models import build_unet  # noqa: E402
from saunet_tpu.train.optim import radam  # noqa: E402
from saunet_tpu.train.state import (TrainState, make_eval_step,  # noqa: E402
                                    make_train_step)
from saunet_tpu_torch.cli import fidelity as gate  # noqa: E402


def check_data(cfg, name, imgs, labels, edges) -> None:
    ours = gate.stat_data(name)
    n = cfg["n_train"]
    np.testing.assert_array_equal(ours["train"]["image"][..., 1], imgs[:n])
    np.testing.assert_array_equal(ours["val"]["image"][..., 1], imgs[n:])
    np.testing.assert_array_equal(ours["train"]["label"], labels[:n])
    np.testing.assert_array_equal(ours["val"]["label"], labels[n:])
    np.testing.assert_array_equal(ours["train"]["edge"], edges[:n])


def convergence(model, variables, name) -> dict:
    cfg = gate.STAT_CONFIGS[name]
    hw, batch, n = cfg["hw"], cfg["batch"], cfg["n_train"]
    imgs, labels = make_phantom_set(n + cfg["n_val"], hw=hw,
                                    seed=gate.PHANTOM_SEED)
    edges = _edge_targets(labels)
    check_data(cfg, name, imgs, labels, edges)
    img3 = np.repeat(imgs[..., None], 3, axis=-1)
    tr_i, tr_l, tr_e = img3[:n], labels[:n], edges[:n]
    va_i, va_l = img3[n:], labels[n:]

    tx = radam(gate.LR)
    state = TrainState(step=jnp.zeros([], jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(model, tx, donate=False)
    eval_step = make_eval_step(model, fused_encoder=False)

    @jax.jit
    def eval_batchstats(state, images):
        # tools/probe_bn_transient.py:27-32
        (seg, _), _ = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            images, True, mutable=["batch_stats"])
        return seg, jnp.argmax(seg, axis=-1)

    @jax.jit
    def logits_running(state, images):
        seg, _ = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            images, train=False)
        return seg

    out = {k: [] for k in gate.PARTS}
    ev = {k: [] for k in ("eval_step", "miou_running", "miou_batch",
                          "iou_pc_running", "iou_pc_batch")}
    steps = cfg["steps"]
    t0 = time.time()
    for s, sel in enumerate(_batches(n, batch, steps, gate.SCHEDULE_SEED),
                            1):
        state, metrics = step(state, {"image": jnp.asarray(tr_i[sel]),
                                      "label": jnp.asarray(tr_l[sel]),
                                      "edge": jnp.asarray(tr_e[sel])})
        for k in gate.PARTS:
            out[k].append(float(metrics[k]))
        if s % cfg["eval_every"] and s != steps:
            continue
        pr, pb, lr_, lb = [], [], [], []
        for i in range(0, len(va_i), batch):
            vb = {"image": jnp.asarray(va_i[i:i + batch]),
                  "label": jnp.asarray(va_l[i:i + batch]),
                  "edge": jnp.zeros((len(va_i[i:i + batch]), hw, hw, 1),
                                    jnp.float32)}
            _, p, _ = eval_step(state, vb)
            pr.append(np.asarray(p))
            seg_b, p_b = eval_batchstats(state, vb["image"])
            pb.append(np.asarray(p_b))
            if s == steps and name == "stat-cpu":
                lb.append(np.asarray(seg_b))
                lr_.append(np.asarray(logits_running(state, vb["image"])))
        m_r, pc_r = _iou(np.concatenate(pr), va_l, per_class=True)
        m_b, pc_b = _iou(np.concatenate(pb), va_l, per_class=True)
        for k, v in zip(ev, (s, m_r, m_b, pc_r, pc_b)):
            ev[k].append(v)
        if lb:
            out["logits_running"] = np.concatenate(lr_)
            out["logits_batch"] = np.concatenate(lb)
        print(f"{name} step {s}: loss {out['loss'][-1]:.6f} mIoU running "
              f"{m_r:.4f} batch {m_b:.4f} ({time.time() - t0:.0f} s)",
              flush=True)
    res = {k: np.asarray(v, np.float32) for k, v in out.items()}
    res["eval_step"] = np.asarray(ev.pop("eval_step"), np.int32)
    res.update({k: np.asarray(v, np.float64) for k, v in ev.items()})
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(gate.GOLDENS["stat"]))
    p.add_argument("--configs", default=",".join(gate.STAT_CONFIGS))
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = golden_variables(model)
    out = {"meta/cores": np.asarray(len(os.sched_getaffinity(0)))}
    for name in args.configs.split(","):
        for k, v in convergence(model, variables, name).items():
            out[f"{name}/{k}"] = v
        for k, v in gate.STAT_CONFIGS[name].items():
            out[f"{name}/{k}"] = np.asarray(v)
        out[f"{name}/lr"] = np.asarray(gate.LR)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
