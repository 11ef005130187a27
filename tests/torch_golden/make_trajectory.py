"""Write tests/torch_golden/trajectory.npz: the JAX package's training
trajectory that saunet_tpu_torch/cli/fidelity.py holds the port against
(tools/fidelity.py::run_deterministic's setup, with the golden weights).

For each config of the gate (`CONFIGS`: 'cpu', 8 steps at 64^2, batch 2
of 8 slices; 'card', 50 steps at 64^2, batch 4 of 16), the JAX
`make_train_step` of an f32 SAUNet (edge_kernel 'xla', stream_impl 'xla',
radam(LR), no augmentation) runs from `golden_variables` (WEIGHT_SEED 0,
`fuse` scaled by FUSE_SCALE) over phantom slices (`make_phantom_set`,
PHANTOM_SEED) in 3 channels, their JAX edge ground truth, in the batch
order of tools/fidelity.py::_batches (SCHEDULE_SEED). It stores each
step's loss, ce, dice and edge under '<config>/<part>' and the config's
numbers under '<config>/hw' etc.; no weights. It first checks that the
port's jax-free `fill_from_seed_` draws the same variables.

Beside them, for the constructor's `act`: the eval forward of the same
model built with `act=nn.elu` on the first ACT_SAMPLES slices of the
'cpu' config's phantoms ('act/logits', 'act/edge', NHWC).

    JAX_PLATFORMS=cpu python tests/torch_golden/make_trajectory.py

Two train-step compiles and 58 steps: a few minutes on CPU.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import linen as nn  # noqa: E402

import torch_port_util as u  # noqa: E402
from fidelity import _batches  # noqa: E402
from saunet_tpu.data import edge_ground_truth  # noqa: E402
from saunet_tpu.data.phantom import make_phantom_set  # noqa: E402
from saunet_tpu.models import build_unet  # noqa: E402
from saunet_tpu.train.optim import radam  # noqa: E402
from saunet_tpu.train.state import TrainState, make_train_step  # noqa: E402
from saunet_tpu_torch.cli import fidelity as gate  # noqa: E402
from saunet_tpu_torch.models import build_unet as build_unet_port  # noqa: E402
from saunet_tpu_torch.models.init import fill_from_seed_  # noqa: E402


def golden_variables(model) -> dict:
    assert (u.GOLDEN_SEED, 0.05) == (gate.WEIGHT_SEED, gate.FUSE_SCALE)
    variables = u.golden_variables(model)
    port = u.to_jax_variables(fill_from_seed_(
        build_unet_port(), gate.WEIGHT_SEED, gate.FUSE_SCALE))
    want, got = u.flat_leaves(variables), u.flat_leaves(port)
    assert sorted(want) == sorted(got) and all(
        np.array_equal(want[k], got[k]) for k in want), \
        "fill_from_seed_ draws other variables than golden_variables"
    return variables


def trajectory(model, variables, cfg) -> dict:
    imgs, labels = make_phantom_set(cfg["n_train"], hw=cfg["hw"],
                                    seed=gate.PHANTOM_SEED)
    edges = np.asarray(jax.jit(edge_ground_truth)(jnp.asarray(labels)),
                       np.float32)
    img3 = np.repeat(imgs[..., None], 3, axis=-1)
    tx = radam(gate.LR)
    state = TrainState(step=jnp.zeros([], jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(model, tx, donate=False)
    out = {k: [] for k in gate.PARTS}
    for i, sel in enumerate(_batches(cfg["n_train"], cfg["batch"],
                                     cfg["steps"], gate.SCHEDULE_SEED), 1):
        state, metrics = step(state, {"image": jnp.asarray(img3[sel]),
                                      "label": jnp.asarray(labels[sel]),
                                      "edge": jnp.asarray(edges[sel])})
        for k in gate.PARTS:
            out[k].append(float(metrics[k]))
        print(f"step {i}: loss {out['loss'][-1]:.6f}", flush=True)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


ACT_SAMPLES = 2


def act_forward(variables) -> dict:
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla",
                       act=nn.elu)
    cfg = gate.CONFIGS["cpu"]
    image = gate.phantom_data(cfg["hw"], cfg["n_train"])["image"]
    logits, edge = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(image[:ACT_SAMPLES]))
    return {"act/logits": np.asarray(logits), "act/edge": np.asarray(edge)}


def main(path: str = str(gate.GOLDEN)) -> None:
    jax.config.update("jax_platforms", "cpu")
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = golden_variables(model)
    out = act_forward(variables)
    for name, cfg in gate.CONFIGS.items():
        if gate.GOLDENS[name] != gate.GOLDEN:
            continue  # written by its own script (make_trajectory_256.py)
        for k, v in trajectory(model, variables, cfg).items():
            out[f"{name}/{k}"] = v
        for k, v in cfg.items():
            out[f"{name}/{k}"] = np.asarray(v)
        out[f"{name}/lr"] = np.asarray(gate.LR)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
