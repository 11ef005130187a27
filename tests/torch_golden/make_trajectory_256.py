"""Write tests/torch_golden/trajectory_256.npz: the JAX package's training
trajectory at the reference's own 256^2 geometry (docs/FIDELITY.md §1b,
docs/fidelity_det_256.json's config: 20 steps, batch 4 of 8 slices), which
saunet_tpu_torch/cli/fidelity.py's 'card256' config holds the port
against.

The same run as make_trajectory.py's (the JAX `make_train_step` of an f32
SAUNet from `golden_variables`, phantoms, their JAX edge ground truth, the
batch order of tools/fidelity.py::_batches, radam(LR), no augmentation),
at the 'card256' config; stored under 'card256/<part>' with the config's
numbers, 'meta/cores' the number of cores the run had; no weights. It
first checks that the port's jax-free `fill_from_seed_` draws the same
variables.

    JAX_PLATFORMS=cpu taskset -c 4,5 python tests/torch_golden/make_trajectory_256.py

About 19 minutes on 2 cores (`taskset -c 4,5`, beside two other JAX runs
on the other 6 cores of the machine).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from make_trajectory import gate, golden_variables, trajectory  # noqa: E402
from saunet_tpu.models import build_unet  # noqa: E402

CONFIG = "card256"


def main(path: str = str(gate.GOLDENS[CONFIG])) -> None:
    jax.config.update("jax_platforms", "cpu")
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = golden_variables(model)
    cfg = gate.CONFIGS[CONFIG]
    out = {f"{CONFIG}/{k}": v
           for k, v in trajectory(model, variables, cfg).items()}
    for k, v in cfg.items():
        out[f"{CONFIG}/{k}"] = np.asarray(v)
    out[f"{CONFIG}/lr"] = np.asarray(gate.LR)
    out["meta/cores"] = np.asarray(len(os.sched_getaffinity(0)))
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
