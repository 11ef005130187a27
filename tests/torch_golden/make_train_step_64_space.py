"""Write tests/torch_golden/train_step_64_space.npz: one JAX
`make_train_step` of the f32 SAUNet (XLA Canny, xla stream, radam(1e-3), no
augmentation) from `golden_variables` on `space_batch()` (batch 8 at 64^2),
with the batch sharded over a ('data' 2, 'space' 2) mesh of four virtual
CPU devices: XLA's partitioner splits the image H axis over 'space' and
inserts the halo exchanges. tests/test_torch_space.py holds the port's
2 x 2 step against it. The same step on the unsharded batch is stored
beside it (`unsharded/`): at 64^2 the center block (H/32) has one row a
shard, and there XLA's partitioner returns the center block's gradient
twice over (and the encoder's below it 1.8-2.8 times), while the loss
and the batch statistics agree with the unsharded step to 1e-6.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_train_step_64_space.py

The compile of the partitioned step takes several minutes on CPU; run it
again only if the golden's inputs change.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_port_util as u  # noqa: E402
from saunet_tpu.models import build_unet  # noqa: E402
from saunet_tpu.parallel import (  # noqa: E402
    make_mesh,
    shard_batch,
    validate_spatial_partition,
)
from saunet_tpu.train.optim import radam  # noqa: E402
from saunet_tpu.train.state import TrainState, make_train_step  # noqa: E402


def main(path: str = u.GOLDEN_SPACE_TRAIN_STEP) -> None:
    jax.config.update("jax_platforms", "cpu")
    validate_spatial_partition(u.SPACE_SIZE, 2)
    mesh = make_mesh(jax.devices()[:4], data=2, space=2)
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = u.golden_variables(model)
    tx = radam(u.GOLDEN_LR)
    state = TrainState(step=jnp.zeros([], jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(model, tx, donate=False)
    new, metrics = step(state, shard_batch(u.space_batch(), mesh))
    out = {f"metric/{k}": np.asarray(metrics[k])
           for k in ("loss", "ce", "dice", "edge", "acc", "jaccard")}
    old_p = u.flat_leaves(variables["params"])
    new_p = u.flat_leaves(new.params)
    names = sorted(old_p)
    out["names"] = np.asarray(names)
    out["update_norm"] = np.asarray(
        [np.linalg.norm(new_p[k] - old_p[k]) for k in names], np.float32)
    for k in u.GOLDEN_LEAVES:
        out[f"update/{k}"] = new_p[k] - old_p[k]
    for k, v in u.flat_leaves(new.batch_stats).items():
        out[f"batch_stats/{k}"] = v
    # the same step unsharded: how far partitioning alone moves JAX's step
    one, one_metrics = step(state, jax.tree.map(jnp.asarray,
                                                u.space_batch()))
    for k in ("loss", "ce", "dice", "edge", "acc", "jaccard"):
        out[f"unsharded/metric/{k}"] = np.asarray(one_metrics[k])
    one_p = u.flat_leaves(one.params)
    out["unsharded/update_norm"] = np.asarray(
        [np.linalg.norm(one_p[k] - old_p[k]) for k in names], np.float32)
    for k in u.GOLDEN_LEAVES:
        out[f"unsharded/update/{k}"] = one_p[k] - old_p[k]
    for k, v in u.flat_leaves(one.batch_stats).items():
        out[f"unsharded/batch_stats/{k}"] = v
    np.savez_compressed(path, **out)
    print(f"wrote {path}: loss {float(metrics['loss'])}")


if __name__ == "__main__":
    main()
