"""Write tests/torch_golden/eval_step_32.npz: the JAX package's eval step
that tests/test_torch_train_step.py::test_eval_step_matches_jax_with_padding
holds the port's against (a live jitted JAX eval step of the whole SAUNet
took about 10 s of that test's 12 on one thread).

The JAX `make_eval_step(fused_encoder=False, with_probs=True)` of an f32
SAUNet (XLA Canny, stream_impl 'xla') runs from `golden_variables` on the
padded batch the test builds (`padded_eval_batch`: the first two samples
of `golden_batch` and a copy of the second, masked out by 'valid'). It
stores 'probs', 'preds', each metric under 'metric/<name>', the batch, and
the variables' digest (`torch_port_util.variables_digest`), which the test
checks.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_eval_step_32.py

About 40 s on one core.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_port_util as u  # noqa: E402
from saunet_tpu.models import build_unet  # noqa: E402
from saunet_tpu.train.state import TrainState, make_eval_step  # noqa: E402


def main() -> None:
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = u.golden_variables(model)
    batch = u.padded_eval_batch()
    state = TrainState(step=jnp.zeros([], jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    probs, preds, metrics = jax.tree.map(np.asarray, make_eval_step(
        model, fused_encoder=False, with_probs=True)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}))
    out = {"probs": probs, "preds": preds,
           "variables_digest": np.array(u.variables_digest(variables)),
           **{f"batch/{k}": v for k, v in batch.items()},
           **{f"metric/{k}": v for k, v in metrics.items()}}
    path = os.path.join(HERE, "eval_step_32.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {sorted(out)}")


if __name__ == "__main__":
    main()
