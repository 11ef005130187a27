"""Write tests/torch_golden/infer_32.npz: the JAX package's infer step that
tests/test_torch_saunet.py::test_infer_step_matches_jax holds the port's
against (a live jitted JAX infer step of the whole SAUNet, twice, took
about 25 s of the test module's 43 on one thread).

For each stream layout ('xla', 'packed') the JAX `make_infer_step(
fused_encoder=False, with_probs=True, with_edge=True, with_att=True)` of an
f32 SAUNet runs from the test module's variables (`saunet_variables`:
`jax.eval_shape` of the init at 32^2, `fill_variables` seed 0) on its
images (`saunet_images`). It stores '<impl>/probs', '/preds',
'/edge' and '/att<i>' (the seven attention maps), the images, and the
variables' digest (`torch_port_util.variables_digest`), which the test
checks.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_infer_32.py

About a minute on one core. XLA's CPU results move with the cores it is
given (by up to 3.3e-6 here between one core and two), far inside the
test's bounds (1e-4 and 1e-3).
"""
import os
import sys
from collections import namedtuple

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_saunet as t  # noqa: E402
import torch_port_util as u  # noqa: E402
from saunet_tpu.models import build_unet  # noqa: E402
from saunet_tpu.train.state import make_infer_step  # noqa: E402

IMPLS = ("xla", "packed")
# the step reads only these two fields of a TrainState
State = namedtuple("State", ["params", "batch_stats"])


def main() -> None:
    variables, images = t.saunet_variables(), t.saunet_images()
    state = State(variables["params"], variables["batch_stats"])
    out = {"images": images,
           "variables_digest": np.array(u.variables_digest(variables))}
    for impl in IMPLS:
        step = make_infer_step(build_unet(dtype="float32", stream_impl=impl),
                               fused_encoder=False, with_probs=True,
                               with_edge=True, with_att=True)
        probs, preds, edge, atts = jax.tree.map(
            np.asarray, step(state, jnp.asarray(images)))
        out.update({f"{impl}/probs": probs, f"{impl}/preds": preds,
                    f"{impl}/edge": edge})
        out.update({f"{impl}/att{i}": a for i, a in enumerate(atts)})
    path = os.path.join(HERE, "infer_32.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {sorted(out)}")


if __name__ == "__main__":
    main()
