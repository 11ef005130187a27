"""Write tests/torch_golden/shape_stream_32.npz: the JAX package's side of
tests/test_torch_shape_stream.py (tracing the bf16 SAUNet's init, the
Pallas kernel in interpret mode twice and the jitted XLA stream took about
30 s of the module's 36 on one thread).

From the test module's variables (`jax.eval_shape` of the bf16 SAUNet's
init at 32^2, `fill_variables` seed 0, the `fuse` kernel scaled by
FUSE_SCALE), taps and image (RandomState(1)), it stores:
- 'fold/<name>': `fold_shape_stream_params(params, batch_stats, EPS)`;
- 'packed': `shape_stream_inputs` in bf16 (as f32), 'inputs_f32': the same
  of the f32 model;
- 'pallas/whole', 'pallas/band8': `shape_stream_fused` on 'packed' in
  interpret mode, whole and in 8-row bands;
- 'xla_stream': the jitted XLA `shape_stream(train=False)` in bf16;
- 'taps<i>', 'image' and the variables' digest
  (`torch_port_util.variables_digest`), which the test checks.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_shape_stream_32.py

About a minute on one core.
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

import test_torch_shape_stream as t  # noqa: E402
import torch_port_util as u  # noqa: E402
from saunet_tpu.models import SAUNet  # noqa: E402
from saunet_tpu.ops.pallas.shape_stream import (  # noqa: E402
    fold_shape_stream_params,
    shape_stream_fused,
)


def main() -> None:
    model = SAUNet(num_classes=4, dtype=jnp.bfloat16, edge_kernel="xla")
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, t.SIZE, t.SIZE, 3)),
                             train=False), jax.random.PRNGKey(0))
    variables = u.fill_variables({"params": shapes["params"],
                                  "batch_stats": shapes["batch_stats"]},
                                 seed=0)
    fuse = variables["params"]["fuse"]
    fuse["kernel"] = fuse["kernel"] * np.float32(t.FUSE_SCALE)
    taps, image = t.stream_inputs()
    params, stats = variables["params"], variables["batch_stats"]

    def args(dtype):
        return [jnp.asarray(a, dtype) for a in taps], jnp.asarray(image, dtype)

    out = {"variables_digest": np.array(u.variables_digest(variables)),
           "image": image, **{f"taps{i}": a for i, a in enumerate(taps)}}
    fold = fold_shape_stream_params(params, stats, t.EPS)
    out.update({f"fold/{k}": np.asarray(v, np.float32)
                for k, v in fold.items()})
    packed = model.apply(variables, *args(jnp.bfloat16),
                         method="shape_stream_inputs")
    out["packed"] = np.asarray(packed, np.float32)
    out["inputs_f32"] = np.asarray(model.clone(dtype=jnp.float32).apply(
        variables, *args(jnp.float32), method="shape_stream_inputs"))
    for name, band_rows in (("whole", None), ("band8", 8)):
        out[f"pallas/{name}"] = np.asarray(shape_stream_fused(
            packed, params, stats, eps=t.EPS, band_rows=band_rows,
            interpret=True), np.float32)
    stream = jax.jit(lambda v, taps, x: model.apply(
        v, taps, x, False, method="shape_stream")[0])
    out["xla_stream"] = np.asarray(stream(variables, *args(jnp.bfloat16)),
                                   np.float32)
    path = os.path.join(HERE, "shape_stream_32.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {len(out)} arrays")


if __name__ == "__main__":
    main()
