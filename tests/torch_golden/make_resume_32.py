"""Write tests/torch_golden/resume_32.npz, what tests/test_torch_resume.py
holds the port against where the JAX side would need a whole-SAUNet
compile:

  * one JAX `make_train_step` of the f32 SAUNet (XLA Canny, xla stream,
    radam(RESUME_LR), no augmentation) from `golden_variables` on
    `golden_batch()`, taken up at step RESUME_COUNT with the RAdam state of
    `fill_opt_state` (RESUME_SEED): its loss parts and metrics, every
    leaf's update norm and the whole update of GOLDEN_LEAVES;
  * the JAX `SegmentationModule` facade on the same variables: `train`
    on the golden batch (loss, acc, jaccard), `predict` (with and without
    the attention maps) and `infer_loss` on its first FACADE_SAMPLES
    samples.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_resume_32.py

The compiles take a few minutes on CPU; run it again only if the golden's
inputs change.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_port_util as u  # noqa: E402
from saunet_tpu.models import SegmentationModule, build_unet  # noqa: E402
from saunet_tpu.train.optim import radam  # noqa: E402
from saunet_tpu.train.state import TrainState, make_train_step  # noqa: E402

METRICS = ("loss", "ce", "dice", "edge", "acc", "jaccard")


def main(path: str = u.GOLDEN_RESUME) -> None:
    jax.config.update("jax_platforms", "cpu")
    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = u.golden_variables(model)
    batch = {k: jnp.asarray(v) for k, v in u.golden_batch().items()}
    tx = radam(u.RESUME_LR)
    state = TrainState(
        step=jnp.asarray(u.RESUME_COUNT, jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=u.fill_opt_state(tx, variables["params"], u.RESUME_COUNT,
                                   u.RESUME_SEED))
    new, metrics = make_train_step(model, tx, donate=False)(state, batch)
    out = {f"metric/{k}": np.asarray(metrics[k]) for k in METRICS}
    out["step"] = np.asarray(new.step)
    old_p = u.flat_leaves(variables["params"])
    new_p = u.flat_leaves(new.params)
    names = sorted(old_p)
    out["names"] = np.asarray(names)
    out["update_norm"] = np.asarray(
        [np.linalg.norm(new_p[k] - old_p[k]) for k in names], np.float32)
    for k in u.GOLDEN_LEAVES:
        out[f"update/{k}"] = new_p[k] - old_p[k]

    facade = SegmentationModule(model)
    (loss, (acc, jaccard)), _ = jax.jit(facade.train)(variables, batch)
    out["facade/train/loss"] = np.asarray(loss)
    out["facade/train/acc"] = np.asarray(acc)
    out["facade/train/jaccard"] = np.asarray(jaccard)
    few = {k: v[:u.FACADE_SAMPLES] for k, v in batch.items()}
    out["facade/predict"] = np.asarray(
        jax.jit(facade.predict)(variables, few["image"]))
    probs, atts = jax.jit(lambda v, im: facade.predict(v, im, True))(
        variables, few["image"])
    out["facade/predict_att/probs"] = np.asarray(probs)
    for i, a in enumerate(atts):
        out[f"facade/predict_att/att{i}"] = np.asarray(a)
    probs, loss = jax.jit(facade.infer_loss)(variables, few)
    out["facade/infer_loss/probs"] = np.asarray(probs)
    out["facade/infer_loss/loss"] = np.asarray(loss)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: loss {float(metrics['loss'])}, "
          f"{os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
