"""The port's train step against one JAX `make_train_step` step, read from
tests/torch_golden/train_step_32.npz (a live jitted JAX train step of the
whole SAUNet takes minutes to compile on one CPU core; the file is written
by torch_port_util.write_train_step_golden), with and without `fix_bn`;
the eval step against the JAX `make_eval_step(fused_encoder=False)` on a
padded batch, read from tests/torch_golden/eval_step_32.npz
(make_eval_step_32.py); and the rule that the states run on the card
unless the caller names the CPU.

Both sides start from the same variables, made from a numpy seed
(`golden_variables`: eval_shape + fill, never a flax init of the SAUNet;
here `golden_variables_like` fills the port's identical tree) and bridged
with `from_jax_variables`."""
import numpy as np
import pytest
import torch

from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.ops.cuda import KERNELS
from saunet_tpu_torch.train import (
    InferState,
    create_train_state,
    make_eval_step,
    make_train_step,
    radam,
)
from torch_port_util import (  # noqa: F401  (fixture)
    GOLDEN_EVAL_STEP,
    GOLDEN_LEAVES,
    GOLDEN_LR,
    GOLDEN_TRAIN_STEP,
    flat_leaves,
    golden_batch,
    golden_variables_like,
    one_thread,
    padded_eval_batch,
    to_jax_variables,
    variables_digest,
)

LOSS_PARTS = ("loss", "ce", "dice", "edge")


@pytest.fixture(scope="module")
def variables():
    """`golden_variables` of the JAX SAUNet, filled on the port's tree
    without tracing the JAX init (the eval golden's digest holds the two
    equal)."""
    return golden_variables_like(build_unet(dtype="float32"))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN_TRAIN_STEP))


def port_model(variables):
    model = build_unet(dtype="float32")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# Tolerance on each stored leaf's update, as a fraction of the largest
# stored update. With BatchNorm in train mode the step is sensitive in f32:
# recomputing it with another convolution algorithm (other summation orders)
# moves the updates by 1.4e-3 of the largest, so the port is held to about
# twice that; with fix_bn the same change moves them by under 1e-5.
UPDATE_TOL = {False: 3e-3, True: 1e-3}


@pytest.mark.parametrize("fix_bn", [False, True], ids=["train_bn", "fix_bn"])
def test_train_step_matches_jax(fix_bn, variables, golden):
    prefix = "fix_bn/" if fix_bn else ""
    model = port_model(variables)
    tx = radam(GOLDEN_LR)
    state = create_train_state(model, tx, "cpu")
    step = make_train_step(model, tx, fix_bn=fix_bn)
    launches = [k.launches for k in KERNELS]
    state, metrics = step(state, torch_batch(golden_batch()))
    assert [k.launches for k in KERNELS] == launches  # plain on the CPU
    assert state.step == 1

    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(metrics[k]),
                                   golden[f"{prefix}metric/{k}"], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["acc"]),
                               golden[f"{prefix}metric/acc"], atol=1e-3)
    np.testing.assert_allclose(metrics["jaccard"].numpy(),
                               golden[f"{prefix}metric/jaccard"], atol=1e-3)

    new = to_jax_variables(model)
    old_p, new_p = flat_leaves(variables["params"]), flat_leaves(
        new["params"])
    names = list(golden[f"{prefix}names"])
    assert sorted(old_p) == names
    # every leaf: the norm of its update; a dozen leaves: the whole update
    norms = np.asarray([np.linalg.norm(new_p[k] - old_p[k]) for k in names])
    ref_norms = golden[f"{prefix}update_norm"]
    np.testing.assert_allclose(norms, ref_norms, rtol=0,
                               atol=1e-3 * ref_norms.max())
    scale = max(np.abs(golden[f"{prefix}update/{k}"]).max()
                for k in GOLDEN_LEAVES)
    for k in GOLDEN_LEAVES:
        np.testing.assert_allclose(new_p[k] - old_p[k],
                                   golden[f"{prefix}update/{k}"], rtol=0,
                                   atol=UPDATE_TOL[fix_bn] * scale, err_msg=k)

    stats = flat_leaves(new["batch_stats"])
    for k, v in stats.items():
        if fix_bn:  # running statistics untouched
            np.testing.assert_array_equal(
                v, flat_leaves(variables["batch_stats"])[k], err_msg=k)
        else:
            ref = golden[f"batch_stats/{k}"]
            np.testing.assert_allclose(v, ref, rtol=1e-5, atol=2e-5,
                                       err_msg=k)


def test_eval_step_matches_jax_with_padding(variables):
    """Two golden samples plus a third that repeats the second and is
    masked out by `valid`, as the train CLI pads its last validation batch,
    against the JAX `make_eval_step(fused_encoder=False)` read from
    tests/torch_golden/eval_step_32.npz (make_eval_step_32.py writes it)."""
    batch = padded_eval_batch()
    b = {k: v[:2] for k, v in batch.items() if k != "valid"}
    n = len(batch["label"])
    g = dict(np.load(GOLDEN_EVAL_STEP))
    assert str(g["variables_digest"]) == variables_digest(variables)
    for k, v in batch.items():
        np.testing.assert_array_equal(g[f"batch/{k}"], v, err_msg=k)
    probs_j, preds_j = g["probs"], g["preds"]
    metrics_j = {k[len("metric/"):]: v for k, v in g.items()
                 if k.startswith("metric/")}

    model = port_model(variables)
    tx = radam(GOLDEN_LR)
    state = create_train_state(model, tx, "cpu")
    probs, preds, metrics = make_eval_step(model, with_probs=True)(
        state, torch_batch(batch))
    assert preds.shape == preds_j.shape == (n, 32, 32)
    agree = float((preds.numpy() == preds_j).mean())
    assert agree >= 0.999, agree
    np.testing.assert_allclose(probs.numpy(), probs_j, rtol=0, atol=1e-3)
    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(metrics[k]), metrics_j[k],
                                   rtol=1e-4, err_msg=k)
    # the masked loss is the loss of the two real samples alone
    _, _, two = make_eval_step(model)(state, torch_batch(b))
    np.testing.assert_allclose(float(metrics["loss"]), float(two["loss"]),
                               rtol=1e-5)


def test_states_default_to_the_card():
    model = build_unet(dtype="float32")
    if torch.cuda.is_available():
        assert InferState(model).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferState(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(model, radam(1e-3))
