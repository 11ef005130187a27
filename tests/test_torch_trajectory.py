"""The port's training trajectory against the JAX package's
(saunet_tpu_torch/cli/fidelity.py, the counterpart of
tools/fidelity.py::run_deterministic), and the model constructor's JAX
surface.

The JAX side is read from tests/torch_golden/trajectory.npz, which
tests/torch_golden/make_trajectory.py writes with the JAX `make_train_step`
(a live whole-SAUNet train step takes minutes to compile). Here: the
jax-free fill equals the golden variables leaf for leaf; the gate's data
(phantoms, their edge ground truth, the batch order) equals the JAX
tool's; the port's 8 steps of the 'cpu' config (64^2, batch 2) hold the
golden's losses, the first within rtol 1e-4 (one forward: f32 rounding) and
every one within 2e-3 (the port against itself under other summation
orders: 4.4e-4; a RAdam branch switch one update off: 5.3e-3 or more;
cli/fidelity.py says why not 32^2);
`build_unet` takes what the JAX drivers pass it."""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from saunet_tpu_torch.cli import fidelity as gate
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.init import fill_from_seed_
from saunet_tpu_torch.ops.cuda import KERNELS
from torch_port_util import (  # noqa: F401  (fixture)
    GOLDEN_SEED,
    flat_leaves,
    golden_variables_like,
    one_thread,
    to_jax_variables,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(gate.GOLDEN))


@pytest.fixture(scope="module")
def filled():
    return fill_from_seed_(build_unet(), gate.WEIGHT_SEED, gate.FUSE_SCALE)


def test_fill_from_seed_equals_golden_variables(filled):
    assert (gate.WEIGHT_SEED, gate.FUSE_SCALE) == (GOLDEN_SEED, 0.05)
    want = flat_leaves(golden_variables_like(filled))  # its tree only
    got = flat_leaves(to_jax_variables(filled))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gate_data_equals_jax_tool():
    import jax
    import jax.numpy as jnp
    from fidelity import _batches

    from saunet_tpu.data import edge_ground_truth
    from saunet_tpu.data.phantom import make_phantom_set

    cfg = gate.CONFIGS["cpu"]
    ours = gate.phantom_data(cfg["hw"], cfg["n_train"])
    imgs, labels = make_phantom_set(cfg["n_train"], hw=cfg["hw"],
                                    seed=gate.PHANTOM_SEED)
    np.testing.assert_array_equal(ours["image"][..., 1], imgs)
    np.testing.assert_array_equal(ours["label"], labels)
    np.testing.assert_array_equal(
        ours["edge"], np.asarray(jax.jit(edge_ground_truth)(
            jnp.asarray(labels))))
    for name, c in gate.CONFIGS.items():
        ref = _batches(c["n_train"], c["batch"], c["steps"],
                       gate.SCHEDULE_SEED)
        got = gate.batches(c["n_train"], c["batch"], c["steps"],
                           gate.SCHEDULE_SEED)
        assert [list(a) for a in got] == [list(b) for b in ref], name


def test_trajectory_matches_jax(golden):
    launches = [k.launches for k in KERNELS]
    port = gate.run_trajectory("cpu", "cpu")
    assert [k.launches for k in KERNELS] == launches  # plain on the CPU
    ref = gate.load_golden("cpu")
    res = gate.compare(port, ref, "cpu")
    print(f"port vs JAX over {len(port['loss'])} steps: largest relative "
          f"loss difference {res['max_rel_diff']:.4e}, first "
          f"{res['first_rel_diff']:.4e}")
    for k in gate.PARTS:
        np.testing.assert_allclose(port[k][0], ref[k][0], rtol=1e-4,
                                   err_msg=k)
    assert res["max_rel_diff"] < gate.MAX_REL_DIFF["cpu"], res
    assert res["first_rel_diff"] < gate.FIRST_REL_DIFF, res
    assert res["ok"]
    # the losses fall, as the JAX run's do
    assert port["loss"][-1] < port["loss"][0]


def _forward(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2))


def test_build_unet_takes_the_jax_drivers_arguments(filled, golden):
    """`build_unet(num_class, arch, dtype, stream_impl=...,
    encoder_concat=...)` as saunet_tpu/cli/train.py calls it, and
    `edge_kernel`: one math; `act` reaches every act site (held against
    the JAX model with act=nn.elu, f32 eval within 1e-4 of max|ref|);
    values JAX refuses raise."""
    state = filled.state_dict()
    x = gate.phantom_data(32, 2)["image"]
    ref = _forward(filled, x)
    for kw in ({"stream_impl": "packed", "encoder_concat": "chain"},
               {"stream_impl": "xla", "edge_kernel": "xla"}):
        m = build_unet(num_class=4, arch="saunet", dtype="float32", **kw)
        m.load_state_dict(state)
        for a, b in zip(_forward(m, x), ref):
            assert torch.equal(a, b), kw
    bf = build_unet(num_class=4, arch="saunet", dtype="bfloat16",
                    stream_impl="packed")
    assert bf.dtype == torch.bfloat16 and bf.stream_impl == "packed"

    elu = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla",
                     act=F.elu)
    elu.load_state_dict(state)
    sites = [m for m in elu.modules() if hasattr(m, "act")]
    assert len(sites) > 80 and all(m.act is F.elu for m in sites)
    x = gate.phantom_data(gate.CONFIGS["cpu"]["hw"], 2)["image"]
    logits, edge = _forward(elu, x[:golden["act/logits"].shape[0]])
    want = golden["act/logits"]
    np.testing.assert_allclose(logits.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(edge.permute(0, 2, 3, 1).numpy(),
                               golden["act/edge"], rtol=0, atol=1e-4)

    for kw in ({"stream_impl": "auto"}, {"stream_impl": "dense"},
               {"edge_kernel": "cuda"}):
        with pytest.raises(ValueError):
            build_unet(**kw)
    with pytest.raises(ValueError, match="Architecture"):
        build_unet(arch="unet")
    pallas = build_unet(edge_kernel="pallas")
    with pytest.raises(ValueError, match="pallas"):
        _forward(pallas, x[:1])
