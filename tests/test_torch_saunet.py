"""The port's SAUNet through its infer step, against the JAX package's
`make_infer_step(fused_encoder=False)` (the f32 XLA route) for both
`stream_impl`s, on one variable tree (the JAX outputs read from
tests/torch_golden/infer_32.npz, which make_infer_32.py writes); the weight
bridge; and the rule that the port never imports jax.

The variables are never made by a flax `init` of the whole model: the tree
of shapes comes from `jax.eval_shape` and every leaf is filled from a numpy
seed (tests/torch_port_util.py). The two stream layouts share that tree."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from saunet_tpu.models import build_unet as build_unet_jax
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.ops.cuda import canny_edges_cuda, dense_block
from saunet_tpu_torch.train import InferState, make_infer_step
from torch_port_util import (  # noqa: F401  (fixtures)
    fill_variables,
    one_thread,
    to_jax_variables,
    variables_digest,
)

BATCH, SIZE = 2, 32
GOLDEN_INFER = os.path.join(os.path.dirname(__file__), "torch_golden",
                            "infer_32.npz")


def saunet_variables() -> dict:
    """The f32 SAUNet's variables: its init traced at SIZE^2, filled from
    seed 0."""
    model = build_unet_jax(dtype="float32", stream_impl="xla")
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    return fill_variables({"params": shapes["params"],
                           "batch_stats": shapes["batch_stats"]}, seed=0)


def saunet_images() -> np.ndarray:
    return np.random.RandomState(1).randn(BATCH, SIZE, SIZE, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def variables():
    return saunet_variables()


@pytest.fixture(scope="module")
def images():
    return saunet_images()


@pytest.fixture(scope="module")
def port_outputs(variables, images):
    model = build_unet(dtype="float32")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    step = make_infer_step(model, with_probs=True, with_edge=True,
                           with_att=True)
    launches = (canny_edges_cuda.launches, dense_block.launches)
    out = step(InferState(model, "cpu"), torch.from_numpy(images))
    # the CPU tensors took the plain versions: no kernel was launched
    assert (canny_edges_cuda.launches, dense_block.launches) == launches
    return out


def test_bridge_fills_every_entry_once(variables):
    sd = from_jax_variables(variables)
    model = build_unet(dtype="float32")
    want = model.state_dict()
    assert set(sd) == set(want)
    leaves = jax.tree.leaves(variables)
    tracked = [k for k in sd if k.endswith("num_batches_tracked")]
    assert len(sd) - len(tracked) == len(leaves)  # no two leaves collide
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    n_port = sum(v.numel() for k, v in sd.items() if k not in tracked)
    assert n_port == sum(int(np.prod(l.shape)) for l in leaves)


def test_bridge_round_trip(variables):
    model = build_unet(dtype="float32")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    back = to_jax_variables(model)
    ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_bridge_raises_on_unknown_or_missing_leaves(variables):
    extra = {"params": dict(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    extra["params"]["final"] = dict(extra["params"]["final"],
                                    gamma=np.zeros(4, np.float32))
    with pytest.raises(KeyError, match="final/gamma"):
        from_jax_variables(extra)
    missing = {"params": variables["params"],
               "batch_stats": dict(variables["batch_stats"])}
    del missing["batch_stats"]["expand"]
    with pytest.raises(KeyError, match="expand"):
        from_jax_variables(missing)


@pytest.fixture(scope="module")
def golden_infer():
    return dict(np.load(GOLDEN_INFER))


@pytest.mark.parametrize("stream_impl", ["xla", "packed"])
def test_infer_step_matches_jax(stream_impl, variables, images,
                                port_outputs, golden_infer):
    """Against the JAX `make_infer_step(fused_encoder=False)` of the same
    variables and images in each stream layout, read from
    tests/torch_golden/infer_32.npz (make_infer_32.py writes it)."""
    g = golden_infer
    assert str(g["variables_digest"]) == variables_digest(variables)
    np.testing.assert_array_equal(g["images"], images)
    probs_j, preds_j, edge_j = (g[f"{stream_impl}/{k}"]
                                for k in ("probs", "preds", "edge"))
    atts_j = [g[f"{stream_impl}/att{i}"]
              for i in range(sum(k.startswith(f"{stream_impl}/att")
                                 for k in g))]
    probs, preds, edge, atts = port_outputs

    assert preds.shape == (BATCH, SIZE, SIZE)
    assert probs.shape == (BATCH, SIZE, SIZE, 4)
    assert edge.shape == (BATCH, SIZE, SIZE, 1)
    agree = float((preds.numpy() == preds_j).mean())
    assert agree >= 0.999, agree
    np.testing.assert_allclose(probs.numpy(), probs_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(edge.numpy(), edge_j, rtol=0, atol=1e-4)
    assert len(atts) == len(atts_j) == 7
    for i, (a, r) in enumerate(zip(atts, atts_j)):
        assert a.shape == r.shape == (BATCH, SIZE, SIZE, 1), i
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-4,
                                   err_msg=f"map {i}")


def test_port_never_imports_jax():
    """Importing the package and every one of its modules (the profilers
    of profile/ and cli/profile.py among them) leaves jax (and flax's
    msgpack, and PIL, which the card machine lacks) out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import saunet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "assert {'saunet_tpu_torch.cli.profile',"
        " 'saunet_tpu_torch.profile.infer',"
        " 'saunet_tpu_torch.profile.scaling'} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'saunet_tpu', 'msgpack',"
        " 'PIL'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.mark.parametrize("out_hw", [(32, 32), (17, 40)])
def test_resize_bilinear_matches_jax(out_hw):
    from saunet_tpu.ops.resize import resize_bilinear as resize_jax
    from saunet_tpu_torch.ops.resize import resize_bilinear

    x = np.random.RandomState(5).randn(2, 8, 12, 3).astype(np.float32)
    ref = np.asarray(resize_jax(jnp.asarray(x), out_hw))
    ours = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-5)


def test_normalize_for_eval_matches_jax():
    from saunet_tpu.data.augment import normalize_for_eval as norm_jax
    from saunet_tpu_torch.data import normalize_for_eval

    x = (np.random.RandomState(6).rand(3, 20, 24) * 300).astype(np.float32)
    ref = np.asarray(norm_jax(jnp.asarray(x)))
    ours = normalize_for_eval(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (3, 20, 24, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
