"""The port reads the JAX package's checkpoints: the msgpack reader
(saunet_tpu_torch/utils/msgpack.py) against flax on a hand-made tree, and a
full-width checkpoint written by `saunet_tpu.train.checkpoint.
save_checkpoint` (params, batch_stats, RAdam's opt_state, step) through
`restore_params_only`, `test_and_pack --checkpoint` and `train
--weights_unet`.

The variables come from `jax.eval_shape` and `fill_variables`, never a flax
`init` of the whole model; RAdam's state is `tx.init`'s tree of shapes
with zero moments and its counts at the checkpoint's step, as a run that
saved at that step holds them (moments aside)."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization
from PIL import Image

from saunet_tpu.models import build_unet as build_unet_jax
from saunet_tpu.train.checkpoint import save_checkpoint as save_checkpoint_jax
from saunet_tpu.train.optim import radam as radam_jax
from saunet_tpu.train.state import TrainState as TrainStateJax
from saunet_tpu_torch.cli.test_and_pack import main as pack_main
from saunet_tpu_torch.cli.train import main as train_main
from saunet_tpu_torch.data import nifti
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.train import (
    create_optimizer,
    create_train_state,
    load_jax_variables,
    radam,
    restore_checkpoint,
    restore_params_only,
)
from saunet_tpu_torch.utils import msgpack
from test_torch_test_and_pack import SHAPES, _write_volumes
from test_torch_train_cli import _args, _write_acdc
from torch_port_util import (  # noqa: F401  (fixtures)
    fill_variables,
    flat_leaves,
    one_thread,
)


def _tree_equal(ours, ref, path="") -> None:
    """`ours` (the port's reader) holds what flax's `msgpack_restore`
    gives: the same nesting, keys and scalars; arrays equal in shape,
    dtype and bits (bfloat16 as a torch tensor)."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _tree_equal(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _tree_equal(a, b, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)) \
            and ref.dtype == jnp.bfloat16:
        assert isinstance(ours, torch.Tensor), path
        assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape, path
        np.testing.assert_array_equal(
            ours.view(torch.int16).numpy(),
            np.asarray(ref).view(np.int16), err_msg=path)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(ours) is type(ref), path
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert type(ours) is type(ref) and ours == ref, path


def test_msgpack_reads_flax_tree():
    rs = np.random.RandomState(0)
    big = rs.randn(3, 5).astype(np.float32)
    flat = big.reshape(-1)
    tree = {
        "f32": rs.randn(4, 3).astype(np.float32),
        "i32": rs.randint(-9, 9, size=(2, 2, 2)).astype(np.int32),
        "bf16": jnp.asarray(rs.randn(5), jnp.bfloat16),
        "zero_d": np.array(2.5, np.float64),
        "scalar": np.float32(-1.25),
        "int_scalar": np.int64(-7),
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"a": {"b": np.arange(3, dtype=np.uint8)}, "c": "text"},
        "list": [1, -1, -33, 200, 70000, -70000, 2 ** 40, -2 ** 40,
                 2 ** 64 - 1, 0.5, True, False, None, "ünï", b"raw"],
        "complex": complex(1.5, -2.0),
        "long_str": "x" * 300,
        # flax writes an array above 2**30 bytes as such a map of chunks
        "chunked": {"__msgpack_chunked_array__": True,
                    "shape": {"0": 3, "1": 5},
                    "chunks": {"0": flat[:6], "1": flat[6:]}},
        "many": {str(i): np.int32(i) for i in range(20)},
    }
    data = serialization.to_bytes(tree)
    ref = serialization.msgpack_restore(data)
    ours = msgpack.loads(data)
    _tree_equal(ours, ref)
    np.testing.assert_array_equal(ours["chunked"], big)


@pytest.mark.parametrize("data, message", [
    (b"\xc1", "unknown type byte 0xc1 at offset 0"),
    (b"\x92\x01\xd4\x05\x00", "unknown ext code 5 at offset 2"),
    (b"\x93\x01\x02", "truncated input"),
    (b"\x01\x02", "trailing bytes at offset 1"),
], ids=["type_byte", "ext_code", "truncated", "trailing"])
def test_msgpack_rejects_what_it_does_not_know(data, message):
    with pytest.raises(ValueError, match=message):
        msgpack.loads(data)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(path, variables) of a full-width JAX checkpoint with RAdam's
    state."""
    model = build_unet_jax(dtype="float32")
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.PRNGKey(0))
    variables = fill_variables({"params": shapes["params"],
                                "batch_stats": shapes["batch_stats"]},
                               seed=3)
    tx = radam_jax(1e-4)
    opt_state = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, 12 if getattr(
            path[-1], "name", None) == "count" else 0, s.dtype),
        jax.eval_shape(tx.init, variables["params"]))
    state = TrainStateJax(step=np.asarray(12, np.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=opt_state)
    path = save_checkpoint_jax(str(tmp_path_factory.mktemp("ckpt")),
                               "epoch_1", state, {"val": [0.5]})
    return path, variables


def test_msgpack_reads_full_checkpoint(jax_checkpoint):
    """Every leaf of a real checkpoint (opt_state's nested '0'/'1' dicts,
    the 0-d step, RAdam's count) as flax reads it."""
    with open(jax_checkpoint[0], "rb") as f:
        data = f.read()
    ours = msgpack.loads(data)
    assert sorted(ours) == ["batch_stats", "opt_state", "params", "step"]
    assert ours["step"].shape == () and int(ours["step"]) == 12
    _tree_equal(ours, serialization.msgpack_restore(data))


def test_restore_params_only_reads_jax_checkpoint(jax_checkpoint):
    path, variables = jax_checkpoint
    loaded = load_jax_variables(path)
    assert set(loaded) == {"params", "batch_stats"}
    want, got = flat_leaves(variables), flat_leaves(loaded)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    model = restore_params_only(path, build_unet(dtype="float32"))
    ref = from_jax_variables(variables)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


def test_restore_checkpoint_refuses_jax_optimizer_state(jax_checkpoint):
    """A JAX checkpoint resumes: the weights, RAdam's moments (f32, beside
    each parameter) and the step, which becomes the update count. An
    optimizer of another kind refuses the optax state, before the state is
    touched."""
    path, variables = jax_checkpoint
    model = build_unet(dtype="float32")
    state = create_train_state(model, radam(1e-4), "cpu")
    assert restore_checkpoint(path, state) is state
    assert state.step == 12 and state.optimizer.state["count"] == 12
    sd = model.state_dict()
    for k, v in from_jax_variables(variables).items():
        assert torch.equal(sd[k], v), k
    for p in model.parameters():
        for name in ("exp_avg", "exp_avg_sq"):
            m = state.optimizer.state[p][name]
            assert m.dtype == torch.float32 and m.shape == p.shape
            assert not m.any()

    other = create_train_state(build_unet(dtype="float32"),
                               create_optimizer("sgd", 1e-4), "cpu")
    with pytest.raises(ValueError, match="does not fit SGD"):
        restore_checkpoint(path, other)
    assert other.step == 0 and other.optimizer.state["count"] == 0


def test_test_and_pack_serves_jax_checkpoint(jax_checkpoint, tmp_path):
    """The default run (`--visualize`): NIfTI predictions and the
    side-by-side PNGs, written by utils/png.py (the port imports no PIL)
    and decoded here by PIL: image | prediction * 85."""
    root, out, res = (str(tmp_path / d) for d in ("data", "out", "res"))
    _write_volumes(root)
    pack_main(["--id", "j", "--checkpoint", jax_checkpoint[0],
               "--data-root", root, "--crop_size", "32", "--dtype",
               "float32", "--device", "cpu", "--save_test_path", out,
               "--result", res])
    for p, shape in SHAPES.items():
        pred = nifti.load(os.path.join(
            out, f"patient{p:03d}_ED.nii.gz")).data
        assert pred.shape == shape
        assert set(np.unique(pred)) <= {0, 1, 2, 3}
    pngs = [f for f in os.listdir(os.path.join(res, "j"))
            if f.endswith(".png")]
    assert len(pngs) == sum(s[2] for s in SHAPES.values())
    h, w, _ = SHAPES[1]
    with Image.open(os.path.join(res, "j", "patient001_ED0.png")) as im:
        pixels = np.asarray(im)
    assert im.mode == "L" and pixels.shape == (h, 2 * w)
    pred = nifti.load(os.path.join(out, "patient001_ED.nii.gz")).data
    np.testing.assert_array_equal(pixels[:, w:], pred[:, :, 0] * 85)


def test_train_warm_starts_from_jax_checkpoint(jax_checkpoint, tmp_path,
                                               capsys):
    root, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    _write_acdc(root)
    train_main(_args(root, ckpt, 0, "--weights_unet", jax_checkpoint[0]))
    out = capsys.readouterr().out
    assert "Loaded pretrained UNet weights." in out
    assert "Training Done!" in out
