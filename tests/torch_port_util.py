"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Variables for the JAX models are built without a flax `init` of the whole
model (a jitted SAUNet init takes over a minute on one CPU core):
`jax.eval_shape` gives the tree of shapes and `fill_variables` fills every
leaf from a numpy seed.
"""
from __future__ import annotations

import os

import numpy as np
import pytest


def fill_variables(shapes, seed: int) -> dict:
    """Fill a {'params', 'batch_stats'} tree of ShapeDtypeStructs:
    conv kernels N(0, sqrt(2/fan_in)), biases 0.1*N, BN scale 1 + 0.1*N,
    running mean 0.1*N, running var 0.5 + U(0, 1)."""
    import jax

    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        keys = [getattr(p, "key", str(p)) for p in path]
        shape, name = tuple(leaf.shape), keys[-1]
        if keys[0] == "batch_stats":
            v = (0.1 * rs.randn(*shape) if name == "mean"
                 else 0.5 + rs.rand(*shape))
        elif name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        else:  # conv and BN biases
            v = 0.1 * rs.randn(*shape)
        out.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def to_jax_variables(model) -> dict:
    """A port model's weights as the JAX package's variable tree (the
    inverse of `from_jax_variables`)."""
    from torch import nn

    params, stats = {}, {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value.detach().cpu().numpy()

    for name, m in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, nn.BatchNorm2d):
            put(params, path + ("scale",), m.weight)
            put(params, path + ("bias",), m.bias)
            put(stats, path + ("mean",), m.running_mean)
            put(stats, path + ("var",), m.running_var)
        elif isinstance(m, nn.ConvTranspose2d):
            put(params, path + ("kernel",),
                m.weight.permute(2, 3, 0, 1).flip(0, 1))
        elif isinstance(m, nn.Conv2d):
            put(params, path + ("kernel",), m.weight.permute(2, 3, 1, 0))
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) \
                and m.bias is not None:
            put(params, path + ("bias",), m.bias)
    return {"params": params, "batch_stats": stats}


GOLDEN_TRAIN_STEP = os.path.join(os.path.dirname(__file__), "torch_golden",
                                 "train_step_32.npz")
# One train step of the JAX package at this size, seeds and learning rate.
# Batch 8, not 2: at batch 2 the center block's BatchNorm normalises two
# values per channel (1x1 maps at 32^2), and the train-mode gradient is then
# chaotic in f32 (a 1e-6 relative change of the input moves parameter
# updates by up to 4% of the largest); at batch 8 the same change moves them
# by under 0.2%.
GOLDEN_BATCH, GOLDEN_SIZE, GOLDEN_SEED, GOLDEN_LR = 8, 32, 0, 1e-3
# Leaves whose whole update the golden file stores (flax paths under params).
GOLDEN_LEAVES = (
    "encoder/conv0/kernel",
    "encoder/norm0/scale",
    "encoder/denseblock1/denselayer1/conv2/kernel",
    "encoder/denseblock3/denselayer24/norm1/bias",
    "encoder/denseblock4/denselayer16/norm2/scale",
    "encoder/norm5/bias",
    "res1/conv1/kernel",
    "gate2/gate_conv1/kernel",
    "fuse/kernel",
    "center/Conv_0/bias",
    "dec5/mrf_up/ConvTranspose_0/bias",
    "dec3/spatialAttn/phi/kernel",
    "dec2/channelAttn/fc1/kernel",
    "cw/kernel",
    "expand/Conv_0/kernel",
    "dec0/BatchNorm_0/scale",
    "final/kernel",
    "final/bias",
)


def golden_variables(jax_model) -> dict:
    """The golden step's starting variables for `jax_model` (a JAX SAUNet
    at GOLDEN_SIZE): eval_shape of its init, filled from GOLDEN_SEED.

    The shape stream's last kernel (`fuse`) is scaled by 0.05 so that the
    edge logits stay within about +-8. Filled as the others, they reach
    +-160: the sigmoid then saturates in f32, pixels land on the edge loss's
    clip bounds (1e-7, 1 - 1e-7), and whether a pixel's gradient passes
    the clip turns on the last bit of each framework's sigmoid."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda k: jax_model.init(
            k, jnp.zeros((1, GOLDEN_SIZE, GOLDEN_SIZE, 3)), train=False),
        jax.random.PRNGKey(0))
    variables = fill_variables({"params": shapes["params"],
                                "batch_stats": shapes["batch_stats"]},
                               seed=GOLDEN_SEED)
    fuse = variables["params"]["fuse"]
    fuse["kernel"] = fuse["kernel"] * np.float32(0.05)
    return variables


def golden_variables_like(port_model) -> dict:
    """`golden_variables` without tracing the JAX model: the port's modules
    carry the flax names, so `to_jax_variables(port_model)` is the same
    tree, and `fill_variables` fills it in the same order (about 1 s where
    the JAX init's eval_shape takes 5). `write_saliency_golden` checks that
    the two agree."""
    variables = fill_variables(to_jax_variables(port_model), seed=GOLDEN_SEED)
    fuse = variables["params"]["fuse"]
    fuse["kernel"] = fuse["kernel"] * np.float32(0.05)
    return variables


def golden_batch() -> dict:
    """The golden step's batch: numpy image (N, H, W, 3), int32 label
    (N, H, W) over 4 classes and a {0, 1} edge target (N, H, W, 1)."""
    rs = np.random.RandomState(GOLDEN_SEED + 1)
    n, s = GOLDEN_BATCH, GOLDEN_SIZE
    return {"image": rs.randn(n, s, s, 3).astype(np.float32),
            "label": rs.randint(0, 4, size=(n, s, s)).astype(np.int32),
            "edge": (rs.rand(n, s, s, 1) < 0.2).astype(np.float32)}


GOLDEN_EVAL_STEP = os.path.join(os.path.dirname(__file__), "torch_golden",
                                "eval_step_32.npz")


def padded_eval_batch() -> dict:
    """Two golden samples plus a third that repeats the second and is
    masked out by 'valid', as the train CLI pads its last validation batch
    (tests/torch_golden/make_eval_step_32.py runs the JAX eval step on
    it)."""
    b = {k: v[:2] for k, v in golden_batch().items()}
    batch = {k: np.concatenate([v, v[1:2]]) for k, v in b.items()}
    n = len(batch["label"])
    batch["valid"] = (np.arange(n) < n - 1).astype(np.float32)
    return batch


GOLDEN_SPACE_TRAIN_STEP = os.path.join(os.path.dirname(__file__),
                                       "torch_golden",
                                       "train_step_64_space.npz")
# The 'space' golden: the same seeds, weights and learning rate at 64^2 (the
# smallest crop whose deepest dense block keeps 2 rows a shard at space 2)
# on a ('data' 2, 'space' 2) mesh; tests/torch_golden/
# make_train_step_64_space.py writes it.
SPACE_SIZE, SPACE_BORDER = 64, 32


def space_batch() -> dict:
    """`golden_batch`'s draws at SPACE_SIZE, with high-contrast rows on
    either side of the 'space' shard border at SPACE_SIZE // 2 (2.0 above,
    -2.0 below, every channel): a conv, pool or resize that reads a wrong
    or zero halo row there moves the result by far more than rounding."""
    rs = np.random.RandomState(GOLDEN_SEED + 1)
    n, s = GOLDEN_BATCH, SPACE_SIZE
    batch = {"image": rs.randn(n, s, s, 3).astype(np.float32),
             "label": rs.randint(0, 4, size=(n, s, s)).astype(np.int32),
             "edge": (rs.rand(n, s, s, 1) < 0.2).astype(np.float32)}
    batch["image"][:, SPACE_BORDER - 1] = 2.0
    batch["image"][:, SPACE_BORDER] = -2.0
    return batch


def flat_leaves(tree: dict) -> dict:
    """{'a/b/c': array} for a nested dict of arrays."""
    import jax

    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def variables_digest(variables: dict) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes, in path order:
    a golden stores the digest of the variables it was computed from, and
    its test checks that it starts from the same."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(flat_leaves(variables).items()):
        v = np.ascontiguousarray(v)
        h.update(f"{k}|{v.dtype}|{v.shape}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def write_train_step_golden(path: str = GOLDEN_TRAIN_STEP) -> None:
    """Run one JAX `make_train_step` (SAUNet f32, XLA Canny, radam(1e-3),
    no augmentation) from `golden_variables` on `golden_batch`, with and
    without `fix_bn`, and store what tests/test_torch_train_step.py holds
    the port's step against. Takes a few minutes of XLA compile on one CPU
    core, so it runs once, by hand:

        JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
            import torch_port_util as u; u.write_train_step_golden()"
    """
    import jax
    import jax.numpy as jnp

    from saunet_tpu.models import build_unet
    from saunet_tpu.train.optim import radam
    from saunet_tpu.train.state import TrainState, make_train_step

    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = golden_variables(model)
    batch = {k: jnp.asarray(v) for k, v in golden_batch().items()}
    tx = radam(GOLDEN_LR)
    out = {}
    for prefix, fix_bn in (("", False), ("fix_bn/", True)):
        state = TrainState(step=jnp.zeros([], jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        step = make_train_step(model, tx, donate=False, fix_bn=fix_bn)
        new, metrics = step(state, batch)
        for k in ("loss", "ce", "dice", "edge", "acc", "jaccard"):
            out[f"{prefix}metric/{k}"] = np.asarray(metrics[k])
        old_p = flat_leaves(variables["params"])
        new_p = flat_leaves(new.params)
        names = sorted(old_p)
        out[f"{prefix}names"] = np.asarray(names)
        out[f"{prefix}update_norm"] = np.asarray(
            [np.linalg.norm(new_p[k] - old_p[k]) for k in names], np.float32)
        for k in GOLDEN_LEAVES:
            out[f"{prefix}update/{k}"] = new_p[k] - old_p[k]
        if not fix_bn:
            for k, v in flat_leaves(new.batch_stats).items():
                out[f"batch_stats/{k}"] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


GOLDEN_RESUME = os.path.join(os.path.dirname(__file__), "torch_golden",
                             "resume_32.npz")
# The resumed golden step: the golden step's variables and batch, taken up
# at step RESUME_COUNT with RAdam moments from `fill_opt_state`
# (RESUME_SEED) and radam(RESUME_LR). Count 7 makes update 8, RAdam's
# adaptive branch, where each element's update is m / sqrt(v): the moments
# are drawn large enough to lead it, since at this size the f32 train-mode
# gradient of some leaves moves by 1% with the summation order, and the
# update would carry that to the scale of the largest. The learning rate
# keeps the updates far above the parameters' f32 rounding.
# tests/torch_golden/make_resume_32.py writes it.
RESUME_COUNT, RESUME_SEED, RESUME_LR = 7, 11, 0.1
# the SegmentationModule golden's predict and infer_loss take the golden
# batch's first FACADE_SAMPLES samples (eval mode: no batch statistics)
FACADE_SAMPLES = 2


def fill_opt_state(tx, params, count: int, seed: int):
    """The optax state `tx.init(params)` would have after `count` updates,
    from `jax.eval_shape(tx.init, ...)` filled from a numpy seed (a live
    init of the whole SAUNet's state takes seconds): every `count` leaf
    `count`, second moments (`nu`) 0.1 * (0.5 + U(0, 1)), first moments
    and traces 0.3 * N(0, 1), f32 draws in tree order. Leaves are numpy."""
    import jax

    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(tx.init, params))
    out = []
    for path, leaf in leaves:
        names = [str(getattr(p, "name", getattr(p, "key", p))) for p in path]
        if names[-1] == "count":
            v = np.full(leaf.shape, count, leaf.dtype)
        elif "nu" in names:
            v = 0.1 * (0.5 + rng.random(leaf.shape, np.float32))
        else:
            v = 0.3 * rng.standard_normal(leaf.shape, np.float32)
        out.append(np.asarray(v, leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


GOLDEN_SALIENCY = os.path.join(os.path.dirname(__file__), "torch_golden",
                               "saliency_32.npz")
SALIENCY_SEED, SALIENCY_N, SALIENCY_BATCH = 2, 4, 2


def saliency_inputs():
    """The saliency golden's image, a phantom slice normalised as the
    CLIs do, numpy (GOLDEN_SIZE, GOLDEN_SIZE, 3) f32, and its int32
    label mask as the target."""
    from saunet_tpu_torch.data import make_phantom_set

    imgs, labels = make_phantom_set(1, hw=GOLDEN_SIZE, seed=SALIENCY_SEED)
    img = imgs[0]
    img = (img - img.mean()) / (img.std() + 1e-10)
    return np.repeat(img[..., None], 3, axis=-1), labels[0]


def write_saliency_golden(path: str = GOLDEN_SALIENCY) -> None:
    """Run the JAX package's vanilla and guided gradients and SmoothGrad
    (vanilla, PRNGKey(0), n=SALIENCY_N, batch SALIENCY_BATCH) of an f32
    SAUNet (XLA Canny) with `golden_variables` on `saliency_inputs`, and
    store them with the noisy images SmoothGrad drew, for
    tests/test_torch_saliency.py. A minute or two of XLA compile, so it
    runs once, by hand:

        JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
            import torch_port_util as u; u.write_saliency_golden()"
    """
    import jax
    import jax.numpy as jnp

    from saunet_tpu.interpret import (
        guided_gradients,
        smooth_grad,
        vanilla_gradients,
    )
    from saunet_tpu.models import build_unet

    from saunet_tpu_torch.models import build_unet as build_unet_port

    model = build_unet(dtype="float32", stream_impl="xla", edge_kernel="xla")
    variables = golden_variables(model)
    like = flat_leaves(golden_variables_like(build_unet_port()))
    want = flat_leaves(variables)
    assert sorted(like) == sorted(want) and all(
        np.array_equal(like[k], want[k]) for k in want)
    image_np, target_np = saliency_inputs()
    image, target = jnp.asarray(image_np), jnp.asarray(target_np)
    key = jax.random.PRNGKey(0)

    def vanilla(img):
        return vanilla_gradients(model, variables, img, target)

    # the noisy copies smooth_grad draws: one key a copy from split(key, n)
    std = (4.0 / (float(jnp.max(image)) - float(jnp.min(image)))) ** 2
    noisy = [image + jax.random.normal(k, image.shape, image.dtype) * std
             for k in jax.random.split(key, SALIENCY_N)]
    out = {"image": image_np, "target": target_np,
           "vanilla": np.asarray(vanilla(image)),
           "guided": np.asarray(guided_gradients(model, variables, image,
                                                 target)),
           "smooth_grad": np.asarray(smooth_grad(
               vanilla, key, image, n=SALIENCY_N,
               batch_size=SALIENCY_BATCH)),
           "noisy": np.stack([np.asarray(x) for x in noisy])}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (the
    kernels are compiled and run only on a GPU)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work runs on one intra-op thread. Every port test
    module imports this fixture (tests/test_torch_tools.py checks that),
    and every child process a port test starts gets OMP_NUM_THREADS=1: at
    test sizes more threads only contend with the other test workers (12
    train steps at 32^2 took 730 s on eight intra-op threads beside five
    busy workers, 14 s on one thread of one core; a saliency module that
    takes 16 s on one thread did not finish in 120 s on eight beside
    seven busy cores)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_saunet_shapes() -> dict:
    """`jax.eval_shape` of the JAX SAUNet(num_classes=4)'s init at 32^2 (no
    flax init): its {'params', 'batch_stats'} tree of ShapeDtypeStructs."""
    import jax
    import jax.numpy as jnp

    from saunet_tpu.models import SAUNet

    model = SAUNet(num_classes=4)
    return jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.PRNGKey(0))


def scaling_closed_forms(param_bytes: int) -> dict:
    """What a global-batch train step must all-reduce a rank, from the JAX
    SAUNet's variable tree: its gradients (the parameter count times
    `param_bytes`, the element size of the port's parameters), and the
    synced BatchNorm's statistics, (sum x, sum x^2, n) in f32 for every
    channel of every `batch_stats` entry, once in the forward and once in
    its backward."""
    import jax

    shapes = jax_saunet_shapes()
    params = sum(int(np.prod(leaf.shape))
                 for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    channels = sum(
        int(np.prod(leaf.shape)) for path, leaf in
        jax.tree_util.tree_flatten_with_path(shapes["batch_stats"])[0]
        if getattr(path[-1], "key", None) == "mean")
    return {"gradients": params * param_bytes,
            "bn_stats": 2 * 3 * 4 * channels}
