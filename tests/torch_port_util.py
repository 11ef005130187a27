"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Variables for the JAX models are built without a flax `init` of the whole
model (a jitted SAUNet init takes over a minute on one CPU core):
`jax.eval_shape` gives the tree of shapes and `fill_variables` fills every
leaf from a numpy seed.
"""
from __future__ import annotations

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


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (the
    kernels are compiled and run only on a GPU)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)
