"""The port's phantom generator (saunet_tpu_torch/data/phantom.py) against
the JAX package's, bit for bit."""
import numpy as np
import pytest

from saunet_tpu.data.phantom import make_phantom_set as make_phantom_set_jax
from saunet_tpu_torch.data import make_phantom_set
from torch_port_util import one_thread  # noqa: F401  (fixture)


@pytest.mark.parametrize("seed", [0, 7])
def test_phantoms_match_jax(seed):
    imgs, labels = make_phantom_set(n=3, hw=64, seed=seed)
    imgs_j, labels_j = make_phantom_set_jax(n=3, hw=64, seed=seed)
    assert imgs.dtype == np.float32 and labels.dtype == np.int32
    np.testing.assert_array_equal(imgs, imgs_j)
    np.testing.assert_array_equal(labels, labels_j)
    assert set(np.unique(labels)) == {0, 1, 2, 3}
