"""The port's Canny operator (saunet_tpu_torch.ops.edge and the CUDA kernel
wrapper ops/cuda/canny.py) against the JAX package's XLA operator and its
two Pallas kernels in interpret mode. Inputs are made with numpy from a
seed and fed to both sides. On the CPU the wrapper runs the plain version;
the kernel itself is held against it in the test that needs the card.

The JAX package is imported inside the tests that use it, so that the card
test also runs where jax is not installed (`pytest --noconftest`, since
tests/conftest.py imports jax)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saunet_tpu_torch.ops.cuda import canny_edges_cuda
from saunet_tpu_torch.ops.edge import canny_edges, image_to_gray255
from torch_port_util import cuda_device, one_thread  # noqa: F401  (fixtures)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's Canny operators, and jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from saunet_tpu.ops.edge import canny_edges, image_to_gray255
    from saunet_tpu.ops.pallas.canny import (
        canny_edges_pallas,
        canny_edges_pallas_tiled,
    )
    return SimpleNamespace(jnp=jnp, canny=canny_edges, gray=image_to_gray255,
                           pallas=canny_edges_pallas,
                           tiled=canny_edges_pallas_tiled)


def _structured_64():
    """The 64x64 blob-and-step image of tests/test_pallas_canny.py."""
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    img = (100 * np.exp(-((yy - 20) ** 2 + (xx - 30) ** 2) / 100.0)
           + 80 * (xx > 40) + 10 * rs.rand(64, 64)).astype(np.float32)[None]
    return np.clip(img, 0, 255)


def _structured_64x48():
    """The batch-of-2 64x48 image of the tiled-kernel test."""
    rs = np.random.RandomState(4)
    yy, xx = np.mgrid[0:64, 0:48].astype(np.float32)
    img = (120 * np.exp(-((yy - 40) ** 2 + (xx - 12) ** 2) / 60.0)
           + 90 * (yy > 50) + 12 * rs.rand(64, 48)).astype(np.float32)[None]
    gray = np.clip(img, 0, 255)
    return np.concatenate([gray, gray[:, ::-1]], axis=0)


def _port(gray: np.ndarray) -> np.ndarray:
    return canny_edges(torch.from_numpy(gray[..., None].copy())).numpy()


def test_canny_exact_vs_xla_and_pallas(jx):
    gray = _structured_64()
    ours = _port(gray)
    xla = np.asarray(jx.canny(jx.jnp.asarray(gray[..., None])))
    pallas = np.asarray(jx.pallas(jx.jnp.asarray(gray), interpret=True))
    assert ours.shape == (1, 64, 64, 1) and ours.dtype == np.float32
    assert (ours > 0).sum() > 0
    np.testing.assert_array_equal(ours, xla)
    np.testing.assert_array_equal(ours, pallas)


def test_canny_exact_vs_tiled_pallas(jx):
    gray = _structured_64x48()
    ours = _port(gray)
    tiled = np.asarray(jx.tiled(jx.jnp.asarray(gray), tile_rows=16,
                                interpret=True))
    np.testing.assert_array_equal(ours, tiled)


@pytest.mark.parametrize("seed,shape", [(1, (3, 32, 32)), (2, (2, 40, 24))])
def test_canny_random_agreement(jx, seed, shape):
    """Uniform noise puts many magnitudes next to the thresholds, where
    XLA's Sobel convolution and the shifted adds may round apart."""
    gray = (np.random.RandomState(seed).rand(*shape) * 255).astype(
        np.float32)
    ours = _port(gray)
    ref = np.asarray(jx.canny(jx.jnp.asarray(gray[..., None])))
    flips = int((ours != ref).sum())
    agree = 1.0 - flips / ref.size
    print(f"canny random {shape}: {flips} flips of {ref.size}")
    assert set(np.unique(ours)) <= {0.0, 255.0}
    assert agree >= 0.999


def test_wrapper_runs_plain_version_on_cpu():
    gray = torch.from_numpy(_structured_64())
    before = canny_edges_cuda.launches
    out = canny_edges_cuda(gray)
    assert canny_edges_cuda.launches == before  # no kernel on the CPU
    torch.testing.assert_close(out, canny_edges(gray), rtol=0, atol=0)
    assert out.shape == (1, 64, 64, 1)


def test_image_to_gray255(jx):
    x = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)
    ours = image_to_gray255(torch.from_numpy(x)).numpy()
    ref = np.asarray(jx.gray(jx.jnp.asarray(x)))
    assert ours.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)


def test_canny_kernel_matches_plain_on_card(cuda_device):  # noqa: F811
    """The CUDA kernel against its plain version on the card: several row
    bands with a ragged last band (100x70), the 64x48 image, 512x512 (a
    16-word window, 32-row bands), an odd width that ends inside a bit
    word and is not a multiple of 4 (37x45, scalar loads and stores), and
    a width past 512 columns (several windows with a word of halo)."""
    rs = np.random.RandomState(3)
    grays = [(rs.rand(*shape) * 255).astype(np.float32)
             for shape in ((4, 100, 70), (2, 512, 512), (3, 37, 45),
                           (1, 40, 1100))]
    for g in grays + [_structured_64x48()]:
        t = torch.from_numpy(g).to(cuda_device)
        before = canny_edges_cuda.launches
        out = canny_edges_cuda(t[..., None].contiguous())
        torch.cuda.synchronize()
        assert canny_edges_cuda.launches == before + 1
        torch.testing.assert_close(out, canny_edges(t), rtol=0, atol=0)
