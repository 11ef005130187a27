"""The port's saliency (saunet_tpu_torch/interpret, cli/saliency) against
the JAX package's saunet_tpu/interpret/saliency.py.

The JAX side is the committed golden file tests/torch_golden/saliency_32.npz
(a live JAX gradient of the whole SAUNet takes minutes to compile on the
CPU): vanilla and guided gradients and SmoothGrad (n=4, batch 2,
PRNGKey(0)) of an f32 SAUNet with `golden_variables`, on a phantom slice at
32² with its label mask as the target, plus the four noisy images JAX drew.
Regenerate it with `torch_port_util.write_saliency_golden`."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from saunet_tpu.interpret import convert_to_grayscale as grayscale_jax
from saunet_tpu.interpret import positive_negative_saliency as posneg_jax
from saunet_tpu.interpret import save_gradient_image as save_image_jax
from saunet_tpu_torch.cli.saliency import main as saliency_main
from saunet_tpu_torch.interpret import (
    convert_to_grayscale,
    guided_gradients,
    guided_model,
    guided_relu,
    positive_negative_saliency,
    save_gradient_image,
    smooth_grad,
    vanilla_gradients,
)
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from test_torch_train_cli import _write_acdc
from torch_port_util import (  # noqa: F401  (fixture)
    GOLDEN_SALIENCY,
    SALIENCY_BATCH,
    SALIENCY_N,
    golden_variables_like,
    one_thread,
)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN_SALIENCY))


@pytest.fixture(scope="module")
def model():
    m = build_unet(dtype="float32")
    m.load_state_dict(from_jax_variables(golden_variables_like(m)))
    return m.eval()


@pytest.fixture(scope="module")
def inputs(golden):
    return (torch.from_numpy(golden["image"]),
            torch.from_numpy(golden["target"]))


def _max_err(ours: torch.Tensor, ref: np.ndarray) -> float:
    """max|ours - ref| over max|ref|."""
    return float(np.abs(ours.numpy() - ref).max() / np.abs(ref).max())


def test_vanilla_matches_jax(model, inputs, golden):
    g = vanilla_gradients(model, *inputs)
    assert g.shape == inputs[0].shape
    assert _max_err(g, golden["vanilla"]) <= 1e-4


def test_guided_matches_jax(model, inputs, golden):
    """Guided differs from vanilla, and every ReLU the JAX model routes
    through `act` is guided in the port (a site missed or added moves the
    map by far more than the tolerance)."""
    g = guided_gradients(model, *inputs)
    assert not np.allclose(golden["guided"], golden["vanilla"])
    assert _max_err(g, golden["guided"]) <= 1e-4


def test_smooth_grad_matches_jax(model, inputs, golden):
    """The mean of the port's gradients over JAX's noisy images, two to a
    backward as JAX's chunks, is JAX's SmoothGrad."""
    target = inputs[1]
    noisy = torch.from_numpy(golden["noisy"])
    assert noisy.shape[0] == SALIENCY_N
    grads = torch.cat([vanilla_gradients(model, noisy[i:i + SALIENCY_BATCH],
                                         target)
                       for i in range(0, SALIENCY_N, SALIENCY_BATCH)])
    assert _max_err(grads.mean(dim=0), golden["smooth_grad"]) <= 1e-4


def test_batched_smooth_grad_equals_per_sample_loop(model, inputs):
    """One backward over a chunk of noisy copies gives each copy its own
    gradient (eval BatchNorm, per-sample gray rescale)."""
    image, target = inputs
    seen = []

    def grad_fn(batch):
        seen.append(batch)
        return vanilla_gradients(model, batch, target)

    gen = torch.Generator().manual_seed(0)
    sg = smooth_grad(grad_fn, gen, image, n=4, batch_size=2)
    assert [b.shape[0] for b in seen] == [2, 2]
    loop = torch.stack([vanilla_gradients(model, x, target)
                        for x in torch.cat(seen)]).mean(dim=0)
    assert float((sg - loop).abs().max() / loop.abs().max()) <= 1e-5


def test_smooth_grad_noise_std():
    """Noise std (sigma_multiplier / (max - min)) ** 2, mean 0, within
    sampling error of 50 x 64 x 64 x 3 draws (std of the std estimate
    0.1%); zero noise returns grad_fn(image) itself."""
    image = torch.from_numpy(
        np.random.RandomState(0).randn(64, 64, 3).astype(np.float32))
    draws = []

    def grad_fn(batch):
        draws.append(batch - image)
        return batch * 2.0

    gen = torch.Generator().manual_seed(1)
    smooth_grad(grad_fn, gen, image, n=50, sigma_multiplier=4.0)
    noise = torch.cat(draws)
    want = (4.0 / float(image.max() - image.min())) ** 2
    assert noise.shape == (50, 64, 64, 3)
    assert abs(float(noise.std()) / want - 1) < 0.01
    assert abs(float(noise.mean())) < 0.01 * want
    plain = smooth_grad(grad_fn, gen, image, n=8, sigma_multiplier=0.0)
    torch.testing.assert_close(plain, image * 2.0, rtol=1e-6, atol=0)


def test_guided_relu_rule():
    x = torch.tensor([-2.0, -0.5, 0.0, 0.5, 2.0], requires_grad=True)
    torch.testing.assert_close(guided_relu(x).detach(),
                               torch.tensor([0, 0, 0, 0.5, 2.0]))
    # upstream grads: x <= 0 -> 0; upstream negative -> 0; else upstream
    x = torch.tensor([-1.0, 1.0, 2.0, 3.0], requires_grad=True)
    (g,) = torch.autograd.grad(
        (guided_relu(x) * torch.tensor([1.0, 1.0, -1.0, 2.0])).sum(), x)
    assert g.tolist() == [0.0, 1.0, 0.0, 2.0]


def test_guided_model_shares_weights(model):
    gm = guided_model(model)
    assert all(a is b for a, b in zip(gm.parameters(), model.parameters()))
    acts = [m.act for m in gm.modules() if hasattr(m, "act")]
    assert acts and all(a is guided_relu for a in acts)
    assert all(m.act is not guided_relu for m in model.modules()
               if hasattr(m, "act"))


def test_canny_input_is_gradient_opaque(model):
    """The Canny cue's input is detached: no gradient reaches the image
    through it (its kernel has no backward)."""
    gray = (torch.rand(1, 32, 32, 1, generator=torch.Generator()
                       .manual_seed(3)) * 255).requires_grad_(True)
    edges = model._canny(gray)
    assert edges.grad_fn is None and not edges.requires_grad
    (g,) = torch.autograd.grad((edges * gray).sum(), gray)
    torch.testing.assert_close(g, edges, rtol=0, atol=0)


def test_grayscale_and_posneg_match_jax():
    g = np.random.RandomState(4).randn(16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(convert_to_grayscale(g), grayscale_jax(g))
    for ours, ref in zip(positive_negative_saliency(g), posneg_jax(g)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape", [(12, 10, 3), (12, 10), (12, 10, 2)],
                         ids=["rgb", "gray", "first_channel"])
def test_png_matches_jax_image(tmp_path, shape):
    """utils/png.py's file decodes to the pixels of the JAX package's
    (PIL's) file."""
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    save_gradient_image(g, ours)
    save_image_jax(g, ref)
    with Image.open(ours) as a, Image.open(ref) as b:
        assert a.mode == b.mode and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def saliency_setup(tmp_path_factory, model):
    """A synthetic ACDC root and a .pt of the golden weights."""
    tmp = tmp_path_factory.mktemp("saliency")
    root, ckpt = str(tmp / "data"), str(tmp / "model.pt")
    _write_acdc(root)
    torch.save(model.state_dict(), ckpt)
    return root, ckpt


@pytest.mark.parametrize("method", ["vanilla", "guided", "smoothgrad",
                                    "smoothgrad-guided"])
def test_saliency_cli_writes_four_maps(tmp_path, saliency_setup, method):
    root, ckpt = saliency_setup
    out = str(tmp_path / "maps")
    saliency_main(["--checkpoint", ckpt, "--data-root", root,
                   "--crop_size", "32", "--method", method, "--param_n",
                   "2", "--slice", "1", "--out", out, "--device", "cpu"])
    tag = f"patient001_frame01_z1_{method}"
    assert sorted(os.listdir(out)) == sorted(
        f"{tag}_{k}.png" for k in ("color", "gray", "neg", "pos"))
    with Image.open(os.path.join(out, f"{tag}_color.png")) as im:
        assert im.mode == "RGB" and im.size == (32, 32)
    with Image.open(os.path.join(out, f"{tag}_gray.png")) as im:
        pixels = np.asarray(im)
        assert im.mode == "L" and pixels.max() > pixels.min()
