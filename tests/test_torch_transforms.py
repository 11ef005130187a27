"""The port's paired transforms (saunet_tpu_torch/data/transforms.py)
against the JAX package's (saunet_tpu/data/transforms.py) on the CPU, where
the resample kernel's wrapper takes its plain version; and the kernel
against that plain version on the card (skipped without one).

The frameworks' generators differ, so each JAX transform's draws are
recomputed from the sample's key by the same `jax.random` calls in the
same order, and handed to the port's `apply`. Images within 1e-5, masks
exact, the JAX side vmapped over the batch. The JAX package is imported
inside the `jx` fixture, so that the card test also runs where jax is not
installed (`pytest --noconftest`)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saunet_tpu_torch.data import transforms as T
from saunet_tpu_torch.ops.cuda import warp
from torch_port_util import cuda_device, one_thread  # noqa: F401  (fixtures)

N, H, W = 3, 20, 24


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from saunet_tpu.data import transforms as jt

    return SimpleNamespace(jax=jax, jnp=jnp, t=jt, r=jax.random)


def _inputs(channels=None, seed=0, h=H, w=W):
    rs = np.random.RandomState(seed)
    shape = (N, h, w) + ((channels,) if channels else ())
    return (rs.rand(*shape).astype(np.float32),
            rs.randint(0, 4, (N, h, w)).astype(np.int32))


def _uniform(r, key, lo=0.0, hi=1.0):
    return r.uniform(key, minval=lo, maxval=hi)


# each: (JAX transform, port transform, the draws of one sample's key by the
# JAX transform's own calls, the input's channels)
def _cases(jx):
    r, jt = jx.r, jx.t

    def crop_draws(key, size, h=H, w=W):
        ky, kx = r.split(key)
        return {"y0": r.randint(ky, (), 0, max(h - size, 0) + 1),
                "x0": r.randint(kx, (), 0, max(w - size, 0) + 1)}

    def translate_draws(key):
        ky, kx = r.split(key)
        return {"dy": r.randint(ky, (), -3, 4), "dx": r.randint(kx, (), -5, 6)}

    def sized_crop_draws(key):
        k1, k2, k3, k4 = r.split(key, 4)
        return {"area": _uniform(r, k1, 0.45, 1.0),
                "aspect": _uniform(r, k2, 0.5, 2.0),
                "uy": _uniform(r, k3), "ux": _uniform(r, k4)}

    def sized_draws(key):
        k1, k2 = r.split(key)
        return {"factor": _uniform(r, k1, 0.5, 2.0), **crop_draws(k2, 16)}

    def erasing_draws(key):
        k0, k1, k2, k3, k4 = r.split(key, 5)
        return {"do": r.bernoulli(k0, 0.7),
                "area": _uniform(r, k1, 0.02, 0.4),
                "ratio": _uniform(r, k2, 0.3, 1.0 / 0.3),
                "uy": _uniform(r, k3), "ux": _uniform(r, k4)}

    def f(lo, hi):
        return lambda key: {"f": _uniform(r, key, lo, hi)}

    def none(key):
        return {}

    return {
        "hflip": (jt.random_horizontally_flip(0.5),
                  T.random_horizontally_flip(0.5),
                  lambda k: {"do": r.bernoulli(k, 0.5)}, 3),
        "vflip": (jt.random_vertically_flip(0.5),
                  T.random_vertically_flip(0.5),
                  lambda k: {"do": r.bernoulli(k, 0.5)}, None),
        "rotate_rgb": (jt.random_rotate(180.0), T.random_rotate(180.0),
                       lambda k: {"angle": _uniform(r, k, -180.0, 180.0)},
                       3),
        "translate": (jt.random_translate((3, 5)),
                      T.random_translate((3, 5)), translate_draws, None),
        "center_crop_pad": (jt.center_crop(28), T.center_crop(28), none, 3),
        "random_crop": (jt.random_crop(16), T.random_crop(16),
                        lambda k: crop_draws(k, 16), None),
        "free_scale": (jt.free_scale((31, 17)), T.free_scale((31, 17)),
                       none, None),
        # exact .5 source coordinates: yy * 19 / 38 and xx * 23 / 46
        "free_scale_tie": (jt.free_scale((39, 47)), T.free_scale((39, 47)),
                           none, None),
        # factor 2: every odd output row and column samples at .5
        "scale_shorter_tie": (jt.scale_shorter_side(40, (40, 48)),
                              T.scale_shorter_side(40, (40, 48)), none, 3),
        "scale_shorter": (jt.scale_shorter_side(13, (16, 16)),
                          T.scale_shorter_side(13, (16, 16)), none, None),
        "random_sized_crop": (jt.random_sized_crop(16),
                              T.random_sized_crop(16), sized_crop_draws,
                              None),
        "random_sized": (jt.random_sized(16), T.random_sized(16),
                         sized_draws, None),
        "random_erasing": (jt.random_erasing(p=0.7),
                           T.random_erasing(p=0.7), erasing_draws, 3),
        "gamma": (jt.adjust_gamma(0.5), T.adjust_gamma(0.5), f(1.0, 1.5),
                  None),
        "brightness": (jt.adjust_brightness(40.0), T.adjust_brightness(40.0),
                       f(1 - 40.0 / 255, 1 + 40.0 / 255), 3),
        "contrast": (jt.adjust_contrast(0.3), T.adjust_contrast(0.3),
                     f(0.7, 1.3), None),
        "saturation": (jt.adjust_saturation(0.4), T.adjust_saturation(0.4),
                       f(0.6, 1.4), 3),
        "saturation_gray": (jt.adjust_saturation(0.4),
                            T.adjust_saturation(0.4), none, None),
        "hue": (jt.adjust_hue(0.2), T.adjust_hue(0.2), f(-0.2, 0.2), 3),
    }


CASES = ["hflip", "vflip", "rotate_rgb", "translate",
         "center_crop_pad", "random_crop", "free_scale",
         "free_scale_tie", "scale_shorter_tie", "scale_shorter",
         "random_sized_crop", "random_sized", "random_erasing", "gamma",
         "brightness", "contrast", "saturation", "saturation_gray", "hue"]
COMPOSE = ("hflip", "vflip", "center_crop_pad", "brightness")


@pytest.fixture(scope="module")
def jax_refs(jx):
    """Every case's JAX transform and draws, vmapped over the N samples'
    keys, in one jitted program (one compile instead of one a case)."""
    cases = _cases(jx)
    keys = jx.r.split(jx.r.PRNGKey(1), N)
    inputs = {name: _inputs(cases[name][3], 1) for name in CASES}

    inputs["compose"] = _inputs(3, 5)
    compose = [cases[n] for n in COMPOSE]

    def run(keys, inputs):
        out = {name: (jx.jax.vmap(cases[name][0])(keys, *inputs[name]),
                      jx.jax.vmap(cases[name][2])(keys))
               for name in CASES}
        # Compose splits each sample's key once a transform, in order
        ck = jx.r.split(jx.r.PRNGKey(5), N)
        ref = jx.jax.vmap(jx.t.Compose([c[0] for c in compose]))(
            ck, *inputs["compose"])
        draws = []
        for c in compose:
            split = jx.jax.vmap(jx.r.split)(ck)
            ck = split[:, 0]
            draws.append(jx.jax.vmap(c[2])(split[:, 1]))
        out["compose"] = (ref, draws)
        return out

    return inputs, jx.jax.jit(run)(keys, inputs)


@pytest.mark.parametrize("name", CASES)
def test_transform_matches_jax(jx, jax_refs, name):
    port_t = _cases(jx)[name][1]
    inputs, refs = jax_refs
    img, mask = inputs[name]
    (ref_i, ref_m), draws = refs[name]
    before = warp.resample.launches
    out_i, out_m = port_t.apply(
        {k: torch.tensor(np.asarray(v)) for k, v in draws.items()},
        torch.from_numpy(img), torch.from_numpy(mask))
    assert warp.resample.launches == before  # plain on the CPU
    ref_i, ref_m = np.asarray(ref_i), np.asarray(ref_m)
    assert out_i.shape == ref_i.shape and out_m.shape == ref_m.shape
    np.testing.assert_allclose(out_i.numpy(), ref_i, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out_m.numpy(), ref_m)
    if name.endswith("_tie"):  # the case holds ties that round to even
        assert out_i.shape[1] > H


def test_compose_matches_jax(jx, jax_refs):
    """Compose splits the key once a transform, in order."""
    inputs, refs = jax_refs
    (ref_i, ref_m), draws = refs["compose"]
    port_c = T.Compose([_cases(jx)[n][1] for n in COMPOSE])
    img, mask = inputs["compose"]
    out_i, out_m = port_c.apply(
        [{k: torch.tensor(np.asarray(v)) for k, v in d.items()}
         for d in draws], torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(out_i.numpy(), np.asarray(ref_i), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))


def test_draws_are_in_range():
    """The port's own draws: a generator call of each transform gives
    values in the JAX transform's ranges and the static output shape."""
    img, mask = (torch.from_numpy(a) for a in _inputs(3, 2))
    gen = torch.Generator().manual_seed(0)
    d = T.random_sized_crop(16).draw(gen, img, mask)
    assert ((d["area"] >= 0.45) & (d["area"] < 1.0)).all()
    assert ((d["aspect"] >= 0.5) & (d["aspect"] < 2.0)).all()
    d = T.random_translate((3, 5)).draw(gen, img, mask)
    assert (d["dy"].abs() <= 3).all() and (d["dx"].abs() <= 5).all()
    d = T.random_crop(16).draw(gen, img, mask)
    assert (d["y0"] <= H - 16).all() and (d["x0"] <= W - 16).all()
    out_i, out_m = T.Compose([T.random_rotate(10.0), T.random_sized(16),
                              T.adjust_gamma(0.5)])(gen, img, mask)
    assert out_i.shape == (N, 16, 16, 3) and out_m.shape == (N, 16, 16)
    assert out_m.dtype == torch.int32


@pytest.mark.parametrize("shape", [(4, 37, 45, 1, 30, 50), (3, 64, 64, 3,
                                                             56, 56)],
                         ids=["ragged", "rgb"])
def test_resample_kernel_matches_plain_on_card(cuda_device, shape):
    n, h, w, c, ho, wo = shape
    gen = torch.Generator().manual_seed(0)
    img = torch.rand((n, h, w, c) if c > 1 else (n, h, w), generator=gen)
    mask = torch.randint(0, 4, (n, h, w), generator=gen, dtype=torch.int32)
    sy = torch.rand(n, ho, wo, generator=gen) * (h + 4) - 2
    sx = torch.rand(n, ho, wo, generator=gen) * (w + 4) - 2
    sy[:, ::3] = torch.round(sy[:, ::3] * 2) / 2  # ties
    args = [t.to(cuda_device) for t in (img, mask, sy, sx)]
    before = warp.resample.launches
    out_i, out_m = warp.resample(*args)
    torch.cuda.synchronize()
    assert warp.resample.launches == before + 1
    ref_i, ref_m = warp.resample_plain(*args)
    assert torch.equal(out_i, ref_i) and torch.equal(out_m, ref_m)
