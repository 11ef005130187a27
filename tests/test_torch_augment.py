"""The port's training augmentation and the K5 gather/warp wrappers against
the JAX package on the CPU (the wrappers' plain versions), plus the kernels
against their plain versions on the card (skipped without one).

The two frameworks' generators give different numbers from one seed, so the
coordinate test takes the JAX draws (the keys `_coords_one` splits, in its
order) and hands them to `coords_from_draws`. The JAX package is imported
inside the `jx` fixture, so that the card test also runs where jax is not
installed (`pytest --noconftest`)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saunet_tpu_torch.data import augment
from saunet_tpu_torch.ops.cuda import warp
from torch_port_util import cuda_device, one_thread  # noqa: F401  (fixtures)


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's augmentation module."""
    jax = pytest.importorskip("jax")
    from saunet_tpu.data import augment as aug_jax
    return SimpleNamespace(jax=jax, jnp=jax.numpy, aug=aug_jax)


def jax_draws(jax, keys, h: int, w: int) -> dict:
    """The draws of `_coords_one` for each key, as torch tensors."""
    jnp = jax.numpy
    hl, wl = -(-h // 4), -(-w // 4)
    d = {k: [] for k in ("flip_h", "flip_v", "angle", "do_el", "field_x",
                         "field_y", "use_low", "u_gamma")}
    for key in keys:
        k = jax.random.split(key, 8)
        d["flip_h"].append(jax.random.bernoulli(k[0]))
        d["flip_v"].append(jax.random.bernoulli(k[1]))
        d["angle"].append(jax.random.uniform(k[2], minval=-jnp.pi,
                                             maxval=jnp.pi))
        d["do_el"].append(jax.random.bernoulli(k[3]).astype(jnp.float32))
        d["field_x"].append(jax.random.uniform(k[4], (1, hl, wl))[0])
        d["field_y"].append(jax.random.uniform(k[5], (1, hl, wl))[0])
        d["use_low"].append(jax.random.bernoulli(k[6]))
        d["u_gamma"].append(jax.random.uniform(k[7]))
    return {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for k, v in d.items()}


@pytest.mark.parametrize("hw", [(224, 224), (30, 26)])
def test_coords_from_draws_matches_jax(jx, hw):
    h, w = hw
    jax = jx.jax
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    sy_j, sx_j, g_j = (np.asarray(a) for a in jax.vmap(
        lambda r: jx.aug._coords_one(r, h, w, True))(keys))
    d = jax_draws(jax, keys, h, w)
    assert 0 < int(d["do_el"].sum()) < 6  # both branches are exercised
    sy, sx, gamma = augment.coords_from_draws(h=h, w=w, **d)
    np.testing.assert_allclose(sy.numpy(), sy_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(sx.numpy(), sx_j, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(gamma.numpy(), g_j)


def _warp_inputs(seed: int, n=3, h=30, w=26, classes=4):
    rs = np.random.RandomState(seed)
    img = (rs.rand(n, h, w) * 300).astype(np.float32)
    lab = rs.randint(0, classes, (n, h, w)).astype(np.int32)
    sy = (rs.rand(n, h, w) * (h + 6) - 3).astype(np.float32)
    sx = (rs.rand(n, h, w) * (w + 6) - 3).astype(np.float32)
    return img, lab, sy, sx


def test_warp_plain_matches_packed_jax_warp(jx):
    img, lab, sy, sx = _warp_inputs(1)
    ri, rl = jx.aug._warp_image_label_packed(
        *(jx.jnp.asarray(a) for a in (img, lab, sy, sx)), 4)
    before = warp.warp_image_label.launches
    pi, pl = warp.warp_image_label(*(torch.from_numpy(a)
                                     for a in (img, lab, sy, sx)))
    assert warp.warp_image_label.launches == before  # plain on the CPU
    assert pi.dtype == torch.float32 and pl.dtype == torch.int32
    ri = np.asarray(ri)
    np.testing.assert_allclose(pi.numpy(), ri, rtol=0,
                               atol=1e-5 * np.abs(ri).max())
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))


def test_unpacked_samplers_match_jax(jx):
    """num_classes > 4 takes the unpacked samplers (f32 taps, labels
    rounded half to even): the resample kernel's wrapper."""
    img, lab, sy, sx = _warp_inputs(2, classes=6)
    jsy, jsx = jx.jnp.asarray(sy), jx.jnp.asarray(sx)
    ri = np.asarray(jx.aug._sample_bilinear_batched(jx.jnp.asarray(img),
                                                    jsy, jsx))
    rl = np.asarray(jx.aug._sample_nearest_batched(jx.jnp.asarray(lab),
                                                   jsy, jsx))
    t = [torch.from_numpy(a) for a in (img, lab, sy, sx)]
    before = warp.resample.launches
    pi, pl = warp.resample(t[0], t[1].int(), t[2], t[3])
    assert warp.resample.launches == before  # plain on the CPU
    np.testing.assert_allclose(pi.numpy(), ri, rtol=0,
                               atol=1e-5 * np.abs(ri).max())
    np.testing.assert_array_equal(pl.numpy(), rl)


def test_edge_ground_truth_matches_jax(jx):
    lab = np.random.RandomState(3).randint(0, 4, (3, 20, 24)).astype(
        np.int32)
    ref = np.asarray(jx.aug.edge_ground_truth(jx.jnp.asarray(lab), 4))
    ours = augment.edge_ground_truth(torch.from_numpy(lab), 4).numpy()
    assert ours.shape == ref.shape == (3, 20, 24, 1)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("num_classes", [4, 5])
def test_augment_given_jax_coords_matches_jax(jx, num_classes):
    """The whole augmentation after the draws (warp, gamma, z-score,
    channels, edge) on the coordinates and gamma JAX drew."""
    n, h, w = 4, 30, 26
    rs = np.random.RandomState(4)
    yy, xx = np.mgrid[:h, :w]
    img = (100 + 150 * ((yy - 15) ** 2 + (xx - 13) ** 2 < 64)
           + 20 * rs.rand(n, h, w)).astype(np.float32)
    lab = np.where((yy - 15) ** 2 + (xx - 13) ** 2 < 64, 1 + (xx > 13), 0)
    lab = np.broadcast_to(lab, (n, h, w)).astype(np.int32)
    jax, jnp = jx.jax, jx.jnp
    rng = jax.random.PRNGKey(7)
    ref = jx.aug.make_augment_fn(num_classes)(
        rng, {"image": jnp.asarray(img), "label": jnp.asarray(lab)})
    sy, sx, gamma = jax.vmap(lambda r: jx.aug._coords_one(r, h, w, True))(
        jax.random.split(rng, n))
    ours = augment.augment_with_coords(
        torch.from_numpy(img), torch.from_numpy(lab),
        *(torch.from_numpy(np.array(a)) for a in (sy, sx, gamma)),
        num_classes=num_classes)
    assert ours["image"].shape == (n, h, w, 3)
    np.testing.assert_allclose(ours["image"].numpy(),
                               np.asarray(ref["image"]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours["label"].numpy(),
                                  np.asarray(ref["label"]))
    np.testing.assert_array_equal(ours["edge"].numpy(),
                                  np.asarray(ref["edge"]))


def test_make_augment_fn_draws_from_the_generator():
    rs = np.random.RandomState(5)
    batch = {"image": torch.from_numpy(
                 (rs.rand(3, 24, 20, 1) * 300).astype(np.float32)),
             "label": torch.from_numpy(
                 rs.randint(0, 4, (3, 24, 20)).astype(np.int64))}
    fn = augment.make_augment_fn()
    a = fn(torch.Generator().manual_seed(0), batch)
    b = fn(torch.Generator().manual_seed(0), batch)
    c = fn(torch.Generator().manual_seed(1), batch)
    assert a["image"].shape == (3, 24, 20, 3)
    assert a["label"].dtype == torch.int32 and a["edge"].shape == (3, 24,
                                                                   20, 1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["image"], c["image"])
    assert torch.equal(a["edge"], augment.edge_ground_truth(a["label"]))
    z = a["image"][..., 0]
    np.testing.assert_allclose(z.mean(dim=(1, 2)).numpy(), 0, atol=1e-5)
    with pytest.raises(ValueError, match="Generator"):
        fn(None, batch)


@pytest.mark.parametrize("mode", ["lane", "sublane", "flat"])
def test_gather_plain_matches_numpy(mode):
    rs = np.random.RandomState(6)
    n, h, w = 2, 7, 9
    img = rs.rand(n, h, w).astype(np.float32)
    lim = {"lane": w, "sublane": h, "flat": h * w}[mode]
    idx = rs.randint(0, lim, (n, h, w)).astype(np.int32)
    if mode == "lane":
        ref = np.take_along_axis(img, idx, axis=2)
    elif mode == "sublane":
        ref = np.take_along_axis(img, idx, axis=1)
    else:
        ref = np.take_along_axis(img.reshape(n, -1), idx.reshape(n, -1),
                                 axis=1).reshape(n, h, w)
    out = warp.gather_image(torch.from_numpy(img), torch.from_numpy(idx),
                            mode)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="gather mode"):
        warp.gather_image(torch.from_numpy(img), torch.from_numpy(idx),
                          "diagonal")


@pytest.mark.parametrize("n, h, w", [(4, 64, 48), (3, 37, 45),
                                     (2, 224, 224)],
                         ids=["64x48", "37x45", "224x224"])
def test_warp_and_gather_kernels_match_plain_on_card(cuda_device, n, h,
                                                     w):  # noqa: F811
    """Exact on the card: widths that are a multiple of 4 take the kernels'
    16-byte form, 37x45 their pixel-by-pixel form (rows and planes that end
    inside a thread's 4 pixels)."""
    img, lab, sy, sx = _warp_inputs(7, n=n, h=h, w=w)
    t = [torch.from_numpy(a).to(cuda_device) for a in (img, lab, sy, sx)]
    out_i, out_l = warp.warp_image_label(*t)
    ref_i, ref_l = warp.warp_image_label_plain(*t)
    torch.cuda.synchronize()
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_l, ref_l)
    for mode, lim in (("lane", w), ("sublane", h), ("flat", h * w)):
        idx = torch.randint(0, lim, t[0].shape, dtype=torch.int32,
                            device=cuda_device)
        assert torch.equal(warp.gather_image(t[0], idx, mode),
                           warp.gather_image_plain(t[0], idx, mode)), mode
