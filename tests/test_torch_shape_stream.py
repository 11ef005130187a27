"""The port's shape-stream route (saunet_tpu_torch.ops.cuda.shape_stream: the
BN fold, the plain version and the CUDA kernel wrapper; `SAUNet.
shape_stream_inputs` and `SAUNet.decode(edge_out=...)`) against the JAX
package's `fold_shape_stream_params`, its Pallas kernel in interpret mode
and its XLA shape stream, at the sizes of tests/test_shape_stream_kernel.py
(32x32, batch 2), on a bf16 SAUNet. The JAX side is read from
tests/torch_golden/shape_stream_32.npz (make_shape_stream_32.py writes it).

The variables are the JAX SAUNet's tree filled from a numpy seed
(`fill_variables`), never a flax `init` of the whole model; the encoder
taps f2..f5 are drawn from a numpy seed at their shapes (the encoder does
not run). Only the fixtures that compare with the golden use jax (for its
tree utilities), so that the card test also runs where jax is not
installed (`pytest --noconftest`)."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.blocks import (
    Conv2d,
    GatedSpatialConv,
    ResBasicBlock,
)
from saunet_tpu_torch.models.init import init_random_
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.ops.cuda import (
    fold_shape_stream_params,
    shape_stream_fused,
    shape_stream_plain,
)
from saunet_tpu_torch.ops.cuda.shape_stream import (
    CHANNELS,
    kernel_operands,
    layout_specs,
    operand_specs,
)
from torch_port_util import (  # noqa: F401  (fixtures)
    cuda_device,
    fill_variables,
    one_thread,
    to_jax_variables,
    variables_digest,
)

BATCH, SIZE, EPS = 2, 32, 1e-5
GOLDEN_STREAM = os.path.join(os.path.dirname(__file__), "torch_golden",
                             "shape_stream_32.npz")
# f2..f5 of a 32x32 input: (channels, side)
TAPS = ((128, 8), (256, 4), (512, 2), (1024, 2))
# The fuse kernel is scaled by this in every test. With the filled weights
# the edge sigmoid's inputs reach about +-40 and the stream is chaotic at
# the last bit: the plain version against itself under another summation
# order (mkldnn off) moves outputs by up to 0.15, against the Pallas kernel
# by 0.27, and the XLA stream (which rounds after every op) is 0.67 from the
# kernel. At 0.01 the edge stays within about 0.05..0.9.
FUSE_SCALE = 0.01


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def stream_inputs():
    """The encoder taps f2..f5 (NHWC) and the image, from a numpy seed."""
    rs = np.random.RandomState(1)
    taps = [rs.randn(BATCH, s, s, c).astype(np.float32) for c, s in TAPS]
    image = rs.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    return taps, image


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, read from GOLDEN_STREAM (the fold, the
    packed inputs, the Pallas kernel in interpret mode, the XLA stream),
    with the variables it was computed from (the bf16 SAUNet's tree filled
    from seed 0, the fuse kernel scaled by FUSE_SCALE; filled here on the
    port's identical tree, and held to the golden's digest), taps and
    image."""
    pytest.importorskip("jax")  # fill_variables flattens with its tree
    ref = dict(np.load(GOLDEN_STREAM))
    variables = fill_variables(to_jax_variables(build_unet(
        dtype="bfloat16")), seed=0)
    fuse = variables["params"]["fuse"]
    fuse["kernel"] = fuse["kernel"] * np.float32(FUSE_SCALE)
    assert str(ref["variables_digest"]) == variables_digest(variables)
    taps, image = stream_inputs()
    for i, tap in enumerate(taps):
        np.testing.assert_array_equal(ref[f"taps{i}"], tap)
    np.testing.assert_array_equal(ref["image"], image)
    return SimpleNamespace(variables=variables, taps=taps, image=image,
                           ref=ref)


def _port_args(jx, dtype=torch.bfloat16):
    taps = [torch.from_numpy(t).permute(0, 3, 1, 2).to(dtype)
            for t in jx.taps]
    return taps, torch.from_numpy(jx.image).permute(0, 3, 1, 2).to(dtype)


@pytest.fixture(scope="module")
def packed(jx):
    """The JAX package's packed stream input, (N, H, W, 67) bf16."""
    return jx.ref["packed"]


def _port_model(jx, dtype: str = "bfloat16"):
    model = build_unet(dtype=dtype)
    model.load_state_dict(from_jax_variables(jx.variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def port(jx):
    """The port's bf16 SAUNet with the same weights, and its fold."""
    model = _port_model(jx)
    return model, fold_shape_stream_params(model)


def test_fold_matches_jax(jx, port):
    ref = {k[len("fold/"):]: v for k, v in jx.ref.items()
           if k.startswith("fold/")}
    _, ours = port
    assert len(ours) == 3 * (18 + 2) + 1  # and r_w1k, r_w2k a stage
    checked = 0
    for i in range(3):
        c, cn = CHANNELS[i], CHANNELS[i + 1]

        def r(name, *idx):
            return np.asarray(ref[f"{name}"], np.float32)[idx]

        live = {
            "r_w1": r(f"r{i}_w1", slice(0, c), slice(0, 9 * c))
            .reshape(c, 9, c).transpose(1, 0, 2),
            "r_b1": r(f"r{i}_b1", 0, slice(0, c)),
            "r_w2": r(f"r{i}_w2", slice(0, c), slice(0, 9 * c))
            .reshape(c, 9, c).transpose(1, 0, 2),
            "r_b2": r(f"r{i}_b2", 0, slice(0, c)),
            "d_w": r(f"d{i}_w", slice(0, c), slice(0, cn)),
            "d_b": r(f"d{i}_b", 0, slice(0, cn)),
            "g_a_ss": r(f"g{i}_a_ss", 0, slice(0, cn)),
            "g_b_ss": r(f"g{i}_b_ss", 0, slice(0, cn)),
            "g_a_cue": r(f"g{i}_a_cue", 0, 0),
            "g_b_cue": r(f"g{i}_b_cue", 0, 0),
            "g_w1_ss": r(f"g{i}_w1_ss", slice(0, cn), slice(0, cn + 1)),
            "g_w1_cue": r(f"g{i}_w1_cue", 0, slice(0, cn + 1)),
            "g_b1": r(f"g{i}_b1", 0, slice(0, cn + 1)),
            "g_w2": r(f"g{i}_w2", slice(0, cn + 1), 0),
            "g_b2": r(f"g{i}_b2", 0, 0),
            "g_a2": r(f"g{i}_a2", 0, 0),
            "g_bn2b": r(f"g{i}_bn2b", 0, 0),
            "g_wg": r(f"g{i}_wg", slice(0, cn), slice(0, cn)),
        }
        specs = operand_specs(i)
        assert list(live) == list(specs)
        for name, want in live.items():
            got = ours[f"{i}/{name}"]
            shape, dtype = specs[name]
            assert tuple(got.shape) == shape and got.dtype == dtype, name
            got = got.float().numpy()
            tol = (_bf16_ulp(want) if dtype == torch.bfloat16
                   else 1e-6 * np.abs(want).max())
            assert np.all(np.abs(got - want) <= tol), f"{i}/{name}"
            checked += 1
    want = np.asarray(ref["fuse_w"], np.float32)[:8, 0]
    np.testing.assert_array_equal(ours["fuse_w"].float().numpy(), want)
    assert checked == 3 * 18


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shape_stream_inputs_match_jax(jx, port, packed, dtype):
    """In f32 the two compute the same function (the resize is exact in
    both). In bf16 the JAX resize multiplies by bf16-rounded interpolation
    weights (up to 0.4% off) and rounds between its row and column passes,
    so single values that cancel differ by many of their own ulps; both
    bf16 results stay within about 2 ulps of each channel's largest |value|
    from the f32 result, and within 3 of each other (measured)."""
    if dtype == "float32":
        model, ref = _port_model(jx, "float32"), jx.ref["inputs_f32"]
    else:
        model, ref = port[0], packed
    with torch.no_grad():
        ours = model.shape_stream_inputs(*_port_args(jx, model.dtype))
    assert ours.shape == (BATCH, SIZE, SIZE, 67) == ref.shape
    assert ours.dtype == model.dtype and ours.is_contiguous()
    err = np.abs(ours.float().numpy() - ref)
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    if dtype == "float32":
        assert np.all(err <= 2e-6 * scale)
    else:
        assert np.all(err <= 4 * _bf16_ulp(scale))


@pytest.mark.parametrize("band_rows", [None, 8])
def test_plain_matches_pallas_interpret(jx, port, packed, band_rows):
    """On the same packed input the plain version rounds where the Pallas
    kernel rounds; only summation orders differ. Measured, whole and
    banded alike: max|d| 0.0078 (two bf16 ulps of an output in [0.5, 1)),
    as large as the plain version's own spread under another summation
    order (mkldnn off); median 0. Held at 0.012 and 0.001."""
    ref = jx.ref["pallas/whole" if band_rows is None
                 else f"pallas/band{band_rows}"]
    out = shape_stream_plain(torch.from_numpy(packed), port[1]).numpy()
    assert out.shape == ref.shape == (BATCH, SIZE, SIZE, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.012)
    assert np.median(np.abs(out - ref)) <= 0.001


def test_plain_matches_xla_stream(jx, port):
    """Against the XLA `shape_stream(train=False)` of the bf16 model, which
    rounds after every op, at the tolerances of
    tests/test_shape_stream_kernel.py. Measured: max|d| 0.0148, median
    0.0017."""
    ref = jx.ref["xla_stream"]
    model, folded = port
    with torch.no_grad():
        packed = model.shape_stream_inputs(*_port_args(jx))
    out = shape_stream_plain(packed, folded).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.04)
    assert np.median(np.abs(out - ref)) < 0.004


def test_decode_with_edge_out_equals_decode(jx, port):
    model = port[0]
    taps, x = _port_args(jx)
    with torch.no_grad():
        edge, _ = model.shape_stream(taps, x)
        assert edge.shape == (BATCH, 1, SIZE, SIZE)
        seg_a, edge_a = model.decode(taps, x, edge_out=edge)
        seg_b, edge_b = model.decode(taps, x)
    assert torch.equal(seg_a, seg_b) and torch.equal(edge_a, edge_b)


def test_decode_rejects_edge_out_with_return_att(jx, port):
    taps, x = _port_args(jx)
    edge = torch.zeros(BATCH, 1, SIZE, SIZE)
    with pytest.raises(ValueError, match="return_att"):
        port[0].decode(taps, x, return_att=True, edge_out=edge)


def test_wrapper_runs_plain_version_on_cpu(port, packed):
    folded = port[1]
    x = torch.from_numpy(packed).to(torch.bfloat16)
    before = shape_stream_fused.launches
    out = shape_stream_fused(x, folded)
    assert shape_stream_fused.launches == before
    assert torch.equal(out, shape_stream_plain(x, folded))


def _stream_modules():
    """The stream's modules alone (res1..3, d1..3, gate1..3, fuse), as
    `SAUNet` names them, with seeded random weights and BN statistics."""
    m = torch.nn.Module()
    for i, (c, cn) in enumerate(zip(CHANNELS, CHANNELS[1:]), 1):
        setattr(m, f"res{i}", ResBasicBlock(c))
        setattr(m, f"d{i}", Conv2d(c, cn))
        setattr(m, f"gate{i}", GatedSpatialConv(cn, cn))
    m.fuse = Conv2d(CHANNELS[3], 1, bias=False)
    return init_random_(m, torch.Generator().manual_seed(2)).eval()


def test_kernel_layout():
    """The fold's kernel-layout conv weights hold exactly the JAX-layout
    ones, permuted (no rounding, no padding), and the kernel's operand
    order names each stage's operands once."""
    folded = fold_shape_stream_params(_stream_modules())
    for i in range(3):
        c = CHANNELS[i]
        for k, (shape, dtype) in layout_specs(i).items():
            laid, ref = folded[f"{i}/{k}"], folded[f"{i}/{k[:-1]}"]
            assert tuple(laid.shape) == shape and laid.dtype == dtype
            assert laid.is_contiguous()
            assert torch.equal(laid.permute(0, 1, 3, 2).reshape(9, c, c),
                               ref), f"{i}/{k}"
            assert torch.equal(laid.flatten().sort().values,
                               ref.flatten().sort().values)
        names = kernel_operands(i)
        assert len(names) == len(set(names)) == len(operand_specs(i))
        assert set(names) == (set(operand_specs(i)) - {"r_w1", "r_w2"}
                              | set(layout_specs(i)))


@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 37, 45), (4, 100, 150)])
def test_shape_stream_kernel_matches_plain_on_card(cuda_device,  # noqa: F811
                                                   shape):
    """The CUDA kernel against its plain version on the card, at 32x32, at
    a size whose 16x28 tiles do not divide the image (ragged tiles, and
    tile boundaries inside the image where the 2-pixel halo is recomputed),
    and at one with more tiles (4 x 7 x 6 = 168) than the persistent grid
    of stage 0 has blocks (one an SM), so that blocks walk several tiles.
    The fuse kernel is scaled by 0.01 so that the edge sigmoid does not
    saturate and amplify rounding flips; the tolerances are the JAX
    package's for its kernel against the XLA stream. The plain version's
    convolutions run in full f32 (cuDNN would take TF32 by default)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(0)
        model = init_random_(build_unet(dtype="bfloat16"), gen)
        with torch.no_grad():
            model.fuse.weight.mul_(FUSE_SCALE)
        folded = {k: v.to(cuda_device)
                  for k, v in fold_shape_stream_params(model.eval()).items()}
        n, h, w = shape
        packed = torch.randn(n, h, w, 67, generator=gen).to(
            cuda_device, torch.bfloat16)
        before = shape_stream_fused.launches
        out = shape_stream_fused(packed, folded)
        ref = shape_stream_plain(packed, folded)
        torch.cuda.synchronize()
        assert shape_stream_fused.launches == before + 1
        assert out.shape == ref.shape == (n, h, w, 1)
        err = (out - ref).abs()
        assert float(err.max()) <= 0.04
        assert float(err.median()) <= 0.004
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
