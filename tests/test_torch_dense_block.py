"""The port's eval dense block (saunet_tpu_torch.ops.cuda.dense_block: the
BN fold, the plain version and the CUDA kernel wrapper) and its fused
encoder, against the JAX package's DenseBlock and its Pallas kernel in
interpret mode, at the sizes of tests/test_dense_block_kernel.py
(3 layers, C0 64, 16x16, batch 2). The variables are filled from a numpy
seed and bridged into the port.

The JAX package is imported inside the fixture that uses it, so that the
card test also runs where jax is not installed (`pytest --noconftest`,
since tests/conftest.py imports jax)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saunet_tpu_torch.models.densenet import DenseBlock, DenseNetEncoder
from saunet_tpu_torch.models.fused_encoder import (
    encoder_apply_fused,
    fold_encoder,
)
from saunet_tpu_torch.models.init import init_random_
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.ops.cuda import (
    dense_block,
    dense_block_plain,
    fold_dense_block_params,
)
from saunet_tpu_torch.ops.cuda.dense_block import kernel_layout
from torch_port_util import (  # noqa: F401  (fixtures)
    cuda_device,
    fill_variables,
    one_thread,
)

NUM_LAYERS, C0, HW, EPS = 3, 64, 16, 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's dense block, its fold and its Pallas kernel."""
    jax = pytest.importorskip("jax")
    from saunet_tpu.models.densenet import DenseBlock as JaxDenseBlock
    from saunet_tpu.ops.pallas.dense_block import (
        dense_block_fused,
        fold_dense_block_params,
    )
    return SimpleNamespace(jax=jax, jnp=jax.numpy, block=JaxDenseBlock,
                           fold=fold_dense_block_params,
                           fused=dense_block_fused)


@pytest.fixture(scope="module")
def block(jx):
    """(jax variables, port DenseBlock with the same weights, input x)."""
    x = np.random.RandomState(0).randn(2, HW, HW, C0).astype(np.float32)
    shapes = jx.jax.eval_shape(
        lambda k, v: jx.block(NUM_LAYERS).init(k, v, False),
        jx.jax.random.PRNGKey(0), jx.jnp.asarray(x))
    variables = fill_variables(shapes, seed=0)
    port = DenseBlock(C0, NUM_LAYERS)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return variables, port.eval(), x


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def test_fold_matches_jax(jx, block):
    variables, port, _ = block
    ref = jx.fold(variables["params"], variables["batch_stats"], NUM_LAYERS,
                  C0, EPS)
    ours = fold_dense_block_params(port)
    assert set(ours) == set(ref)
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        o = ours[k].float().numpy()
        assert o.shape == r.shape, k
        assert ours[k].dtype == (torch.float32 if k == "b2"
                                 else torch.bfloat16), k
        tol = _bf16_ulp(r) if k != "b2" else 1e-6 * np.abs(r).max()
        assert np.all(np.abs(o - r) <= tol), k


def test_plain_f32_matches_flax_block(jx, block):
    variables, port, x = block
    ref = np.asarray(jx.block(NUM_LAYERS).apply(
        variables, jx.jnp.asarray(x), False))
    folded = fold_dense_block_params(port, dtype=torch.float32)
    out = dense_block_plain(torch.from_numpy(x), folded).numpy()
    assert out.shape == ref.shape == (2, HW, HW, C0 + 32 * NUM_LAYERS)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_plain_bf16_matches_pallas_interpret(jx, block):
    variables, port, x = block
    ref = np.asarray(jx.fused(
        jx.jnp.asarray(x), variables["params"], variables["batch_stats"],
        num_layers=NUM_LAYERS, eps=EPS, interpret=True), np.float32)
    folded = fold_dense_block_params(port)
    out = dense_block_plain(torch.from_numpy(x).to(torch.bfloat16), folded)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    tol = 0.05 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert np.median(np.abs(out - ref)) < tol / 10


def test_wrapper_runs_plain_version_on_cpu(block):
    _, port, x = block
    folded = fold_dense_block_params(port)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    before = dense_block.launches
    out = dense_block(xb, folded)
    assert dense_block.launches == before
    torch.testing.assert_close(out, dense_block_plain(xb, folded), rtol=0,
                               atol=0)


def test_kernel_layout(block):
    """The kernel's W1 and W2 layouts hold the folded weights, K contiguous
    per output channel, beside the JAX layout, which stays as it was."""
    _, port, _ = block
    folded = fold_dense_block_params(port)
    laid = kernel_layout(folded)
    assert set(laid) == set(folded) | {"w1t", "w2t"}
    for k, v in folded.items():
        assert laid[k] is v, k
    w1, w2, w1t, w2t = folded["w1"], folded["w2"], laid["w1t"], laid["w2t"]
    assert w1t.shape == (NUM_LAYERS, 128, w1.shape[1]) and w1t.is_contiguous()
    assert w2t.shape == (NUM_LAYERS, 9, 32, 128) and w2t.is_contiguous()
    assert torch.equal(w1t, w1.transpose(1, 2))
    for tap in range(9):
        assert torch.equal(w2t[:, tap], w2[:, :, tap * 32:(tap + 1) * 32]
                           .transpose(1, 2)), tap


def test_fused_encoder_matches_chain_encoder():
    """encoder_apply_fused (folded dense blocks, BN as an affine) against
    the port's own chain DenseNetEncoder in f32, on a cut-down encoder."""
    enc = init_random_(DenseNetEncoder((2, 2, 2, 2)),
                       torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(
        np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        ref = enc(x.permute(0, 3, 1, 2))
        out = encoder_apply_fused(enc, fold_encoder(enc, torch.float32), x,
                                  torch.float32)
    assert len(out) == 5
    for i, (o, r) in enumerate(zip(out, ref)):
        r = r.permute(0, 2, 3, 1)
        assert o.shape == r.shape, i
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("n, h, w, c0, num_layers", [
    (3, 21, 19, C0, NUM_LAYERS),  # ragged tiles, odd pixel count
    (2, 14, 14, 512, 3),          # block 4's width: one tile an image
    (3, 112, 112, 64, 2),         # block 1's size: more tiles than SMs
], ids=["ragged-21x19", "block4-14x14", "block1-112x112"])
def test_dense_block_kernel_matches_plain_on_card(cuda_device, n, h, w, c0,
                                                  num_layers):  # noqa: F811
    """The CUDA kernel against its plain bf16-mode version on the card:
    a spatial size that leaves ragged tiles, block 4's width at its 14x14
    (one tile an image, fewer tiles than SMs), and block 1's 112x112 (more
    tiles than SMs, so each block of the persistent grid takes several)."""
    gen = torch.Generator().manual_seed(0)
    port = init_random_(DenseBlock(c0, num_layers), gen).to(cuda_device)
    folded = kernel_layout(fold_dense_block_params(port.eval()))
    x = torch.randn(n, h, w, c0, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
    before = dense_block.launches
    out = dense_block(x, folded)
    ref = dense_block_plain(x, folded)
    torch.cuda.synchronize()
    assert dense_block.launches == before + 1
    err = (out.float() - ref.float()).abs()
    tol = 0.05 * float(ref.float().abs().max())
    assert float(err.max()) <= tol
    assert float(err.median()) < tol / 10
