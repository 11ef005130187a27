"""The port's dense-block train layouts ('buffer', 'fused') and remat
against the JAX package.

  (a) `DenseBlock` in 'buffer' and 'fused' (3 layers, c0 = 64, batch 2,
      8x8, as tests/test_dense_block_train_fused.py sets it up) against the
      JAX `DenseBlock` in the same mode, in f32 and bf16: the forward, the
      updated batch statistics, the gradients of the input and of every
      parameter, and the eval forward;
  (b) remat: the running statistics after one step equal those without
      remat, and so do the gradients, in every layout;
  (c) the whole port SAUNet step in 'chain', 'buffer', 'fused' and
      'fused' + remat against the JAX step stored in
      tests/torch_golden/train_step_32.npz.

The layouts on two gloo ranks (the 'data' axis and a 'space' 2 grid) are
cases of tests/test_torch_parallel.py's pair of ranks, which spawns its
processes once for every rank-side case.

The JAX variables come from `jax.eval_shape` and `fill_variables`."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from saunet_tpu.models.densenet import DenseBlock as DenseBlockJax
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.densenet import DenseBlock, DenseNetEncoder
from saunet_tpu_torch.models.init import init_random_
from saunet_tpu_torch.models.jax_weights import (
    from_jax_variables,
    port_params,
)
from saunet_tpu_torch.parallel.parity import bn_buffers
from saunet_tpu_torch.train import create_train_state, make_train_step, radam
from torch_port_util import (  # noqa: F401  (fixture)
    GOLDEN_LEAVES,
    GOLDEN_LR,
    GOLDEN_TRAIN_STEP,
    fill_variables,
    flat_leaves,
    golden_batch,
    golden_variables_like,
    one_thread,
    to_jax_variables,
)

MODES = ("buffer", "fused")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# Tolerances, each as a fraction of the reference's largest magnitude
# (statistics: absolute). f32: both sides compute the same f32 math; the
# port's 'buffer' BatchNorm takes torch's two-pass variance where flax takes
# E[x^2] - E[x]^2, which agree to f32 rounding. bf16: the JAX reference is
# compiled without excess precision, so that every op's output is rounded
# to bf16 as torch rounds it (by default XLA keeps fused intermediates in
# f32, and its bf16 gradients then differ from the op-by-op ones by up to
# 22% of the largest: three BatchNorm backward passes in bf16 are that
# coarse, as far from the f32 gradients as either); what is left is a bf16
# rounding (2^-8) here and there in other summation orders, carried three
# layers deep (measured: gradients within 1.02e-2).
TOL = {"float32": {"forward": 1e-5, "stats": 1e-6, "grads": 1e-4},
       "bfloat16": {"forward": 2e-2, "stats": 2e-3, "grads": 3e-2}}
X_SHAPE = (2, 8, 8, 64)  # NHWC


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(
        lambda k: DenseBlockJax(3).init(k, jnp.zeros(X_SHAPE), True),
        jax.random.PRNGKey(0))
    return fill_variables(dict(shapes), seed=5)


def _x():
    return np.random.RandomState(0).randn(*X_SHAPE).astype(np.float32)


def _cotangent(shape):
    """sin(arange): a distinct cotangent for every output element."""
    return np.sin(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


# The reference is compiled once: XLA's cheapest CPU compile, and every
# op's output rounded to its type (see TOL)
COMPILE = {"xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True,
           "xla_cpu_use_fusion_emitters": False,
           "xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def jax_results(variables):
    """{(mode, dtype): forward, batch statistics, input and parameter
    gradients, eval forward} of the JAX block: one jitted program for
    every case."""
    stats = variables["batch_stats"]
    w = jnp.asarray(_cotangent(X_SHAPE[:3] + (64 + 3 * 32,)))

    def case(block, params, x):
        def loss(params, xx):
            y, mut = block.apply({"params": params, "batch_stats": stats},
                                 xx, True, mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * w), (y, mut)

        (_, (y, mut)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        y_eval = block.apply({"params": params, "batch_stats": stats}, x,
                             False)
        return {"y": y, "stats": mut["batch_stats"], "gx": gx, "gp": gp,
                "y_eval": y_eval}

    keys = [(mode, name) for mode in MODES for name in DTYPES]

    def run(params, x):
        return {f"{mode}/{name}": case(
            DenseBlockJax(3, dtype=DTYPES[name][0], concat_mode=mode),
            params, x.astype(DTYPES[name][0])) for mode, name in keys}

    x = jnp.asarray(_x())
    out = jax.jit(run).lower(variables["params"], x).compile(
        compiler_options=COMPILE)(variables["params"], x)
    return {(mode, name): jax.tree.map(lambda t: np.asarray(t, np.float32),
                                       out[f"{mode}/{name}"])
            for mode, name in keys}


def _port_block(variables, mode):
    block = DenseBlock(X_SHAPE[-1], 3, mode)
    block.load_state_dict(from_jax_variables(variables), strict=True)
    return block


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_train_forward_and_stats_match_jax(mode, dtype, variables,
                                           jax_results):
    ref, tol = jax_results[mode, dtype], TOL[dtype]
    block = _port_block(variables, mode).train()
    x = torch.from_numpy(_x()).to(DTYPES[dtype][1]).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = block(x)
    _close(y.float().permute(0, 2, 3, 1).numpy(), ref["y"], tol["forward"],
           "forward")
    want = from_jax_variables({"params": variables["params"],
                               "batch_stats": ref["stats"]})
    for k, v in bn_buffers(block).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=tol["stats"], err_msg=k)
    assert all(int(v) == 1 for k, v in block.state_dict().items()
               if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_jax(mode, dtype, variables, jax_results):
    """Input and parameter gradients of sum(y * sin(arange)): the fused
    backward's recompute keeps BatchNorm's batch-statistic terms exact,
    and the buffer's prefix views keep their values (no version-counter
    error in f32, where the BatchNorm input is the view itself)."""
    ref, tol = jax_results[mode, dtype], TOL[dtype]
    block = _port_block(variables, mode).train()
    x = torch.from_numpy(_x()).to(DTYPES[dtype][1]).permute(0, 3, 1, 2)
    x.requires_grad_()
    y = block(x)
    w = torch.from_numpy(_cotangent(ref["y"].shape)).permute(0, 3, 1, 2)
    (y.float() * w).sum().backward()
    _close(x.grad.float().permute(0, 2, 3, 1).numpy(), ref["gx"],
           tol["grads"], "input")
    want = port_params(ref["gp"])
    grads = {k: p.grad for k, p in block.named_parameters()}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        _close(g.numpy(), want[k].numpy(), tol["grads"], k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_eval_forward_matches_jax(mode, dtype, variables, jax_results):
    block = _port_block(variables, mode).eval()
    x = torch.from_numpy(_x()).to(DTYPES[dtype][1]).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = block(x)
    _close(y.float().permute(0, 2, 3, 1).numpy(),
           jax_results[mode, dtype]["y_eval"], TOL[dtype]["forward"], "eval")


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="concat_mode"):
        DenseBlock(64, 2, "chunked")


@pytest.mark.parametrize("mode", ("chain",) + MODES)
def test_remat_moves_running_stats_once(mode):
    """One forward and backward of a small encoder with remat: the
    running statistics (and num_batches_tracked = 1) equal those without
    remat, although the backward runs each block's forward again; the
    gradients equal too."""
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 3, 32, 32).astype(np.float32))
    results = []
    for remat in (False, True):
        enc = init_random_(DenseNetEncoder((2, 2, 2, 2), remat=remat,
                                           concat_mode=mode),
                           torch.Generator().manual_seed(4)).train()
        taps = enc(x)
        sum(torch.sum(t * t) for t in taps).backward()
        results.append((bn_buffers(enc), {k: p.grad for k, p in
                                          enc.named_parameters()},
                        {k: v for k, v in enc.state_dict().items()
                         if k.endswith("num_batches_tracked")}))
    (stats, grads, counts), (stats_r, grads_r, counts_r) = results
    for k, v in stats.items():
        torch.testing.assert_close(stats_r[k], v, rtol=0, atol=0, msg=k)
    assert all(int(v) == 1 for v in counts_r.values()) and counts_r == counts
    for k, g in grads.items():
        np.testing.assert_allclose(grads_r[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()),
                                   err_msg=k)


# -- (c) the whole SAUNet step ---------------------------------------------

LOSS_PARTS = ("loss", "ce", "dice", "edge")
# tests/test_torch_train_step.py's tolerance on each stored update (its
# comment gives the reason), as a fraction of the largest stored update
UPDATE_TOL = 3e-3
STEP_LAYOUTS = {"chain": ("chain", False), "buffer": ("buffer", False),
                "fused": ("fused", False), "fused_remat": ("fused", True)}


@pytest.fixture(scope="module")
def golden_step():
    model = build_unet(dtype="float32")
    variables = golden_variables_like(model)
    return variables, dict(np.load(GOLDEN_TRAIN_STEP))


@pytest.mark.parametrize("layout", list(STEP_LAYOUTS))
def test_saunet_step_layout_matches_jax(layout, golden_step):
    """The port's train step with every dense block in `layout` against
    one JAX step (train_step_32.npz, the 'chain' JAX step: the layouts
    compute the same math) with the tolerances of
    test_torch_train_step.py."""
    variables, golden = golden_step
    mode, remat = STEP_LAYOUTS[layout]
    model = build_unet(dtype="float32", encoder_concat=mode, remat=remat)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    tx = radam(GOLDEN_LR)
    state = create_train_state(model, tx, "cpu")
    state, metrics = make_train_step(model, tx)(
        state, {k: torch.from_numpy(v) for k, v in golden_batch().items()})
    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(metrics[k]), golden[f"metric/{k}"],
                                   rtol=1e-4, err_msg=k)
    new = to_jax_variables(model)
    old_p, new_p = flat_leaves(variables["params"]), flat_leaves(
        new["params"])
    names = list(golden["names"])
    norms = np.asarray([np.linalg.norm(new_p[k] - old_p[k]) for k in names])
    ref_norms = golden["update_norm"]
    np.testing.assert_allclose(norms, ref_norms, rtol=0,
                               atol=1e-3 * ref_norms.max())
    scale = max(np.abs(golden[f"update/{k}"]).max() for k in GOLDEN_LEAVES)
    for k in GOLDEN_LEAVES:
        np.testing.assert_allclose(new_p[k] - old_p[k],
                                   golden[f"update/{k}"], rtol=0,
                                   atol=UPDATE_TOL * scale, err_msg=k)
    for k, v in flat_leaves(new["batch_stats"]).items():
        np.testing.assert_allclose(v, golden[f"batch_stats/{k}"], rtol=1e-5,
                                   atol=2e-5, err_msg=k)
