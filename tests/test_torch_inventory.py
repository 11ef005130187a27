"""The rest of the model and ops inventory against the JAX package on the
CPU: the ResNet family and its state-dict hook, the SE bottlenecks and the
high-frequency gate, the dormant losses, the small filters, global pooling,
`resize_nearest` and the utils.

JAX variable trees come from `jax.eval_shape` of the flax init, filled
from a numpy seed (`fill_variables`), and cross the bridge with
`from_jax_variables`; JAX applies run for resnet18, resnet50 and the
blocks only (resnet34 and resnet101 are held by their trees and stage
shapes). Tolerances: f32 forwards within 1e-4 of max|ref| (other conv
algorithms and summation orders), elementwise functions within 1e-5."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from saunet_tpu.models import blocks as jblocks
from saunet_tpu.models import resnet as jresnet
from saunet_tpu.ops import filters as jfilters
from saunet_tpu.ops import pooling as jpooling
from saunet_tpu.ops import resize as jresize
from saunet_tpu.train import losses as jlosses
from saunet_tpu.utils import config as jconfig
from saunet_tpu.utils import misc as jmisc
from saunet_tpu_torch.models import (
    HighFrequencyGatedSpatialConv,
    SEBottleneck,
    SEResNetBottleneck,
    port_resnet_state_dict,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
)
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.ops import filters, pooling
from saunet_tpu_torch.ops.resize import resize_nearest
from saunet_tpu_torch.train import losses
from saunet_tpu_torch.utils import config, misc, profiling
from torch_port_util import (  # noqa: F401  (fixtures)
    fill_variables,
    one_thread,
)

B, S = 2, 32


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(ours: torch.Tensor, ref, nchw: bool = True, tol: float = 1e-4):
    ref = np.asarray(ref)
    got = ours.detach().numpy()
    if nchw:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _variables(jax_model, *inputs, seed=0):
    shapes = jax.eval_shape(
        lambda k: jax_model.init(k, *inputs, train=False),
        jax.random.PRNGKey(0))
    return fill_variables({"params": shapes["params"],
                           "batch_stats": shapes["batch_stats"]}, seed)


def _port(model, variables):
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _port_resnet(factory, variables):
    """A port ResNet holding `variables`, built without its default init
    (every weight and statistic comes from `variables`)."""
    with torch.device("meta"):
        model = factory()
    model.load_state_dict(from_jax_variables(variables), strict=True,
                          assign=True)
    return model


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_matches_jax(name):
    """Eval-mode stage taps (train-mode BatchNorm is held on the blocks
    below, and for the whole SAUNet by the golden steps)."""
    x = np.random.RandomState(1).randn(B, S, S, 3).astype(np.float32)
    jax_model = getattr(jresnet, name)()
    variables = _variables(jax_model, jnp.asarray(x))
    model = _port_resnet({"resnet18": resnet18, "resnet50": resnet50}[name],
                         variables).eval()
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        variables, x)
    with torch.no_grad():
        taps = model(_nchw(x))
    assert len(taps) == 5
    for ours, want in zip(taps, ref):
        _close(ours, want)


@pytest.mark.parametrize("name", ["resnet34", "resnet101"])
def test_resnet_trees_and_stage_shapes(name):
    """One-to-one weight map and the stage taps' shapes, without a JAX
    apply: a leaf left over or missing raises."""
    x = jnp.zeros((1, S, S, 3), jnp.float32)
    jax_model = getattr(jresnet, name)()
    shapes, tree = jax.eval_shape(
        lambda k: jax_model.init_with_output(k, x, train=False),
        jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             {"params": tree["params"],
                              "batch_stats": tree["batch_stats"]})
    model = _port_resnet({"resnet34": resnet34, "resnet101": resnet101}[name],
                         variables)
    with torch.no_grad():
        taps = model.eval()(torch.zeros(1, 3, S, S))
    assert [tuple(t.permute(0, 2, 3, 1).shape) for t in taps] == \
        [tuple(s.shape) for s in shapes]
    extra = dict(variables["params"])
    extra["stem_conv4"] = {"kernel": np.zeros((3, 3, 128, 8), np.float32)}
    with pytest.raises(RuntimeError, match="stem_conv4"):
        model.load_state_dict(from_jax_variables(
            {"params": extra, "batch_stats": variables["batch_stats"]}),
            strict=True)


def _torchvision_resnet18(rs) -> dict:
    """MIT-CSAIL deep-stem resnet18 names and shapes, with an fc head."""
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rs.randn(o, i, k, k).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rs.randn(c).astype(np.float32)
        sd[f"{name}.bias"] = rs.randn(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rs.randn(c).astype(np.float32)
        sd[f"{name}.running_var"] = (0.5 + rs.rand(c)).astype(np.float32)

    for i, (o, c) in enumerate([(64, 3), (64, 64), (128, 64)], 1):
        conv(f"conv{i}", o, c, 3)
        bn(f"bn{i}", o)
    cin = 128
    for stage, planes in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            pre, c = f"layer{stage}.{b}", cin if b == 0 else planes
            conv(f"{pre}.conv1", planes, c, 3)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            if b == 0:
                conv(f"{pre}.downsample.0", planes, c, 1)
                bn(f"{pre}.downsample.1", planes)
        cin = planes
    sd["fc.weight"] = rs.randn(10, 512).astype(np.float32)
    sd["fc.bias"] = rs.randn(10).astype(np.float32)
    return sd


def test_port_resnet_state_dict_matches_jax_hook():
    sd = _torchvision_resnet18(np.random.RandomState(2))
    ours = port_resnet_state_dict(sd)
    via_jax = from_jax_variables(jresnet.port_resnet_state_dict(sd))
    for k, v in via_jax.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(ours[k], v), k
    assert set(ours) == {k for k in via_jax
                         if not k.endswith("num_batches_tracked")}
    model = resnet18()
    missing, unexpected = model.load_state_dict(ours, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)


BLOCKS = ("se_bottleneck", "se_resnet_bottleneck", "hf_gate")


def _block(name):
    """(JAX module, port module, inputs) of a block case."""
    rs = np.random.RandomState(3)
    if name == "hf_gate":
        inputs = (rs.randn(B, S, S, 8).astype(np.float32),
                  rs.randn(B, S, S, 1).astype(np.float32))
        return (jblocks.HighFrequencyGatedSpatialConv(8),
                HighFrequencyGatedSpatialConv(8, 8), inputs)
    cls, port_cls = {"se_bottleneck": (jblocks.SEBottleneck, SEBottleneck),
                     "se_resnet_bottleneck": (jblocks.SEResNetBottleneck,
                                              SEResNetBottleneck)}[name]
    return (cls(planes=8, groups=2, reduction=4, stride=2, downsample=True),
            port_cls(16, 8, groups=2, reduction=4, stride=2,
                     downsample=True),
            (rs.randn(B, S, S, 16).astype(np.float32),))


@pytest.fixture(scope="module")
def block_refs():
    """Each block's variables, and its JAX outputs in eval and train mode
    (with the new batch statistics), from one jitted program."""
    jax_models = {n: _block(n)[0] for n in BLOCKS}
    inputs = {n: _block(n)[2] for n in BLOCKS}
    variables = {n: _variables(jax_models[n],
                               *[jnp.asarray(a) for a in inputs[n]])
                 for n in BLOCKS}

    def run(variables, inputs):
        return {(n, train): jax_models[n].apply(
            variables[n], *inputs[n], train=train,
            mutable=["batch_stats"] if train else False)
            for n in BLOCKS for train in (False, True)}

    return variables, jax.jit(run)(variables, inputs)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_match_jax(name, train, block_refs):
    variables, refs = block_refs
    _, model, inputs = _block(name)
    _port(model, variables[name]).train(train)
    ref = refs[(name, train)]
    if train:
        ref, new = ref
    _close(model(*[_nchw(a) for a in inputs]), ref)
    if train:  # the running statistics move as flax's do
        sd = model.state_dict()
        for k, v in from_jax_variables(
                new | {"params": variables[name]["params"]}).items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=k)


def test_losses_match_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(B, S, S, 4).astype(np.float32) * 3
    labels = rs.randint(0, 4, (B, S, S)).astype(np.int32)
    labels[0, :10] = 0  # uneven histograms
    ignored = labels.copy()
    ignored[:, :3] = -1
    edge = rs.rand(B, S, S, 1).astype(np.float32)
    variants = [("image_based", (n, bw)) for n in (False, True)
                for bw in (False, True)]
    variants += [("label_smooth", r) for r in ("mean", "sum", "none")]
    variants += [("edge_attention", t) for t in (0.5, 0.8)]

    def run(lib, lg, lab, ign, e):
        out = []
        for kind, arg in variants:
            if kind == "image_based":
                out.append(lib.image_based_cross_entropy(lg, lab, 1.0, *arg))
            elif kind == "label_smooth":
                out.append(lib.label_smooth_softmax_ce(lg, ign,
                                                       reduction=arg))
            else:
                out.append(lib.edge_attention_loss(lg, lab, e, arg))
        return out

    refs = jax.jit(lambda *a: run(jlosses, *a))(logits, labels, ignored,
                                                edge)
    ours = run(losses, *(torch.from_numpy(a)
                         for a in (logits, labels, ignored, edge)))
    for (kind, arg), got, ref in zip(variants, ours, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{kind} {arg}")


def test_filters_match_jax():
    rs = np.random.RandomState(5)
    x = rs.rand(B, 17, 23, 3).astype(np.float32)
    tx = torch.from_numpy(x)
    for k, groups in ((3, 1), (4, 1), (5, 3)):
        kern = rs.randn(k, k, 3 // groups, 6).astype(np.float32)
        _close(filters.conv2d_same(tx, torch.from_numpy(kern), groups),
               jfilters.conv2d_same(x, kern, groups), nchw=False)
    for ours, ref in zip(filters.gradient_central_diff(tx),
                         jfilters.gradient_central_diff(x)):
        _close(ours, ref, nchw=False, tol=1e-6)
    for r in (0, 1, 4):
        np.testing.assert_array_equal(filters.triangle_kernel(r),
                                      jfilters.triangle_kernel(r))
        _close(filters.conv_tri(tx, r), jfilters.conv_tri(x, r), nchw=False,
               tol=1e-5)
    mag, normal = filters.gradient_magnitude_and_normal(tx)
    rmag, rnormal = jfilters.gradient_magnitude_and_normal(x)
    _close(mag, rmag, nchw=False, tol=1e-5)
    _close(normal, rnormal, nchw=False, tol=1e-4)


def test_pooling_and_resize_nearest_match_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(B, 7, 9, 5).astype(np.float32)
    for kind in ("avg", "max", "avgmax", "catavgmax"):
        for keep in (True, False):
            _close(pooling.adaptive_pool2d(torch.from_numpy(x), kind, keep),
                   jpooling.adaptive_pool2d(x, kind, keep), nchw=False,
                   tol=1e-6)
        assert pooling.pooling_factor(kind) == jpooling.pooling_factor(kind)
    with pytest.raises(ValueError):
        pooling.adaptive_pool2d(torch.from_numpy(x), "median")
    lab = rs.randint(0, 4, (B, 10, 13, 1)).astype(np.int32)
    for arr in (lab, lab[0], lab[0, ..., 0]):
        for hw in ((23, 31), (4, 5), (10, 13)):
            np.testing.assert_array_equal(
                resize_nearest(torch.from_numpy(arr), hw).numpy(),
                np.asarray(jresize.resize_nearest(arr, hw)))


def _as_dict(d):
    return {k: _as_dict(v) if isinstance(v, dict) else v
            for k, v in d.items()}


def test_utils_match_jax(tmp_path):
    ours, ref = config.default_config(), jconfig.default_config()
    assert _as_dict(ours) == _as_dict(ref)
    assert ours.MODEL.BN_EPS == config.BN_EPS
    assert abs(ours.MODEL.BN_MOMENTUM - (1 - config.BN_MOMENTUM)) < 1e-12
    c = config.AttrDict({"A": {"B": 1}})
    assert c.A.B == 1 and isinstance(c.A, config.AttrDict)
    clone = config.assert_and_infer_cfg(ours.clone(), make_immutable=True)
    assert clone.is_immutable() and clone.MODEL.is_immutable()
    with pytest.raises(AttributeError):
        clone.MODEL.NORM_FN = "syncbn"
    with pytest.raises(AttributeError):
        _ = c.missing
    ours.TRAIN.DTYPE = "float16"
    with pytest.raises(AssertionError):
        config.assert_and_infer_cfg(ours, make_immutable=False)

    lab = np.random.RandomState(7).randint(-1, 6, (11, 13))
    np.testing.assert_array_equal(misc.color_encode(torch.from_numpy(lab)),
                                  jmisc.color_encode(lab))
    nested = {"a": [torch.ones(2), (torch.zeros(1), 3.0)]}
    out = misc.as_numpy(nested)
    assert isinstance(out["a"], list) and isinstance(out["a"][1], tuple)
    np.testing.assert_array_equal(out["a"][0], np.ones(2, np.float32))

    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port-region"):
            torch.ones(16).cumsum(0)
    written = list(tmp_path.iterdir())
    assert written and "port-region" in written[0].read_text()
