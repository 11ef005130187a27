"""The port's training parts against the JAX package on the CPU, each module
alone: BatchNorm in train mode (flax semantics), the dual loss, the metrics,
the optimizers (against optax), checkpoints and the best-IoU policy, and the
loader. Inputs are made with numpy and handed to both sides."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import linen as fnn
from torch import nn

from saunet_tpu.data import loader as loader_jax
from saunet_tpu.train import losses as losses_jax
from saunet_tpu.train import metrics as metrics_jax
from saunet_tpu.train import optim as optim_jax
from saunet_tpu.train.checkpoint import BestIoUPolicy as BestIoUPolicyJax
from saunet_tpu_torch.data import loader
from saunet_tpu_torch.models.norm import BatchNorm2d
from saunet_tpu_torch.train import checkpoint, losses, metrics, optim
from saunet_tpu_torch.train.state import TrainState
from torch_port_util import one_thread  # noqa: F401  (fixture)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("offset", [0.0, 3.0], ids=["centred", "offset"])
def test_batchnorm_train_mode_matches_flax(offset):
    """Output, gradients and the new running statistics of one train-mode
    step on (2, 5, 7, 9) NHWC. The running variance is updated with the
    biased batch variance (torch's own BatchNorm2d uses the unbiased one,
    70/69 times larger here)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 5, 7, 9) * 2 + offset).astype(np.float32)
    dy = rs.randn(2, 5, 7, 9).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(9)).astype(np.float32)
    bias = (0.1 * rs.randn(9)).astype(np.float32)
    mean0 = (0.1 * rs.randn(9)).astype(np.float32)
    var0 = (0.5 + rs.rand(9)).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(params, xx):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd["batch_stats"])

    (_, (y_ref, stats)), (g_params, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    m = BatchNorm2d(9)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    m.train()
    xt = nchw(x).requires_grad_(True)
    y = m(xt)
    (y * nchw(dy)).sum().backward()

    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               y_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"],
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), g_x,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(m.weight.grad.numpy(), g_params["scale"],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(m.bias.grad.numpy(), g_params["bias"],
                               rtol=1e-5, atol=1e-4)


def test_batchnorm_keeps_f32_statistics_for_bf16():
    m = BatchNorm2d(4).train()
    x = torch.randn(2, 4, 3, 3).to(torch.bfloat16)
    y = m(x)
    assert y.dtype == torch.bfloat16
    assert m.running_var.dtype == torch.float32
    m.eval()
    before = m.running_mean.clone()
    m(x)
    assert torch.equal(m.running_mean, before)


def _loss_inputs(seed: int):
    rs = np.random.RandomState(seed)
    n, h, w = 3, 6, 5
    return (rs.randn(n, h, w, 4).astype(np.float32) * 2,
            rs.rand(n, h, w, 1).astype(np.float32),
            rs.randint(0, 4, (n, h, w)).astype(np.int32),
            (rs.rand(n, h, w) < 0.3).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_dual_loss_matches_jax(masked):
    seg, edge, lab, edge_t = _loss_inputs(1)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32) if masked else None
    total_j, parts_j = losses_jax.dual_loss(
        jnp.asarray(seg), jnp.asarray(edge), jnp.asarray(lab),
        jnp.asarray(edge_t),
        sample_mask=None if mask is None else jnp.asarray(mask))
    total, parts = losses.dual_loss(
        torch.from_numpy(seg), torch.from_numpy(edge), torch.from_numpy(lab),
        torch.from_numpy(edge_t),
        sample_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(total), float(total_j), rtol=1e-6)
    for k in ("loss", "ce", "dice", "edge"):
        np.testing.assert_allclose(float(parts[k]), float(parts_j[k]),
                                   rtol=1e-6, err_msg=k)
    if masked:  # the masked loss is the loss of the kept samples alone
        keep = mask > 0
        _, alone = losses.dual_loss(*(torch.from_numpy(a[keep]) for a in
                                      (seg, edge, lab, edge_t)))
        for k in ("ce", "dice", "edge"):
            np.testing.assert_allclose(float(parts[k]), float(alone[k]),
                                       rtol=1e-6, err_msg=k)


def test_metrics_match_jax():
    rs = np.random.RandomState(2)
    preds = rs.randint(0, 4, (3, 8, 9)).astype(np.int32)
    labels = rs.randint(0, 4, (3, 8, 9)).astype(np.int32)
    acc_j, jac_j = metrics_jax.pixel_acc(jnp.asarray(preds),
                                         jnp.asarray(labels), 4)
    acc, jac = metrics.pixel_acc(torch.from_numpy(preds),
                                 torch.from_numpy(labels), 4)
    assert float(acc) == float(acc_j)
    np.testing.assert_array_equal(jac.numpy(), np.asarray(jac_j))
    for a, b in zip(metrics.intersection_and_union(preds, labels, 4),
                    metrics_jax.intersection_and_union(preds, labels, 4)):
        np.testing.assert_array_equal(a, b)
    assert metrics.accuracy(preds, labels) == metrics_jax.accuracy(preds,
                                                                   labels)
    np.testing.assert_array_equal(
        metrics.dice_coefficient(preds, labels, 4),
        metrics_jax.dice_coefficient(preds, labels, 4))


class _Tiny(nn.Module):
    """A conv (kernel decayed) and a BatchNorm (not decayed)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 3, 3)
        self.bn = nn.BatchNorm2d(3)


def _jax_tree(model: _Tiny) -> dict:
    c, b = model.conv, model.bn
    return {"conv": {"kernel": jnp.asarray(c.weight.detach().numpy()),
                     "bias": jnp.asarray(c.bias.detach().numpy())},
            "bn": {"scale": jnp.asarray(b.weight.detach().numpy()),
                   "bias": jnp.asarray(b.bias.detach().numpy())}}


def _set_grads(model: _Tiny, g: dict) -> None:
    for p, k in ((model.conv.weight, ("conv", "kernel")),
                 (model.conv.bias, ("conv", "bias")),
                 (model.bn.weight, ("bn", "scale")),
                 (model.bn.bias, ("bn", "bias"))):
        p.grad = torch.from_numpy(np.asarray(g[k[0]][k[1]]))


SCHED = optim.cosine_epoch_schedule(1e-2, 3, 4)
SCHED_J = optim_jax.cosine_epoch_schedule(1e-2, 3, 4)
OPTIMIZERS = {
    "radam": (lambda m: optim.radam(1e-2), lambda p: optim_jax.radam(1e-2)),
    "radam_decay": (
        lambda m: optim.radam(1e-2, weight_decay=1e-1,
                              weight_decay_mask=optim.decay_mask(m)),
        lambda p: optim_jax.radam(1e-2, weight_decay=1e-1,
                                  weight_decay_mask=optim_jax.decay_mask(p))),
    "plain_radam": (lambda m: optim.plain_radam(3e-3),
                    lambda p: optim_jax.plain_radam(3e-3)),
    "adamw": (lambda m: optim.adamw(1e-2, weight_decay=1e-1,
                                    weight_decay_mask=optim.decay_mask(m)),
              lambda p: optim_jax.adamw(
                  1e-2, weight_decay=1e-1,
                  weight_decay_mask=optim_jax.decay_mask(p))),
    "sgd": (lambda m: optim.create_optimizer("sgd", SCHED, m,
                                             weight_decay=1e-1),
            lambda p: optim_jax.create_optimizer("sgd", SCHED_J, p,
                                                 weight_decay=1e-1)),
    "adam": (lambda m: optim.create_optimizer("adam", SCHED),
             lambda p: optim_jax.create_optimizer("adam", SCHED_J)),
    "radam_schedule": (lambda m: optim.create_optimizer("radam", SCHED),
                       lambda p: optim_jax.create_optimizer("radam",
                                                            SCHED_J)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """12 updates (RAdam's plain branch for steps 1-5, its adaptive branch
    after), parameters within 1e-6 at every step."""
    make, make_jax = OPTIMIZERS[name]
    torch.manual_seed(0)
    model = _Tiny()
    params = _jax_tree(model)
    opt = make(model)(model)
    tx = make_jax(params)
    opt_state = tx.init(params)
    rs = np.random.RandomState(3)
    for t in range(12):
        g = jax.tree.map(
            lambda p: rs.randn(*p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(
            jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, g)
        opt.step()
        ours = _jax_tree(model)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {t + 1} {path}")


def test_radam_branch_threshold():
    # n_sma >= 5 (not > 5) selects the adaptive branch: first at step 6
    steps = [optim.radam_step_size(t, 0.9, 0.999)[1] for t in range(1, 8)]
    assert steps == [False] * 5 + [True] * 2


def test_schedule_and_names_match_jax():
    for s in (0, 3, 4, 11, 12):
        np.testing.assert_allclose(SCHED(s), float(SCHED_J(s)), rtol=1e-6)
    with pytest.raises(ValueError, match="Invalid optimizer"):
        optim.create_optimizer("lamb", 1e-3)


def test_checkpoint_round_trip_and_params_only(tmp_path):
    torch.manual_seed(0)
    model = _Tiny()
    tx = optim.radam(1e-2)
    state = TrainState(model, tx, torch.device("cpu"))
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.randn_like(p)
        state.optimizer.step()
        state.step += 1
    path = checkpoint.save_checkpoint(str(tmp_path), "epoch_1", state,
                                      {"val": {"iou": [np.float32(0.5)]}})
    assert path.endswith("state_epoch_1.pt")
    assert (tmp_path / "history_epoch_1.json").exists()

    fresh = _Tiny()
    st2 = checkpoint.restore_checkpoint(path, TrainState(fresh, tx, "cpu"))
    assert st2.step == 2
    assert st2.optimizer.state_dict()["state"]["count"] == 2
    for a, b in zip(model.state_dict().values(), fresh.state_dict().values()):
        assert torch.equal(a, b)
    # one more identical update on both keeps them identical
    for p, q in zip(model.parameters(), fresh.parameters()):
        p.grad = torch.ones_like(p)
        q.grad = torch.ones_like(q)
    state.optimizer.step()
    st2.optimizer.step()
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)

    # weights only, from the train checkpoint and from a bare state_dict
    bare = str(tmp_path / "bare.pt")
    torch.save(model.state_dict(), bare)
    for src in (path, bare):
        target = checkpoint.restore_params_only(src, _Tiny())
        assert set(target.state_dict()) == set(model.state_dict())


def test_best_iou_policy_matches_jax():
    ours, ref = checkpoint.BestIoUPolicy(warmup=3, period=4), \
        BestIoUPolicyJax(warmup=3, period=4)
    rs = np.random.RandomState(4)
    for epoch in range(1, 10):
        iou = rs.rand(3)
        assert ours.update(epoch, iou, 9) == ref.update(epoch, iou, 9)
    assert ours.best == ref.best and ours.best_epoch == ref.best_epoch


def test_loader_matches_jax_and_places_batches():
    arrays = {"image": np.arange(22 * 3, dtype=np.float32).reshape(22, 3),
              "label": np.arange(22, dtype=np.int32)}
    ours = loader.ArrayDataLoader(
        arrays, 4, sampler=loader.RandomSampler(22, np.random.RandomState(5)),
        place=loader.to_device("cpu"))
    ref = loader_jax.ArrayDataLoader(
        arrays, 4,
        sampler=loader_jax.RandomSampler(22, np.random.RandomState(5)))
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == len(ours) == 5
    for a, b in zip(got, want):
        assert isinstance(a["image"], torch.Tensor)
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
    sharded = loader.DistributedShardSampler(10, num_shards=3, shard_id=1,
                                             seed=7)
    sharded.set_epoch(2)
    ref_sh = loader_jax.DistributedShardSampler(10, num_shards=3, shard_id=1,
                                                seed=7)
    ref_sh.set_epoch(2)
    assert list(sharded) == list(ref_sh)
    batches = list(loader.BatchSampler(loader.SequentialSampler(5), 2,
                                       drop_last=False))
    assert batches == [[0, 1], [2, 3], [4]]


def test_loader_raises_worker_errors():
    def bad(batch):
        raise OSError("disk")

    it = iter(loader.ArrayDataLoader({"x": np.zeros((4, 1))}, 2, place=bad))
    with pytest.raises(OSError, match="disk"):
        next(it)


def test_load_pretrained_encoder_matches_jax_mapping(tmp_path):
    """A torchvision densenet121 state_dict (legacy `norm.1` names for one
    layer, a classifier to ignore) loads into the port's encoder as the
    JAX package's `port_torchvision_state_dict` maps it."""
    from saunet_tpu.models.densenet import port_torchvision_state_dict
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.densenet import load_pretrained_encoder
    from saunet_tpu_torch.models.init import init_random_
    from torch_port_util import flat_leaves, to_jax_variables

    src = init_random_(build_unet(dtype="float32"),
                       torch.Generator().manual_seed(1))
    sd = {}
    for k, v in src.encoder.state_dict().items():
        k = "features." + k
        if k.startswith("features.denseblock1.denselayer1."):
            k = k.replace(".norm1.", ".norm.1.").replace(".conv1.", ".conv.1.")
        sd[k] = v.clone()
    sd["classifier.weight"] = torch.zeros(1000, 1024)
    path = str(tmp_path / "densenet121.pth")
    torch.save(sd, path)

    model = load_pretrained_encoder(path, build_unet(dtype="float32"))
    for k, v in src.encoder.state_dict().items():
        assert torch.equal(model.encoder.state_dict()[k], v), k
    ref = port_torchvision_state_dict(
        {k.replace(".norm.1.", ".norm1.").replace(".conv.1.", ".conv1."):
         v.numpy() for k, v in sd.items()})
    ours = to_jax_variables(model)
    for tree in ("params", "batch_stats"):
        want = flat_leaves(ref[tree])
        got = flat_leaves(ours[tree]["encoder"])
        assert sorted(got) == sorted(want), tree
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    np.savez(str(tmp_path / "densenet121.npz"),
             **{k: v.numpy() for k, v in src.encoder.state_dict().items()
                if not k.endswith("num_batches_tracked")
                for k in ["features." + k]})
    again = load_pretrained_encoder(str(tmp_path / "densenet121.npz"),
                                    build_unet(dtype="float32"))
    for k, v in src.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again.encoder.state_dict()[k], v), k
