"""The pieces of the port's data-parallel training, in this process and
without spawning one: with no process group the differentiable all-reduce,
the BatchNorm and the losses and metrics compute exactly what the
one-process code computed before the group argument existed (its formulas
are copied here as the reference); in a one-rank gloo group (a FileStore in
pytest's tmp dir, destroyed after each test) the all-reduce's backward
passes the gradient through with the factor `world` = 1 and the synced
pieces agree with the unsynced ones; the backend rule, the batch layout, the
sampler's defaults, the rank-0 checkpoint and the 'space' envelope. Port
only: no jax."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from saunet_tpu_torch.data.loader import DistributedShardSampler
from saunet_tpu_torch.models.norm import BatchNorm2d, sync_batch_norm
from saunet_tpu_torch.parallel import (
    DataMesh,
    all_reduce_sum,
    fold_in,
    shard_batch,
    shard_rows,
    validate_spatial_partition,
)
from saunet_tpu_torch.parallel.mesh import choose_backend
from saunet_tpu_torch.train import dual_loss, pixel_acc, save_checkpoint
from saunet_tpu_torch.train.losses import DEFAULT_CLASS_WEIGHTS
from saunet_tpu_torch.train.state import TrainState
from torch_port_util import one_thread  # noqa: F401  (fixture)


def _inputs(n=3, h=6, w=5, c=4, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(n, h, w, c).astype(np.float32)),
            torch.from_numpy(rs.rand(n, h, w, 1).astype(np.float32)),
            torch.from_numpy(rs.randint(0, c, (n, h, w)).astype(np.int32)),
            torch.from_numpy((rs.rand(n, h, w, 1) < 0.3).astype(np.float32)))


def _seed_dual_loss(seg, edge, labels, edge_t, mask=None):
    """The dual loss as the port computed it before the group argument."""
    logp = torch.log_softmax(seg.float(), dim=-1)
    lab = labels.long()
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    wts = torch.as_tensor(DEFAULT_CLASS_WEIGHTS)[lab]
    if mask is not None:
        wts = wts * mask.float()[:, None, None]
    ce = torch.sum(wts * nll) / torch.sum(wts)
    probas = torch.softmax(seg.float(), dim=-1)
    one_hot = F.one_hot(lab, seg.shape[-1]).float()
    if mask is not None:
        m = mask.float()[:, None, None, None]
        probas, one_hot = probas * m, one_hot * m
    inter = torch.sum(probas * one_hot, dim=(0, 1, 2))
    card = torch.sum(probas + one_hot, dim=(0, 1, 2))
    dice = 1.0 - torch.mean(2.0 * inter / (card + 1e-7))
    p = torch.clamp(edge.float(), 1e-7, 1.0 - 1e-7)
    ll = edge_t * torch.log(p) + (1.0 - edge_t) * torch.log(1.0 - p)
    if mask is None:
        bce = -torch.mean(ll)
    else:
        m = mask.float().reshape(-1, 1, 1, 1)
        bce = -torch.sum(ll * m) / (torch.sum(mask.float())
                                    * float(ll[0].numel()))
    return dice + ce + bce, ce, dice, bce


def _seed_batch_norm(bn, x):
    """Train-mode BatchNorm as the port computed it before synced BN:
    (output, running mean, running var)."""
    mean = torch.zeros_like(bn.running_mean)
    var_u = torch.ones_like(bn.running_var)
    y = F.batch_norm(x, mean, var_u, bn.weight, bn.bias, True, 1.0, bn.eps)
    n = x.numel() // x.shape[1]
    m = bn.momentum
    rm = (1.0 - m) * bn.running_mean + m * mean
    rv = (1.0 - m) * bn.running_var + m * var_u * ((n - 1) / n)
    return y, rm, rv


def _bn(c=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return bn.train()


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group in this process, destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _mesh(group):
    return DataMesh(world=1, rank=0, local_rank=0, local_world=1,
                    device=torch.device("cpu"), backend="gloo", group=group)


def test_no_group_is_the_one_process_code_bit_for_bit():
    x = torch.randn(4, 3, requires_grad=True)
    assert all_reduce_sum(x, None) is x

    seg, edge, labels, edge_t = _inputs()
    mask = torch.tensor([1.0, 0.0, 1.0])
    for m in (None, mask):
        total, parts = dual_loss(seg, edge, labels, edge_t, sample_mask=m)
        ref = _seed_dual_loss(seg, edge, labels, edge_t, m)
        for got, want in zip((total, parts["ce"], parts["dice"],
                              parts["edge"]), ref):
            assert torch.equal(got, want)

    bn = _bn()
    x = torch.randn(2, 5, 4, 3)
    y_ref, rm, rv = _seed_batch_norm(bn, x)
    with sync_batch_norm(torch.nn.Sequential(bn), None):
        y = bn(x)
    assert torch.equal(y, y_ref)
    assert torch.equal(bn.running_mean, rm)
    assert torch.equal(bn.running_var, rv)

    preds = torch.from_numpy(np.random.RandomState(1).randint(0, 4, (3, 6, 5)))
    acc, jac = pixel_acc(preds, labels, 4)
    valid = labels.long() >= 1
    assert torch.equal(acc, (valid & (preds == labels.long())).sum().float()
                       / (valid.sum().float() + 1e-10))
    assert jac.shape == (3,)


def test_all_reduce_backward_factor(group):
    """Every rank holds the same global loss, so the backward sums the
    gradient over the ranks: `world` times each rank's share, here 1."""
    x = torch.randn(5, requires_grad=True)
    y = all_reduce_sum(x * 3.0, group)
    assert torch.equal(y, x.detach() * 3.0)
    (y * torch.arange(5.0)).sum().backward()
    assert torch.equal(x.grad, 3.0 * torch.arange(5.0) * dist.get_world_size())


def test_synced_pieces_on_one_rank_match_unsynced(group):
    """On one rank the global statistics are the local ones: synced BN
    (E[x^2] - E[x]^2 in f32) matches the two-pass BN to f32 rounding, and
    the group's losses and metrics match the unsynced ones."""
    x = torch.randn(3, 5, 6, 4, requires_grad=True)
    a, b = _bn(), _bn()
    ya = a(x)
    with sync_batch_norm(torch.nn.Sequential(b), group):
        yb = b(x)
    assert b.group is None  # restored on exit
    torch.testing.assert_close(yb, ya, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.running_mean, a.running_mean)
    torch.testing.assert_close(b.running_var, a.running_var)
    (ga,) = torch.autograd.grad((ya * ya).sum(), x)
    (gb,) = torch.autograd.grad((yb * yb).sum(), x)
    torch.testing.assert_close(gb, ga, rtol=1e-4, atol=1e-5)

    seg, edge, labels, edge_t = _inputs()
    mask = torch.tensor([1.0, 1.0, 0.0])
    for m in (None, mask):
        _, parts = dual_loss(seg, edge, labels, edge_t, sample_mask=m)
        _, synced = dual_loss(seg, edge, labels, edge_t, sample_mask=m,
                              group=group)
        for k in parts:
            torch.testing.assert_close(synced[k], parts[k], rtol=1e-6,
                                       atol=0)
    preds = torch.from_numpy(np.random.RandomState(1).randint(0, 4, (3, 6, 5)))
    for got, want in zip(pixel_acc(preds, labels, 4, group=group),
                         pixel_acc(preds, labels, 4)):
        assert torch.equal(got, want)


def test_sampler_and_checkpoint_under_a_group(group, tmp_path):
    s = DistributedShardSampler(10, seed=3)
    assert (s.num_shards, s.shard_id) == (1, 0)
    assert sorted(s) == list(range(10))
    model = torch.nn.Linear(2, 2)
    state = TrainState(model, lambda m: torch.optim.SGD(m.parameters(), 0.1),
                       torch.device("cpu"))
    path = save_checkpoint(str(tmp_path / "c"), "epoch_1", state, {})
    assert os.path.exists(path)  # rank 0 writes


def test_sampler_defaults_without_a_group():
    s = DistributedShardSampler(7)
    assert (s.num_shards, s.shard_id) == (1, 0)
    a = DistributedShardSampler(7, num_shards=2, shard_id=0, seed=1)
    b = DistributedShardSampler(7, num_shards=2, shard_id=1, seed=1)
    assert len(a) == len(b) == 4
    assert set(a) | set(b) == set(range(7))


def test_backend_rule():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert choose_backend(cpu, 2, 0)[0] == "gloo"
    assert choose_backend(card, 1, 1)[0] == "nccl"
    assert choose_backend(card, 2, 2)[0] == "nccl"
    backend, why = choose_backend(card, 2, 1)
    assert backend == "gloo" and "share" in why


def test_batch_layout_and_fold_in():
    """Rank r holds the r-th contiguous block of the global batch, as
    shard_batch lays batches out over 'data'."""
    batch = {"image": np.arange(24, dtype=np.float32).reshape(6, 2, 2),
             "label": torch.arange(6)}
    for rank in range(3):
        mesh = DataMesh(world=3, rank=rank, local_rank=rank, local_world=3,
                        device=torch.device("cpu"), backend="gloo",
                        group=None)
        assert shard_rows(6, mesh) == slice(2 * rank, 2 * rank + 2)
        out = shard_batch(batch, mesh)
        assert torch.equal(out["label"], torch.arange(2 * rank, 2 * rank + 2))
        assert torch.equal(out["image"],
                           torch.from_numpy(batch["image"][2 * rank:
                                                           2 * rank + 2]))
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(7, mesh)
    a, b = (fold_in(torch.Generator().manual_seed(4), i) for i in (0, 1))
    assert not torch.equal(torch.rand(4, generator=a),
                           torch.rand(4, generator=b))


def test_space_axis_is_refused_naming_the_roadmap_item():
    """The 'space' axis is ported: sizes inside the JAX package's envelope
    pass; a one-row shard of the deepest dense block is still refused,
    naming the rows (tests/test_torch_space.py holds the envelope against
    the JAX function)."""
    validate_spatial_partition(224, 1)
    validate_spatial_partition(224, 2)
    validate_spatial_partition(224, 4)
    with pytest.raises(ValueError, match="row"):
        validate_spatial_partition(32, 2)


def test_recorded_kernel_calls_against_plain_versions():
    """The ranks' kernel check on the card (`parity.recording_kernel_calls`
    and `kernel_parity`), here on CPU tensors, where each wrapper runs its
    plain version: calls made through the sites the steps use (K5 through
    the augmentation, K3 through the fused encoder, K1 through the SAUNet
    module's name) are recorded, the sites are restored after, and every
    result agrees with its plain version, also on the first rows."""
    import saunet_tpu_torch.models.saunet as saunet_mod
    from saunet_tpu_torch.data import make_augment_fn
    from saunet_tpu_torch.models.densenet import DenseNetEncoder
    from saunet_tpu_torch.models.fused_encoder import (
        encoder_apply_fused,
        fold_encoder,
    )
    from saunet_tpu_torch.models.init import init_random_
    from saunet_tpu_torch.ops.cuda import canny_edges_cuda
    from saunet_tpu_torch.parallel.parity import (
        kernel_parity,
        recording_kernel_calls,
    )

    g = torch.Generator().manual_seed(0)
    enc = init_random_(DenseNetEncoder((2, 2, 2, 2)), g).eval()
    folded = fold_encoder(enc, torch.bfloat16)
    x = torch.randn(3, 32, 32, 3, generator=g)
    batch = {"image": torch.rand(3, 24, 24, generator=g) * 200,
             "label": torch.randint(0, 4, (3, 24, 24), generator=g,
                                    dtype=torch.int32)}
    with recording_kernel_calls() as seen, torch.no_grad():
        saunet_mod.canny_edges_cuda(batch["image"][..., None], 10.0, 100.0)
        make_augment_fn()(torch.Generator().manual_seed(1), batch)
        encoder_apply_fused(enc, folded, x, torch.bfloat16)
    assert saunet_mod.canny_edges_cuda is canny_edges_cuda
    assert {k: len(v) for k, v in seen.items()} == {
        "canny": 1, "warp": 1, "dense_block": 4}
    for rows in (None, 2):
        got = kernel_parity(seen, rows)
        n = 3 if rows is None else rows
        assert got["canny"] == [{"shape": [n, 24, 24, 1], "flips": 0}]
        (warp,) = got["warp"]
        assert warp["shape"] == [n, 24, 24]
        assert warp["max_abs_err"] == 0 and warp["label_mismatches"] == 0
        assert warp["scale"] > 0
        assert [c["shape"][0] for c in got["dense_block"]] == [n] * 4
        assert all(c["max_abs_err"] == 0 and c["scale"] > 0
                   for c in got["dense_block"])
