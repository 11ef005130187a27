"""The port's data-parallel training against the JAX package and the port's
own one-process steps, on two gloo ranks on the CPU.

One pair of ranks is spawned for the module (`launch.run_ranks`, one intra-op
thread each) and runs every rank-side case of `parallel/parity.py` in turn;
the parent compares:
  (a) the global-batch step on `golden_batch()` split 4 + 4 against the JAX
      step in tests/torch_golden/train_step_32.npz (JAX `make_train_step`,
      global batch 8), with the tolerances of test_torch_train_step.py, with
      and without `fix_bn`, and against the port's one-process step;
  (b) the BatchNorm running statistics and the parameters equal on both
      ranks after the step;
  (c) the per-rank-loss step (`make_shard_map_train_step`) equal to the
      global-batch step on a batch that is the same on both ranks, as
      tests/test_shard_map_step.py holds the JAX pair (a live JAX shard_map
      step of the SAUNet takes minutes to compile, so it is not run here);
  (d) the mesh eval step on a padded batch: IoU counts exact and the masked
      loss equal to the one-process eval's;
  (e) the augmentation: each rank's rows equal the one-process output's;
  and one epoch of `cli.train` on the two ranks, whose checkpoint rank 0
  alone writes and whose weights agree with a one-rank run's.
  (f) `run_mesh_step(2, hw=32)` on that pair returns a finite loss;
  (g) the dense blocks' train layouts on the pair: the global-batch step
      with every block 'fused' and rematerialised against the JAX step as
      in (a); a 'fused', 'buffer' or rematerialised DenseBlock on the
      'data' axis and as a 'space' 2 grid against the one-process block;
  (h) the scaling profiler's inventory of the step's collectives on the
      ('data' 2) grid at 64^2 (profile/scaling.py): the gradients the JAX
      SAUNet's parameter count in f32, the BatchNorm statistics the closed
      form of its `batch_stats` channels, no row exchange.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from saunet_tpu_torch.cli.train import main as train_main
from saunet_tpu_torch.cli.train import parse_args
from saunet_tpu_torch.data import make_augment_fn
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.densenet import DenseBlock
from saunet_tpu_torch.models.init import init_random_
from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.parallel.launch import rank_log, run_ranks
from saunet_tpu_torch.parallel.parity import bn_buffers, build_model
from saunet_tpu_torch.train import (
    create_train_state,
    intersection_and_union,
    make_eval_step,
    make_train_step,
    radam,
)
from test_torch_train_cli import _write_acdc
from saunet_tpu_torch.profile.scaling import by_class, predict
from torch_port_util import (  # noqa: F401  (fixture)
    GOLDEN_LEAVES,
    GOLDEN_LR,
    GOLDEN_TRAIN_STEP,
    flat_leaves,
    golden_batch,
    golden_variables_like,
    one_thread,
    scaling_closed_forms,
    to_jax_variables,
)

LOSS_PARTS = ("loss", "ce", "dice", "edge")
# the tolerances of tests/test_torch_train_step.py (its comment gives the
# reasons): updates within UPDATE_TOL of the largest stored update
UPDATE_TOL = {False: 3e-3, True: 1e-3}
# against the port's one-process step the only differences are the order
# of the sums and the synced BatchNorm's E[x^2] - E[x]^2 in place of
# torch's two-pass variance. With BatchNorm in train mode the one-process
# step differs from itself by 1.8e-3 of the largest update when it is
# recomputed with other summation orders (torch.backends.mkldnn off), so
# its updates are held to the golden's 3e-3; with fix_bn, 10x tighter than
# the golden. Loss parts and statistics are held 10x tighter than the
# golden's in both.
PORT_TOL = {False: 3e-3, True: 1e-4}
CLI_ARGS = ("--num_epoch", "1", "--crop_size", "32", "--dtype", "float32",
            "--device", "cpu", "--id", "dp")


def _uniform(batch, rows=4):
    """A global batch whose two halves are the same `rows` samples."""
    return {k: np.concatenate([v[:rows], v[:rows]]) for k, v in
            batch.items()}


def _padded(batch):
    """3 real samples and a 4th repeating the 3rd, masked out by
    `valid`: rank 0 holds 2 real rows, rank 1 one real and the pad."""
    b = {k: np.concatenate([v[:3], v[2:3]]) for k, v in batch.items()}
    b["valid"] = np.array([1, 1, 1, 0], np.float32)
    return b


# (g): the SAUNet layout the global-batch step runs in (the other layouts'
# steps are held to the JAX step in one process, by
# tests/test_torch_dense_block_train.py), and the DenseBlock(16, 2) layouts,
# (mode, remat, space), on the 'data' axis (2 + 2 samples) and as a
# 'space' 2 grid (4 + 4 of 8 rows)
LAYOUT_STEPS = {"fused_remat": dict(encoder_concat="fused", remat=True)}
DENSE_LAYOUTS = {f"{mode}{'_remat' if remat else ''}_{grid}":
                 (mode, remat, space)
                 for mode, remat in (("fused", False), ("fused", True),
                                     ("buffer", False), ("chain", True))
                 for grid, space in (("data", 1), ("space2", 2))}


def _dense_input():
    return np.random.RandomState(9).randn(4, 16, 8, 8).astype(np.float32)


def _augment_input():
    g = golden_batch()
    return {"image": g["image"][:4, ..., 0] * 50 + 100,
            "label": g["label"][:4]}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The module's files (weights, rank results, checkpoints: about
    1.5 GB), removed when the module ends."""
    path = tmp_path_factory.mktemp("parallel")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def weights(work):
    """The golden step's starting weights as a port state_dict file."""
    model = build_unet(dtype="float32")
    variables = golden_variables_like(model)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    path = str(work / "weights.pt")
    torch.save(model.state_dict(), path)
    return path, variables


@pytest.fixture(scope="module")
def acdc(work):
    root = str(work / "data")
    _write_acdc(root)
    return root


def _cli_argv(root, init, ckpt, batch_per_device):
    return ["--data-root", root, "--ckpt", ckpt, "--weights_unet", init,
            "--batch_size_per_device", str(batch_per_device), *CLI_ARGS]


@pytest.fixture(scope="module")
def ranks(work, weights, acdc):
    """Every rank-side case, run in order on one pair of gloo ranks."""
    path = weights[0]
    g = golden_batch()
    cases = {
        "train_bn": ("train_case", dict(weights=path, batch=g,
                                        lr=GOLDEN_LR)),
        "fix_bn": ("train_case", dict(weights=path, batch=g, lr=GOLDEN_LR,
                                      fix_bn=True)),
        "uniform": ("train_case", dict(weights=path, batch=_uniform(g),
                                       lr=GOLDEN_LR)),
        "shard_map": ("train_case", dict(weights=path, batch=_uniform(g),
                                         lr=GOLDEN_LR, shard_map=True)),
        "eval": ("eval_case", dict(weights=path, batch=_padded(g))),
        "augment": ("augment_case", dict(batch=_augment_input(), seed=5)),
        "cli": ("cli_case", dict(argv=_cli_argv(
            acdc, path, str(work / "ckpt2"), 4))),
        "dryrun": ("dryrun_case", dict(hw=32)),
        "scaling": ("saunet_tpu_torch.profile.scaling:collectives_case",
                    dict(hw=64)),
        **{f"train_{name}": ("train_case", dict(
            weights=path, batch=g, lr=GOLDEN_LR, model_kwargs=kwargs))
           for name, kwargs in LAYOUT_STEPS.items()},
        **{f"dense_{name}": ("dense_block_case", dict(
            x=_dense_input(), layers=2, seed=3, space=space,
            concat_mode=mode, remat=remat))
           for name, (mode, remat, space) in DENSE_LAYOUTS.items()},
    }
    logs = str(work / "ranks")
    os.makedirs(logs)
    results = run_ranks(2, "saunet_tpu_torch.parallel.parity:run_cases",
                        {"cases": cases}, device="cpu", threads=1,
                        timeout=600, workdir=logs)
    for name in os.listdir(logs):
        if name.endswith(".pt"):
            os.remove(os.path.join(logs, name))
    return results, [rank_log(logs, r) for r in range(2)]


def _one_process_step(path, batch, fix_bn=False):
    model = build_model(path)
    tx = radam(GOLDEN_LR)
    state = create_train_state(model, tx, "cpu")
    _, metrics = make_train_step(model, tx, fix_bn=fix_bn)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return model, metrics


def _port_model(params, buffers):
    model = build_unet(dtype="float32")
    model.load_state_dict({**params, **buffers}, strict=False)
    return model


def _max_update_gap(new, ref, old):
    """max |new - ref| over every parameter, as a fraction of the largest
    update |ref - old|."""
    with torch.no_grad():
        scale = max(float((ref[k] - old[k]).abs().max()) for k in ref)
        return max(float((new[k] - ref[k]).abs().max())
                   for k in ref) / scale


@pytest.mark.parametrize("fix_bn", [False, True], ids=["train_bn", "fix_bn"])
def test_global_step_matches_jax_and_one_process(fix_bn, ranks, weights):
    _check_global_step(ranks[0][0]["fix_bn" if fix_bn else "train_bn"],
                       weights, fix_bn)


@pytest.mark.parametrize("layout", list(LAYOUT_STEPS))
def test_layout_global_step_matches_jax_and_one_process(layout, ranks,
                                                        weights):
    """(g): the global-batch step with every dense block in `layout`
    (synced BatchNorm inside the fused block's forward and its backward's
    recompute, and inside the rematerialised blocks' recompute) against
    the JAX step, as (a); both ranks end with the same weights."""
    _check_global_step(ranks[0][0][f"train_{layout}"], weights, False,
                       one_process=False)
    r0, r1 = (r[f"train_{layout}"] for r in ranks[0])
    assert torch.equal(r0["digest"], r1["digest"])


def _check_global_step(r0, weights, fix_bn, one_process=True):
    path, variables = weights
    golden = dict(np.load(GOLDEN_TRAIN_STEP))
    prefix = "fix_bn/" if fix_bn else ""

    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(r0["metrics"][k]),
                                   golden[f"{prefix}metric/{k}"], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(r0["metrics"]["acc"]),
                               golden[f"{prefix}metric/acc"], atol=1e-3)
    np.testing.assert_allclose(r0["metrics"]["jaccard"].numpy(),
                               golden[f"{prefix}metric/jaccard"], atol=1e-3)

    new = to_jax_variables(_port_model(r0["params"], r0["buffers"]))
    old_p, new_p = flat_leaves(variables["params"]), flat_leaves(
        new["params"])
    names = list(golden[f"{prefix}names"])
    norms = np.asarray([np.linalg.norm(new_p[k] - old_p[k]) for k in names])
    ref_norms = golden[f"{prefix}update_norm"]
    np.testing.assert_allclose(norms, ref_norms, rtol=0,
                               atol=1e-3 * ref_norms.max())
    scale = max(np.abs(golden[f"{prefix}update/{k}"]).max()
                for k in GOLDEN_LEAVES)
    for k in GOLDEN_LEAVES:
        np.testing.assert_allclose(new_p[k] - old_p[k],
                                   golden[f"{prefix}update/{k}"], rtol=0,
                                   atol=UPDATE_TOL[fix_bn] * scale, err_msg=k)
    stats = flat_leaves(new["batch_stats"])
    for k, v in stats.items():
        if fix_bn:
            np.testing.assert_array_equal(
                v, flat_leaves(variables["batch_stats"])[k], err_msg=k)
        else:
            np.testing.assert_allclose(v, golden[f"batch_stats/{k}"],
                                       rtol=1e-5, atol=2e-5, err_msg=k)

    if not one_process:
        return
    # the port's one-process step on the same global batch
    model, metrics = _one_process_step(path, golden_batch(), fix_bn)
    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(r0["metrics"][k]),
                                   float(metrics[k]), rtol=1e-5, err_msg=k)
    one = dict(model.named_parameters())
    old = dict(build_model(path).named_parameters())
    gap = _max_update_gap(r0["params"], one, old)
    assert gap <= PORT_TOL[fix_bn], gap
    for k, v in model.state_dict().items():
        if k in r0["buffers"]:
            np.testing.assert_allclose(r0["buffers"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["train_bn", "fix_bn", "uniform",
                                  "shard_map"])
def test_ranks_hold_equal_state(case, ranks):
    """(b): synced BatchNorm leaves the same running statistics on both
    ranks (DDP does not broadcast them), and the parameters agree."""
    r0, r1 = (r[case] for r in ranks[0])
    assert r0["buffers"].keys() == r1["buffers"].keys()
    for k, v in r0["buffers"].items():
        assert torch.equal(v, r1["buffers"][k]), k
    assert torch.equal(r0["digest"], r1["digest"])
    for k in LOSS_PARTS:
        assert float(r0["metrics"][k]) == float(r1["metrics"][k]), k


def test_shard_map_step_equals_global_step_on_uniform_shards(ranks,
                                                             weights):
    """(c): on a batch that is the same on both ranks the mean of per-rank
    losses is the global loss, and so are its gradients."""
    g = ranks[0][0]["uniform"]
    s = ranks[0][0]["shard_map"]
    for k in LOSS_PARTS + ("acc",):
        np.testing.assert_allclose(float(s["metrics"][k]),
                                   float(g["metrics"][k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(s["metrics"]["jaccard"].numpy(),
                               g["metrics"]["jaccard"].numpy(), atol=1e-6)
    old = dict(build_model(weights[0]).named_parameters())
    gap = _max_update_gap(s["params"], g["params"], old)
    assert gap <= 1e-4, gap
    for k, v in g["buffers"].items():
        np.testing.assert_allclose(s["buffers"][k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_mesh_eval_matches_one_process(ranks, weights):
    """(d): each rank's preds are its rows of the one-process preds, the
    IoU counts over the real rows sum to the one-process counts, and the
    masked loss is the one-process loss of the three real samples."""
    path, _ = weights
    batch = _padded(golden_batch())
    model = build_model(path)
    state = create_train_state(model, radam(0.0), "cpu")
    _, preds, metrics = make_eval_step(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    preds = preds.numpy()
    inter = union = 0
    for j in range(3):
        i_, u_ = intersection_and_union(preds[j], batch["label"][j], 4)
        inter, union = inter + i_, union + u_
    r = [res["eval"] for res in ranks[0]]
    np.testing.assert_array_equal(np.concatenate([x["preds"] for x in r]),
                                  preds)
    np.testing.assert_array_equal(r[0]["inter"] + r[1]["inter"], inter)
    np.testing.assert_array_equal(r[0]["union"] + r[1]["union"], union)
    for k in LOSS_PARTS + ("acc",):
        np.testing.assert_allclose(float(r[0]["metrics"][k]),
                                   float(metrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(r[0]["metrics"]["jaccard"].numpy(),
                               metrics["jaccard"].numpy(), rtol=1e-6)


def test_augmentation_rows_equal_one_process(ranks):
    """(e): the ranks draw the global batch's augmentation and warp their
    own rows: together they are the one-process output, exactly."""
    batch = _augment_input()
    gen = torch.Generator().manual_seed(5)
    ref = make_augment_fn()(gen, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    for res in ranks[0]:
        out = res["augment"]
        start, n = out["rows"]
        assert n == 2
        for k in ("image", "label", "edge"):
            assert torch.equal(out[k], ref[k][start:start + n]), k


def test_cli_train_two_ranks_matches_one_rank(ranks, acdc, weights, work,
                                              capsys):
    """One epoch of `cli.train` on two ranks (global batch 2 x 4, one
    step) against a one-device run at batch 8, both warm-started from the
    golden weights: rank 0 alone saves, prints the IoU once, and its
    checkpoint's weights agree with the one-device run's within test (a)'s
    tolerance."""
    path, _ = weights
    results, logs = ranks
    (run,) = os.listdir(work / "ckpt2")
    assert "-ndev2-batchSize8-" in run
    run2 = str(work / "ckpt2" / run)
    assert results[1]["cli"]["saved"] == []
    assert results[0]["cli"]["saved"] == [
        os.path.join(run2, "state_epoch_1.pt")]
    assert sorted(os.listdir(run2)) == ["best.json", "history_epoch_1.json",
                                        "state_epoch_1.pt"]
    assert logs[0].count("class [3], IoU:") == 1
    assert "class [" not in logs[1] and "Training Done!" not in logs[1]
    assert "backend gloo" in logs[0]

    argv1 = _cli_argv(acdc, path, str(work / "ckpt1"), 8)
    train_main(argv1)
    capsys.readouterr()
    run1 = parse_args(argv1).ckpt
    two = torch.load(os.path.join(run2, "state_epoch_1.pt"),
                     weights_only=True)
    one = torch.load(os.path.join(run1, "state_epoch_1.pt"),
                     weights_only=True)
    assert two["step"] == one["step"] == 1
    w0 = torch.load(path, weights_only=True)
    params = {k for k, _ in build_unet(dtype="float32").named_parameters()}
    gap = _max_update_gap({k: two["model"][k] for k in params},
                          {k: one["model"][k] for k in params}, w0)
    assert gap <= UPDATE_TOL[False], gap
    for k, v in one["model"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(two["model"][k], v, rtol=1e-5,
                                       atol=2e-5, err_msg=k)
    best1 = json.load(open(os.path.join(run1, "best.json")))
    best2 = json.load(open(os.path.join(run2, "best.json")))
    assert best1.keys() == best2.keys()


def test_run_mesh_step_two_ranks(ranks):
    """(f): `run_mesh_step(2, hw=32)`, called on both ranks of the pair,
    runs one global-batch step on that group: a finite loss, the same on
    both ranks."""
    losses = [res["dryrun"] for res in ranks[0]]
    assert np.isfinite(losses[0]) and losses[0] == losses[1], losses


@pytest.mark.parametrize("case", list(DENSE_LAYOUTS))
def test_dense_layout_on_two_ranks_matches_one_process(case, ranks):
    """(g): the block's outputs (assembled from the ranks' samples or
    rows), the loss, the parameter gradients averaged over the ranks and
    the running statistics, against the one-process block on the whole
    input: the fused block's statistics over the group, its 3x3 halo rows
    fetched in the forward and again in the backward's recompute, and the
    rematerialised block's recompute under the forward's group."""
    mode, remat, space = DENSE_LAYOUTS[case]
    x = torch.from_numpy(_dense_input())
    block = init_random_(DenseBlock(16, 2, mode),
                         torch.Generator().manual_seed(3)).train()
    y = block(x)
    loss = torch.sum(y * y) / y.numel()
    loss.backward()
    y = y.detach()
    res = [r[f"dense_{case}"] for r in ranks[0]]
    out = torch.cat([r["out"] for r in res], 2 if space > 1 else 0)
    np.testing.assert_allclose(out.numpy(), y.numpy(), rtol=0,
                               atol=1e-5 * float(y.abs().max()))
    np.testing.assert_allclose(res[0]["loss"], float(loss.detach()),
                               rtol=1e-5)
    for k, p in block.named_parameters():
        a = p.grad.numpy()
        for r in res:
            np.testing.assert_allclose(r["grads"][k].numpy(), a, rtol=0,
                                       atol=1e-5 * max(np.abs(a).max(), 1.0),
                                       err_msg=k)
    for k, v in bn_buffers(block).items():
        for r in res:
            np.testing.assert_allclose(r["buffers"][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_scaling_inventory_on_the_data_axis(ranks):
    """(h): one recorded step on the pair: every all-reduce classified; the
    gradient buckets carry the JAX SAUNet's parameters in the port's f32,
    the synced BatchNorm its statistics forward and backward, the loss and
    metrics their sums; no 'space' collective; the ranks' inventories
    equal; data=4's prediction scales nothing but the ring."""
    invs = [res["scaling"] for res in ranks[0]]
    assert invs[0]["collectives"] == invs[1]["collectives"]
    assert invs[0]["grid"] == {"data": 2, "space": 1}
    assert invs[0]["samples_per_rank"] == 1
    classes = by_class(invs[0]["collectives"])
    param_bytes = next(build_unet().parameters()).element_size()
    want = scaling_closed_forms(param_bytes)
    assert classes["gradients"]["bytes"] == want["gradients"]
    assert classes["bn_stats"]["bytes"] == want["bn_stats"]
    assert classes["loss_metrics"]["count"] > 0
    assert classes["row_exchanges"]["count"] == 0
    assert classes["space_sums"]["count"] == 0
    assert invs[0]["exchange_rows"] == {"calls": 0, "bytes": 0}
    assert {r["group"] for r in invs[0]["collectives"]} == {2}
    pred = predict({"data2": invs[0], "data2_space2": invs[0]}, 100.0)
    for target in pred["data=4"].values():
        moved = sum(c["bytes"] for c in target["classes"].values())
        assert target["comm_ms"] == pytest.approx(1.5 * moved / 1e11 * 1e3)
