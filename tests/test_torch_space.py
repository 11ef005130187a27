"""The port's 'space' axis (the image H axis split over ranks, with explicit
row exchanges) against the unsharded ops, the port's one-process steps
and the JAX package's partitioned step, on four gloo ranks on the CPU, in
f32.

One group of four ranks is spawned for the module (`launch.run_ranks`, one
intra-op thread each) and runs every rank-side case of `parallel/parity.py`
in turn; the parent compares:
  (a) each op of `parity.SPACE_OPS` (two chained 3x3 convs, conv0, the
      transposed conv, the max and average pools, the align-corners
      resize at x2/x4/x16, the squeeze-and-excite block) and Canny with
      its real thresholds, on images with high-contrast stripes on the
      shard borders: 64 rows over the 'space' pair of a 2 x 2 grid, and a
      14-row level (uneven and odd splits) over the pair and over a 1 x 4
      grid; forward and input gradient within 1e-5 max|ref|, Canny exact;
  (b) a train-mode dense block on the 2 x 2 grid and on 1 x 4 with uneven
      rows: output, parameter gradients and batch statistics;
  (c) one full SAUNet train step at 64^2, global batch 8, on the 2 x 2
      grid, against the port's one-process step and against the JAX
      package's step in tests/torch_golden/train_step_64_space.npz;
  (d) the 96^2 eval on the 2 x 2 grid, each 'space' pair a 1 x 2 grid on
      its sample (H/32 holds 3 rows over 2 ranks): preds and IoU counts
      exactly the one-process eval's;
  (e) the 2 x 2 dry run: a finite loss, equal on every rank;
  (f) the scaling profiler's inventory of the step's collectives on the 2
      x 2 grid at 64^2 (profile/scaling.py): gradients and BatchNorm
      statistics as the JAX SAUNet's closed forms, the row exchanges as
      `exchange_rows` counts them, and their prediction at 512^2.
Without ranks: the envelope against the JAX `validate_spatial_partition`,
the row split, the batch layout, the dry run's grid, `cli.train`'s global
batch under `--space`, and the per-rank-loss step's refusal of a 'space'
axis.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from saunet_tpu_torch.models.jax_weights import from_jax_variables
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.blocks import partition_space
from saunet_tpu_torch.models.densenet import DenseBlock
from saunet_tpu_torch.models.init import init_random_
from saunet_tpu_torch.ops.edge import canny_edges, image_to_gray255
from saunet_tpu_torch.parallel import (
    DataMesh,
    rows,
    shard_batch,
    validate_spatial_partition,
)
from saunet_tpu_torch.parallel.dryrun import grid
from saunet_tpu_torch.parallel.launch import rank_log, run_ranks
from saunet_tpu_torch.parallel.mesh import SpaceShard
from saunet_tpu_torch.parallel.parity import (
    SPACE_OPS,
    bn_buffers,
    build_model,
    iou_counts,
    space_op,
)
from saunet_tpu_torch.profile.scaling import TARGETS, by_class, predict
from saunet_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    radam,
)
from torch_port_util import (  # noqa: F401  (fixture)
    GOLDEN_LEAVES,
    GOLDEN_LR,
    GOLDEN_SPACE_TRAIN_STEP,
    flat_leaves,
    golden_variables_like,
    one_thread,
    scaling_closed_forms,
    space_batch,
    to_jax_variables,
)

WORLD = 4
LOSS_PARTS = ("loss", "ce", "dice", "edge")
# name -> (space, rows) of the op oracles: (space, H) over the 4 ranks
OP_GRIDS = {"pair64": (2, 64), "pair14": (2, 14), "quad14": (4, 14)}
OP_SAMPLES, OP_WIDTH, CANNY_WIDTH = 4, 12, 20
# the op oracles' tolerance: max|sharded - unsharded| <= OP_RTOL max|ref|
OP_RTOL = 1e-5
EVAL_SIZE = 96


def _borders(h, space):
    return [rows(h, s, space)[0] for s in range(1, space)]


def _stripes(shape, borders, seed, dim):
    """Random values with high-contrast rows on both sides of each shard
    border along `dim` (the counterpart of test_spatial_partition.py's
    `_stripe_image`): an op that reads a wrong or zero halo row there
    moves its result by far more than rounding."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    for b in borders:
        np.moveaxis(x, dim, 0)[b - 1] = 2.0
        np.moveaxis(x, dim, 0)[b] = -2.0
    return x


def _op_inputs(space, h, seed):
    inputs, cotangents = {}, {}
    for i, (name, c) in enumerate(sorted(SPACE_OPS.items())):
        x = _stripes((OP_SAMPLES, c, h, OP_WIDTH), _borders(h, space),
                     seed + i, 2)
        y = space_op(name)(torch.from_numpy(x), None)
        inputs[name] = x
        cotangents[name] = np.random.RandomState(seed + 100 + i).randn(
            *y.shape).astype(np.float32)
    image = _stripes((OP_SAMPLES, h, CANNY_WIDTH, 3), _borders(h, space),
                     seed + 50, 1)
    return inputs, cotangents, image


def _eval_batch():
    rs = np.random.RandomState(7)
    n, s = 2, EVAL_SIZE
    labels = rs.randint(0, 4, size=(n, s, s)).astype(np.int32)
    return {"image": _stripes((n, s, s, 3), [s // 2], 8, 1),
            "label": labels,
            "edge": (rs.rand(n, s, s, 1) < 0.2).astype(np.float32),
            "valid": np.ones(n, np.float32)}


# name -> (space, rows) of the dense-block oracles: an even split on the
# 2 x 2 grid, and 14 rows over 1 x 4 (3, 4, 3, 4: uneven BatchNorm counts)
DENSE_GRIDS = {"pair8": (2, 8), "quad14": (4, 14)}


def _dense_input(h):
    """Random features, as test_dense_block_space4_train_oracle takes: rows
    constant over every channel (the op oracles' stripes) put a ReLU input
    of the 1 x 4 block within 6e-8 of 0, where the grid's other summation
    order of the BatchNorm statistics flips its gradient (with GELU in
    place of ReLU the gradients agree within 5e-9)."""
    return np.random.RandomState(9).randn(4, 16, h, 8).astype(np.float32)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("space")
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
def op_inputs():
    return {name: _op_inputs(space, h, seed=10 * i)
            for i, (name, (space, h)) in enumerate(OP_GRIDS.items())}


@pytest.fixture(scope="module")
def ranks(work, weights, op_inputs):
    """Every rank-side case, run in order on one group of four gloo
    ranks."""
    path = weights[0]
    cases = {f"ops_{name}": ("space_ops_case", dict(
        inputs=op_inputs[name][0], cotangents=op_inputs[name][1],
        image=op_inputs[name][2], space=space))
        for name, (space, _) in OP_GRIDS.items()}
    cases.update({
        **{f"dense_{name}": ("dense_block_case", dict(
            x=_dense_input(h), layers=2, seed=3, space=space))
           for name, (space, h) in DENSE_GRIDS.items()},
        "train": ("train_case", dict(weights=path, batch=space_batch(),
                                     lr=GOLDEN_LR, space=2)),
        "eval": ("eval_case", dict(weights=path, batch=_eval_batch(),
                                   space=2)),
        "dryrun": ("dryrun_case", dict(hw=64)),
        "scaling": ("saunet_tpu_torch.profile.scaling:collectives_case",
                    dict(hw=64, space=2)),
    })
    logs = str(work / "ranks")
    os.makedirs(logs)
    results = run_ranks(WORLD, "saunet_tpu_torch.parallel.parity:run_cases",
                        {"cases": cases}, device="cpu", threads=1,
                        timeout=600, workdir=logs)
    return results, [rank_log(logs, r) for r in range(WORLD)]


def _assemble(parts, space, dim):
    """Rank results laid out as the grid holds them (data x space, space
    the fast axis): rows joined along `dim`, samples along 0."""
    blocks = [torch.cat(parts[d * space:(d + 1) * space], dim)
              for d in range(len(parts) // space)]
    return torch.cat(blocks, 0)


@pytest.mark.parametrize("op", sorted(SPACE_OPS))
@pytest.mark.parametrize("grid_name", list(OP_GRIDS))
def test_space_op_matches_unsharded(grid_name, op, ranks, op_inputs):
    """(a): forward and input gradient of the rows the ranks hold."""
    space, _ = OP_GRIDS[grid_name]
    inputs, cotangents, _ = op_inputs[grid_name]
    res = [r[f"ops_{grid_name}"][op] for r in ranks[0]]
    x = torch.from_numpy(inputs[op]).requires_grad_()
    ref = space_op(op)(x, None)
    (ref * torch.from_numpy(cotangents[op])).sum().backward()
    out = _assemble([y for y, _ in res], space, 2)
    grad = _assemble([g for _, g in res], space, 2)
    assert out.shape == ref.shape
    ref = ref.detach()
    assert float((out - ref).abs().max()) <= OP_RTOL * float(
        ref.abs().max())
    assert float((grad - x.grad).abs().max()) <= OP_RTOL * float(
        x.grad.abs().max())


@pytest.mark.parametrize("grid_name", list(OP_GRIDS))
def test_space_canny_is_exact(grid_name, ranks, op_inputs):
    """(a): the ranks' gray (min and max over every rank's rows) and
    banded Canny give exactly the one-process edges, at the real
    thresholds."""
    space, _ = OP_GRIDS[grid_name]
    image = torch.from_numpy(op_inputs[grid_name][2])
    ref = canny_edges(image_to_gray255(image), 10.0, 100.0)
    out = _assemble([r[f"ops_{grid_name}"]["canny"] for r in ranks[0]],
                    space, 1)
    assert float(ref.mean()) > 10  # edges on every image
    assert int((out != ref).sum()) == 0
    # every border of the grid needed rows from a neighbour
    assert all(r[f"ops_{grid_name}"]["exchanges"] > 0 for r in ranks[0])


@pytest.mark.parametrize("grid_name", list(DENSE_GRIDS))
def test_dense_block_space_train_oracle(grid_name, ranks):
    """(b): a dense block (concat fan-out, 3x3 halo, BatchNorm over the
    grid, whose (sum x, sum x^2, n) all-reduce takes uneven shards) on the
    2 x 2 grid and on 1 x 4 with uneven rows: outputs, parameter gradients
    and batch statistics of the one-process block."""
    space, h = DENSE_GRIDS[grid_name]
    x = torch.from_numpy(_dense_input(h))
    block = init_random_(DenseBlock(16, 2),
                         torch.Generator().manual_seed(3)).train()
    y = block(x)
    loss = torch.sum(y * y) / y.numel()
    loss.backward()
    y = y.detach()
    res = [r[f"dense_{grid_name}"] for r in ranks[0]]
    out = _assemble([r["out"] for r in res], space, 2)
    np.testing.assert_allclose(out.numpy(), y.numpy(), rtol=0,
                               atol=1e-5 * float(y.abs().max()))
    np.testing.assert_allclose(res[0]["loss"], float(loss.detach()), rtol=1e-5)
    for k, p in block.named_parameters():
        a = p.grad.numpy()
        np.testing.assert_allclose(res[0]["grads"][k].numpy(), a, rtol=0,
                                   atol=1e-5 * max(np.abs(a).max(), 1.0),
                                   err_msg=k)
    for k, v in bn_buffers(block).items():
        np.testing.assert_allclose(res[0]["buffers"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def _max_update_gap(new, ref, old):
    with torch.no_grad():
        scale = max(float((ref[k] - old[k]).abs().max()) for k in ref)
        return max(float((new[k] - ref[k]).abs().max())
                   for k in ref) / scale


def _port_model(params, buffers):
    model = build_unet(dtype="float32")
    model.load_state_dict({**params, **buffers}, strict=False)
    return model


def test_space_train_step_matches_one_process(ranks, weights):
    """(c): the 2 x 2 step against the port's one-process step on the same
    global batch. Tolerances of test_torch_parallel.py's data-parallel
    step (PORT_TOL there: the order of the sums and the synced
    BatchNorm's E[x^2] - E[x]^2 are the only differences); the ranks hold
    equal statistics and parameters."""
    path, _ = weights
    r = [res["train"] for res in ranks[0]]
    model = build_model(path)
    tx = radam(GOLDEN_LR)
    state = create_train_state(model, tx, "cpu")
    _, metrics = make_train_step(model, tx)(
        state, {k: torch.from_numpy(v) for k, v in space_batch().items()})
    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(r[0]["metrics"][k]),
                                   float(metrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(r[0]["metrics"]["acc"]),
                               float(metrics["acc"]), atol=1e-6)
    old = dict(build_model(path).named_parameters())
    gap = _max_update_gap(r[0]["params"], dict(model.named_parameters()),
                          old)
    assert gap <= 3e-3, gap
    for k, v in model.state_dict().items():
        if k in r[0]["buffers"]:
            np.testing.assert_allclose(r[0]["buffers"][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for x in r[1:]:
        assert all(torch.equal(v, x["buffers"][k])
                   for k, v in r[0]["buffers"].items())
        assert torch.equal(x["digest"], r[0]["digest"])
        assert all(float(x["metrics"][k]) == float(r[0]["metrics"][k])
                   for k in LOSS_PARTS)


def test_space_train_step_matches_jax_golden(ranks, weights):
    """(c): the 2 x 2 step against the JAX package's step on a ('data' 2,
    'space' 2) mesh, with test_torch_train_step.py's tolerances: loss
    parts rtol 1e-4, acc and jaccard atol 1e-3, batch statistics rtol
    1e-5 atol 2e-5, updates within 3e-3 of the largest stored update.

    The updates are held against the golden's unsharded step: at 64^2
    XLA's partitioner returns the gradient of the center block (one row a
    shard at H/32) twice over, and the encoder's below it 1.8-2.8
    times (test_jax_space_golden_doubles_center_gradient), while the
    forward is right."""
    _, variables = weights
    r0 = ranks[0][0]["train"]
    golden = dict(np.load(GOLDEN_SPACE_TRAIN_STEP))
    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(r0["metrics"][k]),
                                   golden[f"metric/{k}"], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(r0["metrics"]["acc"]),
                               golden["metric/acc"], atol=1e-3)
    np.testing.assert_allclose(r0["metrics"]["jaccard"].numpy(),
                               golden["metric/jaccard"], atol=1e-3)
    new = to_jax_variables(_port_model(r0["params"], r0["buffers"]))
    for k, v in flat_leaves(new["batch_stats"]).items():
        np.testing.assert_allclose(v, golden[f"batch_stats/{k}"],
                                   rtol=1e-5, atol=2e-5, err_msg=k)
    old_p = flat_leaves(variables["params"])
    new_p = flat_leaves(new["params"])
    names = list(golden["names"])
    norms = np.asarray([np.linalg.norm(new_p[k] - old_p[k]) for k in names])
    ref_norms = golden["unsharded/update_norm"]
    np.testing.assert_allclose(norms, ref_norms, rtol=0,
                               atol=1e-3 * ref_norms.max())
    scale = max(np.abs(golden[f"unsharded/update/{k}"]).max()
                for k in GOLDEN_LEAVES)
    for k in GOLDEN_LEAVES:
        np.testing.assert_allclose(new_p[k] - old_p[k],
                                   golden[f"unsharded/update/{k}"], rtol=0,
                                   atol=3e-3 * scale, err_msg=k)


def test_jax_space_golden_doubles_center_gradient():
    """The JAX package's 'space' partitioning at 64^2, space 2 (inside its
    envelope, which bounds only the deepest dense block): the partitioned
    step's loss and batch statistics are the unsharded step's, but the
    center block's update is twice the unsharded one, and the encoder's
    1.8-2.8 times; the decoder above the center is unchanged. The port's
    step follows the unsharded one (the test above)."""
    golden = dict(np.load(GOLDEN_SPACE_TRAIN_STEP))
    for k in LOSS_PARTS:
        np.testing.assert_allclose(golden[f"metric/{k}"],
                                   golden[f"unsharded/metric/{k}"],
                                   rtol=1e-5, err_msg=k)
    names = list(golden["names"])
    ratio = dict(zip(names, golden["update_norm"]
                     / np.maximum(golden["unsharded/update_norm"], 1e-30)))
    np.testing.assert_allclose(ratio["center/Conv_0/kernel"], 2.0,
                               rtol=1e-2)
    assert all(r > 1.9 for k, r in ratio.items()
               if k.startswith("encoder/") and k.endswith("kernel"))
    np.testing.assert_allclose(ratio["dec5/c3x3/kernel"], 1.0, rtol=1e-2)
    np.testing.assert_allclose(ratio["final/kernel"], 1.0, rtol=1e-3)


def test_space_eval_96_iou_counts_exact(ranks, weights):
    """(d): the 96^2 eval on the 2 x 2 grid, a sample a 'space' pair (H/32
    holds 3 rows: 1 and 2): preds, IoU counts and the loss of the
    one-process eval, and no dense-block kernel (the JAX dispatch runs the
    plain encoder on a 'space' mesh)."""
    path, _ = weights
    batch = _eval_batch()
    model = build_model(path)
    state = create_train_state(model, radam(0.0), "cpu")
    _, preds, metrics = make_eval_step(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    preds = preds.numpy()
    inter, union = iou_counts(preds, batch["label"], batch["valid"])
    r = [x["eval"] for x in ranks[0]]
    got = _assemble([torch.from_numpy(x["preds"]) for x in r], 2, 1)
    np.testing.assert_array_equal(got.numpy(), preds)
    np.testing.assert_array_equal(sum(x["inter"] for x in r), inter)
    np.testing.assert_array_equal(sum(x["union"] for x in r), union)
    for k in LOSS_PARTS:
        np.testing.assert_allclose(float(r[0]["metrics"][k]),
                                   float(metrics[k]), rtol=1e-5, err_msg=k)
    assert all(x["launches"]["dense_block"] == 0 for x in r)


def test_space_dry_run_2x2(ranks):
    """(e): `run_mesh_step(4, hw=64)` on the group runs as 2 x 2: a finite
    loss, the same on every rank."""
    losses = [res["dryrun"] for res in ranks[0]]
    assert np.isfinite(losses[0]) and all(x == losses[0] for x in losses)
    assert "('data' 2, 'space' 2)" in ranks[1][0]


def test_scaling_inventory_on_the_space_grid(ranks):
    """(f): one recorded step on the 2 x 2 grid (two samples a rank):
    every rank's all-reduces the same; the gradients and the BatchNorm
    statistics the JAX SAUNet's closed forms, over all four ranks; the
    row exchanges and the other 'space' sums over the pair; the exchanges
    exactly as `exchange_rows` counted them; their prediction at 512^2
    with 8 samples a rank scaled by width x samples, their count kept."""
    invs = [res["scaling"] for res in ranks[0]]
    assert all(inv["collectives"] == invs[0]["collectives"] for inv in invs)
    inv = invs[0]
    assert inv["grid"] == {"data": 2, "space": 2}
    assert inv["samples_per_rank"] == 2
    classes = by_class(inv["collectives"])
    param_bytes = next(build_unet().parameters()).element_size()
    want = scaling_closed_forms(param_bytes)
    assert classes["gradients"]["bytes"] == want["gradients"]
    assert classes["bn_stats"]["bytes"] == want["bn_stats"]
    for c in ("gradients", "bn_stats", "loss_metrics"):
        assert classes[c]["group"] == 4, c
    for c in ("row_exchanges", "space_sums"):
        assert classes[c]["group"] == 2 and classes[c]["count"] > 0, c
    rows = classes["row_exchanges"]
    assert inv["exchange_rows"] == {"calls": rows["count"],
                                    "bytes": rows["bytes"]}
    width, samples = TARGETS["512^2 b8"]
    pred = predict({"data2": inv, "data2_space2": inv}, 100.0)
    at_512 = pred["2x2"]["512^2 b8"]["classes"]["row_exchanges"]
    assert at_512 == {"count": rows["count"],
                      "bytes": rows["bytes"] * width / 64 * samples / 2}


def test_envelope_matches_jax():
    """(e): the port accepts exactly the 'space' sizes the JAX package
    accepts, and refuses a one-row shard of the deepest dense block
    (test_spatial_partition.py::test_one_row_shard_bug_is_guarded)."""
    from saunet_tpu.parallel import validate_spatial_partition as jax_check

    def accepts(check, crop, space):
        try:
            check(crop, space)
            return True
        except ValueError:
            return False

    for crop in (32, 64, 96, 128, 224, 256, 512):
        for space in (1, 2, 3, 4, 8, 16):
            assert accepts(validate_spatial_partition, crop, space) == \
                accepts(jax_check, crop, space), (crop, space)
    validate_spatial_partition(64, 2)
    validate_spatial_partition(256, 8)
    with pytest.raises(ValueError, match="row"):
        validate_spatial_partition(32, 2)
    with pytest.raises(ValueError, match="row"):
        validate_spatial_partition(64, 4)


def test_row_split_and_levels():
    """`rows` splits every level into contiguous blocks, the larger ones
    last; a SpaceShard finds a tensor's level from its rows."""
    assert [rows(7, s, 2) for s in range(2)] == [(0, 3), (3, 7)]
    assert [rows(14, s, 4) for s in range(4)] == [(0, 3), (3, 7), (7, 10),
                                                  (10, 14)]
    for h in (7, 14, 64, 224):
        for space in (2, 4):
            assert rows(h, 0, space)[0] == 0
            assert rows(h, space - 1, space)[1] == h
    for s in range(2):
        shard = SpaceShard(None, s, 2, 224)
        for k in range(6):
            lo, hi = shard.rows(224 >> k)
            assert shard.level(hi - lo) == 224 >> k


def test_space_batch_layout():
    """Rank r of a 2 x 2 grid holds samples of data index r // 2 and rows
    of space index r % 2; rank-1 entries are split by sample alone."""
    batch = {"image": np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6,
                                                                     2),
             "valid": np.arange(4, dtype=np.float32)}
    for rank in range(4):
        mesh = DataMesh(world=4, rank=rank, local_rank=rank, local_world=4,
                        device=torch.device("cpu"), backend="gloo",
                        group=None, space=2)
        d, s = rank // 2, rank % 2
        out = shard_batch(batch, mesh)
        assert torch.equal(out["image"], torch.from_numpy(
            batch["image"][2 * d:2 * d + 2, 3 * s:3 * s + 3]))
        assert torch.equal(out["valid"], torch.tensor([2. * d, 2. * d + 1]))
        whole = shard_batch(batch, mesh, split_rows=False)
        assert whole["image"].shape == (2, 6, 2)


def test_dry_run_grid_is_the_jax_dry_runs():
    """Repair: n ranks run as (n // 2) x 2 when n is even and at least 4,
    else n x 1 (saunet_tpu/parallel/dryrun.py)."""
    assert [grid(n) for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 2)]


def test_cli_global_batch_under_space(monkeypatch):
    """Repair: under torchrun with --space S the global batch is
    --batch_size_per_device x world / S, as the JAX CLI computes it;
    --space outside the envelope or not dividing the world raises."""
    from saunet_tpu_torch.cli.train import parse_args

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    args = parse_args(["--space", "2", "--batch_size_per_device", "3",
                       "--crop_size", "64"])
    assert args.batch_size == 6 and "-ndev4-batchSize6-" in args.id
    with pytest.raises(ValueError, match="row"):
        parse_args(["--space", "4", "--crop_size", "64"])
    with pytest.raises(ValueError, match="divide"):
        parse_args(["--space", "3", "--crop_size", "224"])


def test_shard_map_step_refuses_space():
    """The per-rank-loss step is a 'data' step, as the JAX one."""
    from saunet_tpu_torch.parallel.shard_map_step import (
        make_shard_map_train_step,
    )

    mesh = DataMesh(world=2, rank=0, local_rank=0, local_world=2,
                    device=torch.device("cpu"), backend="gloo", group=None,
                    space=2)
    with pytest.raises(ValueError, match="'space'"):
        make_shard_map_train_step(torch.nn.Linear(1, 1), radam(1e-3), mesh)


def test_partition_space_without_mesh_changes_nothing():
    model = DenseBlock(8, 1)
    with partition_space(model, None, 8):
        assert all(getattr(m, "space", None) is None
                   for m in model.modules())
