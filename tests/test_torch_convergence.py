"""The port's long-run check and BN-statistics probe against the JAX
package's (saunet_tpu_torch/cli/fidelity.py: `foreground_miou`,
`eval_batch_stats`, `run_convergence`, the 'stat', 'stat-cpu' and
'card256' configs; counterparts of tools/fidelity.py::run, ::_iou and
tools/probe_bn_transient.py).

The JAX side is read from tests/torch_golden/convergence.npz and
trajectory_256.npz (make_convergence.py and make_trajectory_256.py write
them with the JAX train and eval steps); nothing here runs a JAX step.
'stat-cpu' (8 steps at 64^2, batch 2, evaluated at steps 4 and 8) holds
the golden's losses within the 'cpu' trajectory config's 2e-3 and the last
eval point's validation logits within LOGITS_TOL of max|ref|: the port
against itself under other summation orders (1, 3 and 8 intra-op threads,
oneDNN off; tests/torch_golden/spread_stat.py) moved them by up to
2.25e-2 of max|ref| under the running statistics and 8.82e-2 under the
batch's own (two slices a batch: the center block's BatchNorm normalises
8 values a channel), so the tolerances are twice those, rounded up."""
import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

from saunet_tpu_torch.cli import fidelity as gate
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.init import fill_from_seed_
from saunet_tpu_torch.ops.cuda import KERNELS
from torch_port_util import one_thread  # noqa: F401  (fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(REPO, "tools"))

# of max|ref| of the golden's logits; twice the port's own spread
# (tests/torch_golden/spread_stat.py)
LOGITS_TOL = {"running": 0.05, "batch": 0.18}


@pytest.fixture(scope="module")
def stat_cpu():
    launches = [k.launches for k in KERNELS]
    port = gate.run_convergence("stat-cpu", "cpu", return_logits=True)
    assert [k.launches for k in KERNELS] == launches  # plain on the CPU
    return port


@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("kind", ["numpy", "tensor", "mixed"])
def test_foreground_miou_equals_jax_tool(per_class, kind):
    from fidelity import _iou

    rs = np.random.RandomState(5)
    labels = rs.randint(0, 4, (3, 16, 16)).astype(np.int32)
    preds = np.where(rs.rand(3, 16, 16) < 0.6, labels,
                     rs.randint(0, 4, (3, 16, 16)))
    # class 2 in neither: an empty union counts 0
    labels[labels == 2], preds[preds == 2] = 0, 1
    want = _iou(preds, labels, per_class=per_class)
    p, lab = preds, labels
    if kind in ("tensor", "mixed"):
        p = torch.from_numpy(preds)
    if kind == "tensor":
        lab = torch.from_numpy(labels)
    got = gate.foreground_miou(p, lab, per_class=per_class)
    assert got == want
    if per_class:
        assert got[1][1] == 0.0 and len(got[1]) == 3


def test_eval_batch_stats_leaves_running_stats_and_modes():
    model = fill_from_seed_(build_unet(), gate.WEIGHT_SEED, gate.FUSE_SCALE)
    model.train()
    model.center.eval()  # a mixed mode is kept as it was
    before = {k: v.clone() for k, v in model.state_dict().items()}
    modes = {n: m.training for n, m in model.named_modules()}
    images = torch.from_numpy(gate.phantom_data(32, 2)["image"])
    preds, logits = gate.eval_batch_stats(model, images, return_logits=True)
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert {n: m.training for n, m in model.named_modules()} == modes
    assert torch.equal(gate.eval_batch_stats(model, images), preds)
    assert preds.shape == (2, 32, 32) and torch.equal(logits.argmax(1),
                                                      preds)
    # the batch's own statistics: a train-mode forward's logits, not the
    # eval-mode forward's
    model.train()
    with torch.no_grad():
        train_seg = model(images.permute(0, 3, 1, 2))[0]
    model.eval()
    with torch.no_grad():
        eval_seg = model(images.permute(0, 3, 1, 2))[0]
    assert torch.equal(logits, train_seg)
    assert not torch.allclose(logits, eval_seg, atol=1e-3)


def test_stat_cpu_matches_golden(stat_cpu):
    golden = gate.load_golden("stat-cpu")
    res = gate.compare_convergence(stat_cpu, golden, "stat-cpu")
    print(f"stat-cpu: largest relative loss difference "
          f"{res['max_loss_rel_diff']:.4e}; final mIoU running "
          f"{res['final_miou_running']:.4f} (JAX "
          f"{res['jax_final_miou_running']:.4f}), batch statistics "
          f"{res['final_miou_batch']:.4f} (JAX "
          f"{res['jax_final_miou_batch']:.4f})")
    assert stat_cpu["eval_step"] == [4, 8]
    np.testing.assert_allclose(stat_cpu["loss"], golden["loss"], rtol=0,
                               atol=gate.MAX_REL_DIFF["cpu"]
                               * float(np.abs(golden["loss"]).min()))
    assert res["max_loss_rel_diff"] < gate.MAX_REL_DIFF["cpu"]
    assert res["ok"], res
    for kind, tol in LOGITS_TOL.items():
        got, want = stat_cpu[f"logits_{kind}"], golden[f"logits_{kind}"]
        assert got.shape == want.shape == (4, 64, 64, 4)
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        print(f"logits under the {kind} statistics: max|d| {err:.4e} of "
              f"max|ref| (bound {tol})")
        assert err <= tol, kind
        preds = got.argmax(-1)
        assert (preds == want.argmax(-1)).mean() > 0.95, kind
    # the mIoU reported is the one of the logits
    label = gate.stat_data("stat-cpu")["val"]["label"]
    for kind in LOGITS_TOL:
        assert gate.foreground_miou(
            stat_cpu[f"logits_{kind}"].argmax(-1), label) == \
            stat_cpu[f"miou_{kind}"][-1]


def test_cli_exits_on_the_bounds(stat_cpu, monkeypatch, capsys):
    monkeypatch.setattr(gate, "run_convergence",
                        lambda *a, **k: dict(stat_cpu))
    assert gate.main(["--config", "stat-cpu", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == ["step   4",
                                                       "step   8"]
    summary = json.loads(lines[-1])
    assert summary["ok"] and summary["config"] == "stat-cpu"
    off = dict(stat_cpu, loss=[v * 1.01 for v in stat_cpu["loss"]])
    monkeypatch.setattr(gate, "run_convergence", lambda *a, **k: off)
    assert gate.main(["--config", "stat-cpu", "--device", "cpu"]) == 1
    assert not json.loads(capsys.readouterr().out.splitlines()[-1])["ok"]


def test_floor_checks(stat_cpu, monkeypatch):
    """With the 'stat' config's bounds and floor (tests/test_fidelity.py's
    criteria): the loss at the last eval point under 0.9 times the
    first's, the final mIoU above 0.5 and within 0.15 of the golden's."""
    monkeypatch.setitem(gate.STAT_BOUNDS, "stat-cpu",
                        dict(gate.STAT_BOUNDS["stat"], loss_steps=8))
    golden = {k: np.asarray(v) for k, v in stat_cpu.items()
              if not k.startswith("logits")}
    golden.update(miou_running=np.asarray([0.5, 0.52]),
                  miou_batch=np.asarray([0.5, 0.52]))
    loss = list(stat_cpu["loss"])
    loss[7] = 0.85 * loss[3]

    def verdict(**kw):
        port = dict(stat_cpu, loss=loss, miou_running=[0.5, 0.53],
                    miou_batch=[0.5, 0.53])
        port.update(kw)
        golden["loss"] = np.asarray(port["loss"], np.float32)
        res = gate.compare_convergence(port, golden, "stat-cpu")
        return {k for k, ok in res["checks"].items() if not ok}

    assert verdict() == set()
    assert verdict(miou_running=[0.5, 0.49]) == {"miou_above_half"}
    assert verdict(miou_running=[0.5, 0.68]) == {"miou_running",
                                                 "miou_within_0.15"}
    assert verdict(miou_batch=[0.5, 0.55]) == {"miou_batch"}
    flat = loss[:7] + [0.95 * loss[3]]
    assert verdict(loss=flat) == {"loss_falls"}


def test_configs_equal_the_jax_tools():
    from fidelity import run

    defaults = {k: p.default for k, p in
                inspect.signature(run).parameters.items()
                if k not in ("verbose",)}
    assert defaults == dict(gate.STAT_CONFIGS["stat"], lr=gate.LR)
    with open(os.path.join(REPO, "docs", "fidelity_det_256.json")) as f:
        det256 = json.load(f)["config"]
    assert det256 == dict(gate.CONFIGS["card256"], lr=gate.LR)
    for name, c in gate.STAT_CONFIGS.items():
        assert c["steps"] % c["eval_every"] == 0, name


@pytest.mark.parametrize("config", ["stat", "stat-cpu", "card256"])
def test_goldens_hold_the_ports_configs(config):
    golden = gate.load_golden(config)  # raises on another config
    cfg = gate.CONFIGS.get(config) or gate.STAT_CONFIGS[config]
    assert float(golden["lr"]) == gate.LR
    assert len(golden["loss"]) == cfg["steps"]
    for k in gate.PARTS:
        assert np.isfinite(golden[k]).all(), k
    if config in gate.STAT_CONFIGS:
        points = list(range(cfg["eval_every"], cfg["steps"] + 1,
                            cfg["eval_every"]))
        assert golden["eval_step"].tolist() == points
        for k in ("miou_running", "miou_batch"):
            assert golden[k].shape == (len(points),)
        for k in ("iou_pc_running", "iou_pc_batch"):
            assert golden[k].shape == (len(points), gate.NUM_CLASS - 1)
    if config == "stat":
        # the JAX run meets tests/test_fidelity.py's criteria itself
        loss_at = golden["loss"][golden["eval_step"] - 1]
        assert loss_at[-1] < 0.9 * loss_at[0]
        assert golden["miou_running"][-1] > 0.5


def test_stat_data_equals_jax_tool():
    from fidelity import _batches

    from saunet_tpu.data.phantom import make_phantom_set

    for name, cfg in gate.STAT_CONFIGS.items():
        ref = _batches(cfg["n_train"], cfg["batch"], cfg["steps"],
                       gate.SCHEDULE_SEED)
        got = gate.batches(cfg["n_train"], cfg["batch"], cfg["steps"],
                           gate.SCHEDULE_SEED)
        assert [list(a) for a in got] == [list(b) for b in ref], name
    cfg = gate.STAT_CONFIGS["stat-cpu"]
    imgs, labels = make_phantom_set(cfg["n_train"] + cfg["n_val"],
                                    hw=cfg["hw"], seed=gate.PHANTOM_SEED)
    ours = gate.stat_data("stat-cpu")
    n = cfg["n_train"]
    np.testing.assert_array_equal(ours["train"]["image"][..., 0], imgs[:n])
    np.testing.assert_array_equal(ours["val"]["image"][..., 2], imgs[n:])
    np.testing.assert_array_equal(ours["train"]["label"], labels[:n])
    np.testing.assert_array_equal(ours["val"]["label"], labels[n:])
