"""The port takes up a JAX training run: the optax state of each optimizer
`create_optimizer` builds, a resumed whole-model step, `cli.train
--resume` on a run directory that holds a JAX `.msgpack`; and two modules
of the same theme, the TorchSAUNet weight map and the SegmentationModule
facade.

  (a) radam, adam and sgd at counts 7 (RAdam's adaptive branch) and 3 (its
      momentum branch): a JAX checkpoint of a small model (a DecoderBlock:
      conv, ConvTranspose and BatchNorm leaves) with seeded moments goes
      through `restore_checkpoint`, and the port's next update equals
      optax's `tx.update` on the same seeded gradients within atol 1e-6
      (the bound of test_torch_train_parts.py::
      test_optimizer_matches_optax);
  (b) the full-width SAUNet resumed from a JAX checkpoint at step 7 takes
      one step held to the JAX step in tests/torch_golden/resume_32.npz
      (tests/torch_golden/make_resume_32.py) with the tolerances of
      test_torch_train_step.py;
  (c) `cli.train --resume --encoder_concat fused` takes up that checkpoint
      at epoch 2, and the newest epoch of .pt and .msgpack wins;
  (d) `port_torch_saunet_state_dict` of a random TorchSAUNet
      (tools/torch_baseline.py) serves the same eval forward;
  (e) SegmentationModule's train, predict and infer_loss against the JAX
      facade's, stored in resume_32.npz.

JAX trees come from `jax.eval_shape` and seeded fills (`fill_variables`,
`fill_opt_state`), never a flax init of the whole SAUNet."""
import os
import shutil
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from saunet_tpu.models.blocks import DecoderBlock as DecoderBlockJax
from saunet_tpu.train.checkpoint import save_checkpoint as save_checkpoint_jax
from saunet_tpu.train.optim import create_optimizer as create_optimizer_jax
from saunet_tpu.train.optim import (
    cosine_epoch_schedule as cosine_epoch_schedule_jax,
)
from saunet_tpu.train.optim import radam as radam_jax
from saunet_tpu.train.state import TrainState as TrainStateJax
from saunet_tpu_torch.cli.train import _latest_checkpoint, parse_args
from saunet_tpu_torch.cli.train import main as train_main
from saunet_tpu_torch.models import (
    SegmentationModule,
    build_unet,
    port_torch_saunet_state_dict,
)
from saunet_tpu_torch.models.blocks import DecoderBlock
from saunet_tpu_torch.models.jax_weights import (
    from_jax_variables,
    port_params,
)
from saunet_tpu_torch.train import (
    cosine_epoch_schedule,
    create_optimizer,
    create_train_state,
    make_train_step,
    radam,
    restore_checkpoint,
)
from saunet_tpu_torch.train.optim import load_jax_opt_state
from test_torch_train_cli import _args, _write_acdc
from torch_port_util import (  # noqa: F401  (fixture)
    FACADE_SAMPLES,
    GOLDEN_LEAVES,
    GOLDEN_RESUME,
    GOLDEN_TRAIN_STEP,
    RESUME_COUNT,
    RESUME_LR,
    RESUME_SEED,
    fill_opt_state,
    fill_variables,
    flat_leaves,
    golden_batch,
    golden_variables_like,
    one_thread,
    to_jax_variables,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from torch_baseline import TorchSAUNet  # noqa: E402

LOSS_PARTS = ("loss", "ce", "dice", "edge")


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- (a) each optimizer's state -----------------------------------------------

SMALL_IN = (1, 8, 8, 5)  # NHWC input of the DecoderBlock(6, 4)
OPT_LR = 1e-2
# (optimizer, count): count 7 with the CLI's cosine schedule (optax keeps a
# second count), count 3 with a float learning rate (no second count)
OPT_CASES = [(name, count) for name in ("radam", "adam", "sgd")
             for count in (7, 3)]
# port moment name -> the optax state field it comes from
MOMENT_FIELD = {"exp_avg": "mu", "exp_avg_sq": "nu", "trace": "trace"}


@pytest.fixture(scope="module")
def small_variables():
    shapes = jax.eval_shape(
        lambda k: DecoderBlockJax(6, 4).init(k, jnp.zeros(SMALL_IN), True),
        jax.random.PRNGKey(0))
    return fill_variables(dict(shapes), seed=6)


def _learning_rates(count: int):
    if count == 7:
        return (cosine_epoch_schedule_jax(OPT_LR, 4, 3),
                cosine_epoch_schedule(OPT_LR, 4, 3))
    return OPT_LR, OPT_LR


def _optax_moments(opt_state) -> dict:
    """{port moment name: params-keyed tree} of an optax state of
    `create_optimizer` (flax's state-dict form: tuples as '0'/'1')."""
    tree = serialization.to_state_dict(opt_state)
    inner = tree["0"] if "mu" in tree["0"] else tree["1"]["0"]
    return {name: inner[field] for name, field in MOMENT_FIELD.items()
            if field in inner}


@pytest.mark.parametrize("name, count", OPT_CASES,
                         ids=[f"{n}_{c}" for n, c in OPT_CASES])
def test_optimizer_resumes_jax_state(name, count, small_variables,
                                     tmp_path):
    params = small_variables["params"]
    lr_jax, lr = _learning_rates(count)
    tx_jax = create_optimizer_jax(name, lr_jax)
    opt_state = fill_opt_state(tx_jax, params, count, seed=count)
    path = save_checkpoint_jax(
        str(tmp_path), "epoch_1",
        TrainStateJax(step=np.asarray(count, np.int32), params=params,
                      batch_stats=small_variables["batch_stats"],
                      opt_state=opt_state), {})

    model = DecoderBlock(SMALL_IN[-1], 6, 4)
    tx = create_optimizer(name, lr)
    state = create_train_state(model, tx, "cpu")
    restore_checkpoint(path, state)
    assert state.step == count and state.optimizer.state["count"] == count
    sd = model.state_dict()
    for k, v in from_jax_variables(small_variables).items():
        assert torch.equal(sd[k], v), k
    moments = _optax_moments(opt_state)
    for moment, tree in moments.items():
        for k, v in port_params(tree).items():
            got = state.optimizer.state[dict(model.named_parameters())[k]]
            assert got[moment].dtype == torch.float32
            assert torch.equal(got[moment], v), (moment, k)

    rs = np.random.RandomState(100 + count)
    grads = jax.tree.map(
        lambda p: (1e-2 * rs.randn(*p.shape)).astype(np.float32), params)
    updates, new_state = tx_jax.update(grads, opt_state, params)
    new_params = port_params(optax.apply_updates(params, updates))
    for k, p in model.named_parameters():
        p.grad = port_params(grads)[k]
    state.optimizer.step()
    named = dict(model.named_parameters())
    for k, v in new_params.items():
        np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    for moment, tree in _optax_moments(new_state).items():
        for k, v in port_params(tree).items():
            np.testing.assert_allclose(
                state.optimizer.state[named[k]][moment].numpy(), v.numpy(),
                rtol=0, atol=1e-6, err_msg=f"{moment} {k}")
    assert state.optimizer.state["count"] == count + 1


def test_optax_state_refusals(small_variables):
    """A tree of another optimizer's kind, a count other than the step and
    a tree of no optimizer raise before the optimizer changes."""
    params = small_variables["params"]
    tree = serialization.to_state_dict(
        fill_opt_state(radam_jax(OPT_LR), params, 7, seed=1))
    model = DecoderBlock(SMALL_IN[-1], 6, 4)
    sgd = create_optimizer("sgd", OPT_LR)(model)
    with pytest.raises(ValueError, match="does not fit SGD"):
        load_jax_opt_state(sgd, model, tree, 7)
    opt = radam(OPT_LR)(model)
    with pytest.raises(ValueError, match=r"counts \[7\] differ"):
        load_jax_opt_state(opt, model, tree, 6)
    with pytest.raises(ValueError, match="fits none"):
        load_jax_opt_state(opt, model, {"0": tree["0"]}, 7)
    assert opt.state["count"] == 0 and len(opt.state) == 1


# -- (b) a resumed whole-model step -------------------------------------------

@pytest.fixture(scope="module")
def variables():
    """The golden step's starting variables (`golden_variables`)."""
    return golden_variables_like(build_unet(dtype="float32"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, variables):
    """(checkpoint path, variables): a full-width JAX checkpoint at step
    RESUME_COUNT with the CLI's optimizer (radam, cosine schedule) and
    `fill_opt_state`'s moments, written by the JAX package as its CLI
    writes `state_epoch_1.msgpack` (about 380 MB)."""
    tx = create_optimizer_jax("radam", cosine_epoch_schedule_jax(1e-4, 2, 5))
    state = TrainStateJax(
        step=np.asarray(RESUME_COUNT, np.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=fill_opt_state(tx, variables["params"], RESUME_COUNT,
                                 RESUME_SEED))
    work = tmp_path_factory.mktemp("jax_run")
    path = save_checkpoint_jax(str(work), "epoch_1", state, {})
    yield path, variables
    shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN_RESUME))


def test_resumed_step_matches_jax(jax_run, golden):
    """The golden step's optimizer is radam(RESUME_LR); the checkpoint's
    second count (the schedule's) is the same count, and the moments are
    the same draws."""
    path, variables = jax_run
    model = build_unet(dtype="float32")
    tx = radam(RESUME_LR)
    state = create_train_state(model, tx, "cpu")
    restore_checkpoint(path, state)
    assert state.step == RESUME_COUNT
    state, metrics = make_train_step(model, tx)(state,
                                                _torch(golden_batch()))
    assert state.step == int(golden["step"])
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
    # test_torch_train_step.py's UPDATE_TOL for a train-mode step
    scale = max(np.abs(golden[f"update/{k}"]).max() for k in GOLDEN_LEAVES)
    for k in GOLDEN_LEAVES:
        np.testing.assert_allclose(new_p[k] - old_p[k],
                                   golden[f"update/{k}"], rtol=0,
                                   atol=3e-3 * scale, err_msg=k)


# -- (c) the CLI --------------------------------------------------------------

def test_cli_resumes_jax_run(jax_run, tmp_path, capsys):
    """The user copies the JAX run's state_epoch_1.msgpack into the port
    run's directory (same global batch) and passes --resume: the run goes
    on at epoch 2 from step RESUME_COUNT, with the fused layout."""
    root, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    _write_acdc(root)
    argv = _args(root, ckpt, 2, "--batch_size_per_device", "4")
    run = parse_args(argv).ckpt
    os.makedirs(run)
    shutil.copy(jax_run[0], os.path.join(run, "state_epoch_1.msgpack"))
    train_main(argv + ["--resume", "--encoder_concat", "fused"])
    out = capsys.readouterr().out
    assert "state_epoch_1.msgpack (epoch 1); continuing at epoch 2" in out
    assert "Epoch: [1/2]" not in out and "Training Done!" in out
    saved = torch.load(os.path.join(run, "state_epoch_2.pt"),
                       weights_only=True)
    # 10 train slices at batch 4: 2 steps
    assert saved["step"] == RESUME_COUNT + 2
    assert saved["optimizer"]["state"]["count"] == RESUME_COUNT + 2
    assert _latest_checkpoint(run) == (
        os.path.join(run, "state_epoch_2.pt"), 2)


def test_latest_checkpoint_takes_newest_epoch(tmp_path):
    def latest(*names):
        d = tmp_path / str(len(os.listdir(tmp_path)))
        d.mkdir()
        for n in names:
            (d / n).touch()
        path, epoch = _latest_checkpoint(str(d))
        return os.path.basename(path), epoch

    assert latest("state_epoch_2.pt", "state_epoch_3.msgpack") == (
        "state_epoch_3.msgpack", 3)
    assert latest("state_epoch_4.pt", "state_epoch_3.msgpack") == (
        "state_epoch_4.pt", 4)
    # one epoch in both: the port's own file
    assert latest("state_epoch_5.msgpack", "state_epoch_5.pt") == (
        "state_epoch_5.pt", 5)
    assert _latest_checkpoint(str(tmp_path / "none")) is None


# -- (d) TorchSAUNet weights --------------------------------------------------

def test_torch_saunet_weights_serve_the_same_forward():
    torch.manual_seed(3)
    ref = TorchSAUNet(edge_cue="canny")
    with torch.no_grad():  # BatchNorm leaves away from their init
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.7, 1.5)
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
    ref.eval()
    model = build_unet(dtype="float32").eval()
    model.load_state_dict(port_torch_saunet_state_dict(ref.state_dict()),
                          strict=True)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        want_seg, want_edge = ref(x)
        seg, edge = model(x)
    for got, want in ((seg, want_seg), (edge, want_edge)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    sd = ref.state_dict()
    sd["extra.weight"] = sd["final.weight"]
    with pytest.raises(KeyError, match="extra.weight"):
        port_torch_saunet_state_dict(sd)


# -- (e) the SegmentationModule facade ----------------------------------------

@pytest.fixture(scope="module")
def facade_model(variables):
    model = build_unet(dtype="float32")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model, variables


def test_facade_train_matches_jax(facade_model, golden):
    """The JAX facade's train forward is the golden step's forward: its
    batch statistics are train_step_32.npz's."""
    model, _ = facade_model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        loss, (acc, jaccard) = SegmentationModule(model).train(
            _torch(golden_batch()))
        np.testing.assert_allclose(float(loss.detach()),
                                   golden["facade/train/loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(float(acc), golden["facade/train/acc"],
                                   atol=1e-3)
        np.testing.assert_allclose(jaccard.numpy(),
                                   golden["facade/train/jaccard"], atol=1e-3)
        step_golden = np.load(GOLDEN_TRAIN_STEP)
        for k, v in flat_leaves(to_jax_variables(model)["batch_stats"]
                                ).items():
            np.testing.assert_allclose(v, step_golden[f"batch_stats/{k}"],
                                       rtol=1e-5, atol=2e-5, err_msg=k)
    finally:
        model.load_state_dict(state)


def test_facade_predict_matches_jax(facade_model, golden):
    model, _ = facade_model
    image = torch.from_numpy(golden_batch()["image"][:FACADE_SAMPLES])
    facade = SegmentationModule(model)
    with torch.no_grad():
        probs = facade.predict(image)
        probs_att, atts = facade.predict(image, return_att=True)
    # test_torch_train_step.py's eval-step tolerance on probabilities
    np.testing.assert_allclose(probs.numpy(), golden["facade/predict"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs_att.numpy(), probs.numpy(), rtol=0,
                               atol=0)
    assert len(atts) == 7
    for i, a in enumerate(atts):
        np.testing.assert_allclose(a.numpy(),
                                   golden[f"facade/predict_att/att{i}"],
                                   rtol=0, atol=1e-3, err_msg=f"att{i}")


def test_facade_infer_loss_matches_jax(facade_model, golden):
    model, _ = facade_model
    batch = {k: v[:FACADE_SAMPLES] for k, v in golden_batch().items()}
    with torch.no_grad():
        probs, loss = SegmentationModule(model).infer_loss(_torch(batch))
    np.testing.assert_allclose(probs.numpy(),
                               golden["facade/infer_loss/probs"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(float(loss), golden["facade/infer_loss/loss"],
                               rtol=1e-4)
