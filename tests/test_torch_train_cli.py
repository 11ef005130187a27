"""The port's train CLI (saunet_tpu_torch.cli.train) end to end on
synthetic ACDC volumes, on the pattern of tests/test_cli_integration.py:
one epoch at crop 32 on the CPU, `--resume` from its checkpoint, and the
checkpoint served by `test_and_pack`. Also: the CLIs (train,
test_and_pack, saliency) default to the card and refuse to run without
one. Port only: no jax."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from saunet_tpu_torch.cli.test_and_pack import main as pack_main
from saunet_tpu_torch.cli.saliency import main as saliency_main
from saunet_tpu_torch.cli.train import main as train_main
from saunet_tpu_torch.cli.train import parse_args
from saunet_tpu_torch.data import nifti
from torch_port_util import one_thread  # noqa: F401  (fixture)

SHAPE = (40, 44, 2)  # (H, W, Z) of every synthetic volume


def _write_acdc(root):
    """3 training patients x 2 frames (1 volume for validation, 5 for
    training: 10 train slices, 2 val slices) and 1 test volume."""
    rs = np.random.RandomState(0)
    h, w, z = SHAPE
    yy, xx = np.mgrid[:h, :w]
    for p in range(1, 4):
        pdir = os.path.join(root, "training", f"patient{p:03d}")
        os.makedirs(pdir, exist_ok=True)
        for fr in (1, 12):
            r = 8 + 2 * p + fr % 3
            seg = np.where((yy - 20) ** 2 + (xx - 22) ** 2 < r * r,
                           1 + (xx > 22) + (yy > 24), 0).astype(np.uint8)
            seg = np.repeat(seg[..., None], z, axis=2)
            img = (60 * seg + 40 * rs.rand(h, w, z)).astype(np.float32)
            base = os.path.join(pdir, f"patient{p:03d}_frame{fr:02d}")
            nifti.save(img, base + ".nii.gz", pixdim=(1.3, 1.3, 10))
            nifti.save(seg, base + "_gt.nii.gz", pixdim=(1.3, 1.3, 10))
    tdir = os.path.join(root, "testing", "patient101")
    os.makedirs(tdir, exist_ok=True)
    nifti.save((rs.rand(*SHAPE) * 300).astype(np.float32),
               os.path.join(tdir, "patient101_frame01.nii.gz"),
               pixdim=(1.3, 1.3, 10))


def _args(root, ckpt, epochs, *extra):
    return ["--data-root", root, "--ckpt", ckpt, "--num_epoch", str(epochs),
            "--batch_size_per_device", "2", "--crop_size", "32",
            "--dtype", "float32", "--device", "cpu", "--id", "t", *extra]


def test_train_resume_and_serve(tmp_path, capsys):
    root, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    _write_acdc(root)

    train_main(_args(root, ckpt, 1))
    out = capsys.readouterr().out
    run1 = parse_args(_args(root, ckpt, 1)).ckpt
    assert sorted(os.listdir(run1)) == ["best.json", "history_epoch_1.json",
                                        "state_epoch_1.pt"]
    assert "class [3], IoU:" in out and "Training Done!" in out
    best = json.load(open(os.path.join(run1, "best.json")))
    assert set(best) == {"mIoU_1", "mIoU_2", "mIoU_3", "mIoU", "epoch_1",
                         "epoch_2", "epoch_3", "epoch"}
    hist = json.load(open(os.path.join(run1, "history_epoch_1.json")))
    assert np.isfinite(hist["train"]["loss"][0])
    assert len(hist["val"]["iou"][0]) == 3
    saved = torch.load(os.path.join(run1, "state_epoch_1.pt"),
                       weights_only=True)
    assert saved["step"] == 5  # 10 train slices, batch 2

    # --resume: a 2-epoch run holding the epoch-1 state goes on at epoch 2
    run2 = parse_args(_args(root, ckpt, 2)).ckpt
    os.makedirs(run2)
    shutil.copy(os.path.join(run1, "state_epoch_1.pt"), run2)
    train_main(_args(root, ckpt, 2, "--resume"))
    out = capsys.readouterr().out
    assert "continuing at epoch 2" in out
    assert "Epoch: [1/2]" not in out
    resumed = torch.load(os.path.join(run2, "state_epoch_2.pt"),
                         weights_only=True)
    assert resumed["step"] == 10
    assert resumed["optimizer"]["state"]["count"] == 10
    assert any(not torch.equal(resumed["model"][k], saved["model"][k])
               for k in saved["model"])

    # serving reads the train CLI's checkpoint
    res_out = str(tmp_path / "out")
    pack_main(["--id", "t", "--checkpoint",
               os.path.join(run2, "state_epoch_2.pt"), "--data-root", root,
               "--crop_size", "32", "--dtype", "float32", "--device", "cpu",
               "--no-visualize", "--save_test_path", res_out, "--result",
               str(tmp_path / "res")])
    pred = nifti.load(os.path.join(res_out, "patient101_ED.nii.gz")).data
    assert pred.shape == SHAPE
    assert set(np.unique(pred)) <= {0, 1, 2, 3}


@pytest.mark.parametrize("cli", ["train", "test_and_pack", "saliency"])
def test_clis_default_to_the_card(tmp_path, cli):
    """No --device: the CLIs take the card, and without one they raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is satisfied")
    root = str(tmp_path / "data")
    _write_acdc(root)
    if cli == "train":
        argv = ["--data-root", root, "--ckpt", str(tmp_path / "c"),
                "--num_epoch", "1", "--crop_size", "32"]
        run = train_main
    elif cli == "saliency":
        argv = ["--checkpoint", str(tmp_path / "m.pt"), "--data-root", root,
                "--crop_size", "32", "--out", str(tmp_path / "s")]
        run = saliency_main
    else:
        model_path = str(tmp_path / "m.pt")
        torch.save({}, model_path)
        argv = ["--id", "t", "--checkpoint", model_path, "--data-root", root,
                "--crop_size", "32", "--save_test_path",
                str(tmp_path / "o"), "--result", str(tmp_path / "r")]
        run = pack_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv)


def test_train_refuses_spatial_parallelism():
    with pytest.raises(ValueError, match="--space"):
        parse_args(["--space", "2"])
