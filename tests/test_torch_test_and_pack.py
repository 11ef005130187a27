"""The port's serving driver (saunet_tpu_torch.cli.test_and_pack) end to end
on synthetic ACDC test volumes, on the pattern of
tests/test_cli_integration.py. Port only: no jax."""
import json
import os

import numpy as np
import pytest
import torch

from saunet_tpu_torch.cli.test_and_pack import main as pack_main
from saunet_tpu_torch.data import (
    ACDCTestDataset,
    nifti,
    normalize_for_eval,
    resample_to_orig,
)
from saunet_tpu_torch.models import build_unet
from saunet_tpu_torch.models.init import calibrate_bn_, init_random_
from saunet_tpu_torch.ops.cuda import dense_block
from saunet_tpu_torch.train import InferState, make_infer_step
from torch_port_util import cuda_device, one_thread  # noqa: F401  (fixtures)

CROP = 32
SHAPES = {1: (40, 44, 2), 2: (36, 30, 3)}  # patient -> (H, W, Z)


def _write_volumes(root):
    rs = np.random.RandomState(0)
    for p, shape in SHAPES.items():
        pdir = os.path.join(root, "testing", f"patient{p:03d}")
        os.makedirs(pdir, exist_ok=True)
        img = (rs.rand(*shape) * 300).astype(np.float32)
        nifti.save(img, os.path.join(pdir, f"patient{p:03d}_frame01.nii.gz"),
                   pixdim=(1.3, 1.3, 10))


@pytest.mark.parametrize("extra", [["--no-visualize"], ["--attention_map"]],
                         ids=["preds", "visualize_and_maps"])
def test_test_and_pack_matches_infer_step(tmp_path, extra):
    root, out, res = (str(tmp_path / d) for d in ("data", "out", "res"))
    _write_volumes(root)
    model = init_random_(build_unet(dtype="float32"),
                         torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), ckpt)

    pack_main(["--id", "t", "--checkpoint", ckpt, "--data-root", root,
               "--crop_size", str(CROP), "--dtype", "float32",
               "--device", "cpu", "--save_test_path", out, "--result", res,
               *extra])

    timing = json.load(open(os.path.join(out, "timing.json")))
    assert timing["ms_per_slice"] > 0

    # the same slices through the port's infer step
    step = make_infer_step(model)
    state = InferState(model, "cpu")
    ds = ACDCTestDataset(root, target_size=CROP)
    assert len(ds) == len(SHAPES)
    for i in range(len(ds)):
        vol = ds.load_volume(i)
        pred = nifti.load(os.path.join(out, vol.name + ".nii.gz")).data
        assert pred.shape == vol.orig_shape
        assert set(np.unique(pred)) <= {0, 1, 2, 3}
        imgs = torch.from_numpy(np.moveaxis(vol.image, 2, 0).copy())
        preds = step(state, normalize_for_eval(imgs))[1].numpy()
        want = resample_to_orig(np.moveaxis(preds, 0, 2).astype(np.uint8),
                                vol)
        np.testing.assert_array_equal(pred, want)

    if "--attention_map" in extra:
        n_slices = sum(s[2] for s in SHAPES.values())
        pngs = [f for f in os.listdir(os.path.join(res, "t"))
                if f.endswith(".png")]
        maps = os.listdir(os.path.join(res, "t", "attention"))
        assert len(pngs) == n_slices
        assert len(maps) == 7 * n_slices


def test_infer_step_serves_f32_model_on_card(cuda_device):  # noqa: F811
    """An f32 model on the card is served by the plain forward: the
    dense-block kernel, which takes bf16 only, is not launched, and the
    preds equal the model's own forward on the same card (TF32 off, so
    both are full f32)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        images = torch.from_numpy(np.random.RandomState(1).randn(
            2, 64, 64, 3).astype(np.float32)).to(cuda_device)
        model = init_random_(build_unet(dtype="float32"),
                             torch.Generator().manual_seed(0))
        model = calibrate_bn_(model.to(cuda_device),
                              images.permute(0, 3, 1, 2))
        state = InferState(model, cuda_device)
        before = dense_block.launches
        _, preds, _ = make_infer_step(model)(state, images)
        with torch.inference_mode():
            seg, _ = state.model(images.permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        assert dense_block.launches == before
        assert preds.shape == (2, 64, 64)
        assert torch.equal(preds, seg.argmax(dim=1))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
