"""ACDC (AC17) host-side dataset: NIfTI volumes -> fixed-size slice arrays.

Capability parity with the reference's data/ac17_dataloader.py (AC17Data,
AC17_2DLoad) and the reference's data/test_loader.py (AC17Test), redesigned
for a TPU input pipeline:

  * The reference eagerly augments whole volumes ONCE at init with PIL and
    freezes flips/rotations/gamma for the entire run
    (ac17_dataloader.py:182-189 calling AC17Data.__getitem__:133-150); only
    elastic deformation is re-rolled per epoch. Here the host does only the
    static geometry (read NIfTI, rescale in-plane to target spacing, min
    shift, pad-center-crop to 256²) and caches raw slice arrays; ALL random
    augmentation happens on-device per step (saunet_tpu/data/augment.py), so
    every epoch sees fresh transforms — a strict superset of the
    reference's augmentation schedule.
  * k-fold split semantics match ac17_dataloader.py:73-104: the series list
    has 200 (patient, frame) rows, k=5, fold `k_split` selects rows
    [(k_split-1)*40, k_split*40) as val.
  * The reference's series file uses a Windows path separator that breaks on
    POSIX (ac17_dataloader.py:107, SURVEY.md §2.7); we use portable joins
    and can also scan the dataset directory when no series file exists.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from .nifti import load as nifti_load

TARGET_SIZE = 256
TRAIN_SPACING = 1.25
TEST_SPACING = 1.5


def read_series_file(path: str) -> List[Tuple[int, int]]:
    """Parse 'patient frame' rows."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((int(parts[0]), int(re.sub(r"\D", "", parts[1]))))
    return out


def _scan_patient_dirs(root: str, pattern: str) -> List[Tuple[int, int]]:
    """(patient, frame) pairs of the files in root's patientXXX dirs whose
    names match `pattern` (its groups: patient, frame), in sorted order."""
    out = []
    pat = re.compile(pattern)
    for d in sorted(os.listdir(root)):
        pd = os.path.join(root, d)
        if not (d.startswith("patient") and os.path.isdir(pd)):
            continue
        for fn in sorted(os.listdir(pd)):
            m = pat.match(fn)
            if m:
                out.append((int(m.group(1)), int(m.group(2))))
    return out


def scan_training_dir(root: str) -> List[Tuple[int, int]]:
    """Discover (patient, frame) pairs by scanning patientXXX dirs for
    frame ground-truth files."""
    return _scan_patient_dirs(root,
                              r"patient(\d+)_frame(\d+)_gt\.nii(\.gz)?$")


def testing_dir(root: str) -> str:
    """The test volumes' directory of an ACDC root: `testing/testing` as
    the archive unpacks, else `testing`."""
    nested = os.path.join(root, "testing", "testing")
    return nested if os.path.isdir(nested) else os.path.join(root, "testing")


def scan_testing_dir(test_dir: str) -> List[Tuple[int, int]]:
    """Discover (patient, frame) pairs by scanning patientXXX dirs for
    frame images (test volumes have no ground truth)."""
    return _scan_patient_dirs(test_dir,
                              r"patient(\d+)_frame(\d+)\.nii(\.gz)?$")


def kfold_split(series: Sequence[Tuple[int, int]], split: str, k: int = 5,
                k_split: int = 1) -> List[Tuple[int, int]]:
    n = len(series)
    split_len = n // k
    lo, hi = (k_split - 1) * split_len, k_split * split_len
    if split == "train":
        return [s for i, s in enumerate(series) if not lo <= i < hi]
    return [s for i, s in enumerate(series) if lo <= i < hi]


def pad_center_crop(img: np.ndarray, size: int, round_up: bool = False
                    ) -> np.ndarray:
    """Pad with zeros and center-crop a 2D array to (size, size).

    round_up selects the test-path rounding (round-half-up on the crop
    origin, the reference's data/augmentations.py PaddingCenterCropTest)
    vs python round() on the train path.
    """
    h, w = img.shape

    def origin(extent):
        x = (extent - size) / 2.0
        if round_up:
            return int(x) + 1 if (x - int(x)) >= 0.5 else int(x)
        return int(round(x))

    out = np.zeros((size, size), dtype=img.dtype)
    if h >= size and w >= size:
        y0, x0 = origin(h), origin(w)
        out[:] = img[y0:y0 + size, x0:x0 + size]
        return out
    # pad then crop
    pad_h, pad_w = max(size - h, 0), max(size - w, 0)
    top, left = pad_h // 2, pad_w // 2
    padded = np.zeros((h + pad_h, w + pad_w), dtype=img.dtype)
    padded[top:top + h, left:left + w] = img
    ph, pw = padded.shape
    y0 = max(origin(h), 0)
    x0 = max(origin(w), 0)
    return padded[y0:y0 + size, x0:x0 + size]


def rescale_volume(vol: np.ndarray, in_spacing: float, out_spacing: float,
                   order: int) -> np.ndarray:
    """In-plane rescale of an (H, W, Z) volume to `out_spacing` mm."""
    ratio = float(in_spacing / out_spacing)
    if abs(ratio - 1.0) < 1e-6:
        return vol
    return ndimage.zoom(vol, (ratio, ratio, 1.0), order=order,
                        mode="constant", grid_mode=False, prefilter=False)


@dataclass
class Volume:
    name: str
    image: np.ndarray            # (H, W, Z) float32, post-rescale/crop
    label: Optional[np.ndarray]  # (H, W, Z) uint8 or None (test)
    orig_shape: Tuple[int, ...]  # pre-rescale shape
    post_scale_shape: Tuple[int, ...]  # post-rescale, pre-crop shape
    spacing: float               # original in-plane spacing (mm)


class ACDCDataset:
    """Train/val dataset over (patient, frame) pairs.

    Loads volumes, rescales in-plane to 1.25 mm, min-shifts each slice, and
    pad-center-crops to 256². Raw (un-normalised, un-augmented) slices are
    cached; normalisation and augmentation run on-device.
    """

    def __init__(self, root: str, split: str = "train",
                 series_file: Optional[str] = None, k: int = 5,
                 k_split: int = 1, target_size: int = TARGET_SIZE,
                 spacing: float = TRAIN_SPACING):
        self.root = root
        self.split = split
        self.target_size = target_size
        self.spacing = spacing
        self.train_dir = os.path.join(root, "training")

        if series_file and os.path.exists(series_file):
            series = read_series_file(series_file)
        else:
            series = scan_training_dir(self.train_dir)
        if not series:
            raise FileNotFoundError(
                f"No ACDC (patient, frame) pairs found under "
                f"{self.train_dir} and no series file given")
        self.series = kfold_split(series, split, k=k, k_split=k_split)

    def __len__(self):
        return len(self.series)

    def _paths(self, patient: int, frame: int) -> Tuple[str, str]:
        base = os.path.join(self.train_dir, f"patient{patient:03d}",
                            f"patient{patient:03d}_frame{frame:02d}")
        img = base + ".nii.gz"
        if not os.path.exists(img):
            img = base + ".nii"
        gt = base + "_gt.nii.gz"
        if not os.path.exists(gt):
            gt = base + "_gt.nii"
        return img, gt

    def load_volume(self, index: int) -> Volume:
        patient, frame = self.series[index]
        img_path, gt_path = self._paths(patient, frame)
        img_n = nifti_load(img_path)
        seg_n = nifti_load(gt_path)
        img = np.asarray(img_n.data, dtype=np.float32)
        seg = np.asarray(seg_n.data)
        pix_dim = float(img_n.pixdim[1])
        orig_shape = img.shape

        img = rescale_volume(img, pix_dim, self.spacing, order=1)
        seg = rescale_volume(seg.astype(np.uint8), pix_dim, self.spacing,
                             order=0)
        post_scale = img.shape

        ts = self.target_size
        img_c = np.zeros((ts, ts, img.shape[2]), np.float32)
        seg_c = np.zeros((ts, ts, img.shape[2]), np.uint8)
        for z in range(img.shape[2]):
            sl = img[:, :, z]
            if sl.min() > 0:  # min shift (ac17_dataloader.py:140-141)
                sl = sl - sl.min()
            img_c[:, :, z] = pad_center_crop(sl, ts)
            seg_c[:, :, z] = pad_center_crop(seg[:, :, z], ts)

        return Volume(
            name=f"patient{patient:03d}_frame{frame:02d}",
            image=img_c, label=seg_c, orig_shape=orig_shape,
            post_scale_shape=post_scale, spacing=pix_dim,
        )

    def load_slices(self, cache_dir: Optional[str] = None
                    ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """Flatten all volumes to per-slice arrays:
        (N, H, W) images, (N, H, W) labels, names.

        With `cache_dir`, the (deterministic) host preprocessing result is
        memoised on disk — the reference re-decodes and re-rescales every
        volume at every run startup (ac17_dataloader.py:182-189)."""
        if cache_dir:
            import hashlib
            key = hashlib.md5(repr(
                (sorted(self.series), self.target_size, self.spacing,
                 self.split)).encode()).hexdigest()[:16]
            path = os.path.join(cache_dir, f"acdc_slices_{key}.npz")
            if os.path.exists(path):
                z = np.load(path, allow_pickle=True)
                return z["images"], z["labels"], list(z["names"])
        imgs, labs, names = [], [], []
        for i in range(len(self)):
            v = self.load_volume(i)
            for z in range(v.image.shape[2]):
                imgs.append(v.image[:, :, z])
                labs.append(v.label[:, :, z])
                names.append(f"{v.name}_z{z}")
        images, labels = np.stack(imgs), np.stack(labs)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(path, images=images, labels=labels,
                     names=np.asarray(names, dtype=object))
        return images, labels, names


class ACDCTestDataset:
    """Test dataset: 1.5 mm rescale, test-path crop rounding, keeps the
    bookkeeping (orig / post_scale shapes) needed to repack predictions into
    the original geometry, and renames frames ED/ES
    (the reference's data/test_loader.py:85-88)."""

    def __init__(self, root: str, series_file: Optional[str] = None,
                 target_size: int = TARGET_SIZE,
                 spacing: float = TEST_SPACING):
        self.root = root
        self.target_size = target_size
        self.spacing = spacing
        self.test_dir = testing_dir(root)

        if series_file and os.path.exists(series_file):
            self.series = read_series_file(series_file)
        else:
            self.series = scan_testing_dir(self.test_dir)
        if not self.series:
            raise FileNotFoundError(f"No test volumes under {self.test_dir}")

    def __len__(self):
        return len(self.series)

    def load_volume(self, index: int) -> Volume:
        patient, frame = self.series[index]
        base = os.path.join(self.test_dir, f"patient{patient:03d}",
                            f"patient{patient:03d}_frame{frame:02d}")
        path = base + ".nii.gz"
        if not os.path.exists(path):
            path = base + ".nii"
        img_n = nifti_load(path)
        img = np.asarray(img_n.data, dtype=np.float32)
        pix_dim = float(img_n.pixdim[1])
        orig_shape = img.shape

        scaled = rescale_volume(img, pix_dim, self.spacing, order=1)
        post_scale = scaled.shape

        ts = self.target_size
        img_c = np.zeros((ts, ts, scaled.shape[2]), np.float32)
        for z in range(scaled.shape[2]):
            sl = scaled[:, :, z]
            if sl.min() > 0:
                sl = sl - sl.min()
            img_c[:, :, z] = pad_center_crop(sl, ts, round_up=True)

        # ED/ES naming: frame 01 is end-diastole
        tag = "ED" if frame == 1 else "ES"
        return Volume(
            name=f"patient{patient:03d}_{tag}",
            image=img_c, label=None, orig_shape=orig_shape,
            post_scale_shape=post_scale, spacing=pix_dim,
        )


def undo_crop(pred: np.ndarray, target_hw: Tuple[int, int],
              round_up: bool = True) -> np.ndarray:
    """Invert pad_center_crop: place a (S, S) prediction back into a
    (H, W) canvas (the reference's test_and_pack.py:31-60 semantics)."""
    s = pred.shape[0]
    h, w = target_hw

    def origin(extent):
        x = (extent - s) / 2.0
        if round_up:
            return int(x) + 1 if (x - int(x)) >= 0.5 else int(x)
        return int(round(x))

    out = np.zeros((h, w), dtype=pred.dtype)
    # crop the prediction if the target is smaller than the crop
    y0p = max(origin(h), 0) if h < s else 0
    x0p = max(origin(w), 0) if w < s else 0
    ph = min(h, s)
    pw = min(w, s)
    # paste location in the canvas
    y0 = max(origin(h), 0) if h >= s else 0
    x0 = max(origin(w), 0) if w >= s else 0
    # account for the pad offsets used during forward cropping
    if h < s:
        y0p = (s - h) // 2
    if w < s:
        x0p = (s - w) // 2
    out[y0:y0 + ph, x0:x0 + pw] = pred[y0p:y0p + ph, x0p:x0p + pw]
    return out


def resample_to_orig(pred_volume: np.ndarray, vol: Volume) -> np.ndarray:
    """Undo crop per slice, then nearest-resize back to the original volume
    shape (the reference's test_and_pack.py:62-76)."""
    ph, pw = vol.post_scale_shape[:2]
    stack = np.zeros(vol.post_scale_shape, dtype=pred_volume.dtype)
    for z in range(pred_volume.shape[2]):
        stack[:, :, z] = undo_crop(pred_volume[:, :, z], (ph, pw))
    zoom = [o / p for o, p in zip(vol.orig_shape, stack.shape)]
    out = ndimage.zoom(stack, zoom, order=0, mode="constant",
                       prefilter=False)
    assert out.shape == vol.orig_shape, (out.shape, vol.orig_shape)
    return out
