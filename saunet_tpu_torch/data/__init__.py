"""Data path: NIfTI codec, ACDC datasets and geometry and the synthetic
phantoms (numpy/scipy, copied from saunet_tpu/data), the prefetching
loader, and the training augmentation and eval normalisation on the device
(torch)."""
from . import nifti
from .acdc import (
    ACDCDataset,
    ACDCTestDataset,
    Volume,
    kfold_split,
    pad_center_crop,
    read_series_file,
    resample_to_orig,
    undo_crop,
)
from .augment import edge_ground_truth, make_augment_fn, normalize_for_eval
from .loader import ArrayDataLoader, RandomSampler, to_device
from .nifti import NiftiImage, load, save
from .phantom import make_phantom, make_phantom_set

__all__ = ["ACDCDataset", "ACDCTestDataset", "ArrayDataLoader", "NiftiImage",
           "RandomSampler", "Volume", "edge_ground_truth", "kfold_split",
           "load", "make_augment_fn", "make_phantom",
           "make_phantom_set", "nifti", "normalize_for_eval",
           "pad_center_crop", "read_series_file", "resample_to_orig", "save",
           "to_device", "undo_crop"]
