"""Host data path: NIfTI codec, ACDC datasets and geometry (numpy/scipy,
copied from saunet_tpu/data) and the eval normalisation (torch)."""
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
from .augment import normalize_for_eval
from .nifti import NiftiImage, load, save

__all__ = ["ACDCDataset", "ACDCTestDataset", "NiftiImage", "Volume",
           "kfold_split", "load", "nifti", "normalize_for_eval",
           "pad_center_crop", "read_series_file", "resample_to_orig", "save",
           "undo_crop"]
