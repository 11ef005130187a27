"""Minimal NIfTI-1 reader/writer in pure numpy (+gzip).

The reference reads ACDC volumes with nibabel
(the reference's data/ac17_dataloader.py:110-112, data/test_loader.py:49-51)
and writes predictions with `nib.Nifti1Image(pred, np.eye(4))`
(the reference's test_and_pack.py:93-96). nibabel is not a dependency, so
the framework carries its own NIfTI-1 codec: the 348-byte header fields the
pipeline needs (dim, datatype, pixdim, vox_offset, scl_slope/inter, magic),
both endiannesses, and .nii / .nii.gz containers.
"""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclass
class NiftiImage:
    data: np.ndarray
    pixdim: np.ndarray = field(
        default_factory=lambda: np.ones(8, dtype=np.float32))
    affine: Optional[np.ndarray] = None

    @property
    def zooms(self) -> np.ndarray:
        """Voxel sizes for the data's dimensions (pixdim[1:1+ndim])."""
        return self.pixdim[1:1 + self.data.ndim]


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: str) -> NiftiImage:
    """Read a .nii / .nii.gz volume. Applies scl_slope/scl_inter if set."""
    with _open(path, "rb") as f:
        raw = f.read()
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != HEADER_SIZE:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        endian = ">"
        if sizeof_hdr != HEADER_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    pixdim = np.array(struct.unpack_from(endian + "8f", raw, 76),
                      dtype=np.float32)
    vox_offset = struct.unpack_from(endian + "f", raw, 108)[0]
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    offset = int(vox_offset) if vox_offset else HEADER_SIZE + 4
    arr = np.frombuffer(raw, dtype=dt, count=count, offset=offset)
    # NIfTI data is Fortran-ordered (x fastest)
    arr = arr.reshape(shape[::-1]).T

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr.astype(np.float32) * slope + scl_inter

    return NiftiImage(data=np.ascontiguousarray(arr), pixdim=pixdim)


def save(img_or_array, path: str, pixdim=None) -> None:
    """Write a .nii / .nii.gz volume (identity orientation, like the
    reference's `save_as_nifti`)."""
    if isinstance(img_or_array, NiftiImage):
        data = img_or_array.data
        pd = img_or_array.pixdim
    else:
        data = np.asarray(img_or_array)
        pd = np.ones(8, dtype=np.float32)
    if pixdim is not None:
        pd = np.ones(8, dtype=np.float32)
        pd[1:1 + len(pixdim)] = pixdim

    dt = np.dtype(data.dtype)
    if dt not in _DTYPE_CODES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    code = _DTYPE_CODES[dt]

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, dt.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    # sform/qform codes 0 -> orientation from pixdim only (identity affine)
    hdr[344:348] = b"n+1\x00"

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
