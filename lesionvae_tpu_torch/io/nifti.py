"""Minimal pure-numpy NIfTI-1 reader/writer.

Replaces the reference's nibabel dependency (reference:
src/lesion/lesion_sh_heme_comprehensive.py:361 ``nib.load``, :374
``nib.affines.apply_affine``).  Supports the subset the pipeline needs:
single-file ``.nii`` / ``.nii.gz``, common datatypes, sform/qform/pixdim
affines, and scl_slope/scl_inter scaling — the same semantics as nibabel's
``get_fdata`` for these files.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


class NiftiImage:
    """A loaded NIfTI volume: ``data`` (numpy array) + ``affine`` (4, 4)."""

    def __init__(self, data: np.ndarray, affine: np.ndarray):
        self.data = data
        self.affine = np.asarray(affine, dtype=np.float64)

    def get_fdata(self) -> np.ndarray:
        return self.data.astype(np.float64)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    def voxel_volume(self) -> float:
        """|det| of the 3x3 affine block — matches the reference's voxel-volume
        computation (lesion_sh_heme_comprehensive.py:89,235)."""
        return float(abs(np.linalg.det(self.affine[:3, :3])))


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] == -1.0 else 1.0
    R = R * np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def load(path: str | Path) -> NiftiImage:
    path = Path(path)
    raw = path.read_bytes()
    if path.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<" if sizeof_hdr == 348 else ">"
    if struct.unpack_from(endian + "i", raw, 0)[0] != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    vox_offset = struct.unpack_from(endian + "f", raw, 108)[0]
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    quats = struct.unpack_from(endian + "6f", raw, 256)
    srow = np.array(struct.unpack_from(endian + "12f", raw, 280),
                    dtype=np.float64).reshape(3, 4)
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + max(ndim, 1)])
    np_dtype = _NIFTI_DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")

    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder(endian),
                         count=count, offset=int(vox_offset))
    data = data.reshape(shape, order="F").astype(np.float64, copy=True)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        hdr = dict(pixdim=pixdim, quatern_b=quats[0], quatern_c=quats[1],
                   quatern_d=quats[2], qoffset_x=quats[3], qoffset_y=quats[4],
                   qoffset_z=quats[5])
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return NiftiImage(data, affine)


def save(path: str | Path, data: np.ndarray,
         affine: Optional[np.ndarray] = None) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz) with an sform affine."""
    path = Path(path)
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    dtype_code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)  # 348-byte header + 4 pad bytes; vox_offset = 352
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, dtype_code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * (7 - 3)))
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code = SCANNER_ANAT
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine[:3, :], dtype=np.float64).ravel())
    hdr[344:348] = b"n+1\x00"

    body = bytes(hdr) + data.ravel(order="F").tobytes()
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz":
        with open(path, "wb") as f:
            f.write(gzip.compress(body, mtime=0))
    else:
        path.write_bytes(body)


def apply_affine(affine: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Voxel → world coordinates; drop-in for ``nib.affines.apply_affine``
    (reference call sites: lesion_sh_heme_comprehensive.py:122,138,374)."""
    coords = np.asarray(coords, dtype=np.float64)
    return coords @ affine[:3, :3].T + affine[:3, 3]
