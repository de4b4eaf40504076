"""u16 delta codec for the geometry point upload (opt-in, ``upload="u16d"``).

Each streamline crosses to the card as its exact float32 first point and
uint16 forward-difference codes with a per-(streamline, axis) affine range:
6 bytes a padded point instead of 12, plus 36 a streamline.  The JAX
package's probe of this codec (its ``ops/geo_codec.py`` docstring) read the
decoded metrics within p99 3e-4 of the float32 upload for every column but
torsion, whose ratio tau = (b.db)/|b|^2 amplifies the decode noise without
bound as |b| -> 0.  So torsion comes from the host: ``torsion_f64``
evaluates the reference formula (tract_geom_proc.py:85-96) in float64 on
the original float32 points, and the pipeline overwrites the device's
torsion column with it.

Host side: ``encode_u16_delta`` and ``torsion_f64`` call the repository's
native library (native/geo_codec.cpp, built with ``make`` on first use) and
keep numpy routes with the same results for hosts without it.  Device side:
``decode_points`` is the plain PyTorch decode; the geometry kernel's u16
mode (ops/csrc/geometry.cu) decodes the same way in registers.  The codes
cross to the card as int16 bit patterns (PyTorch has no arithmetic on
uint16) and are read back as unsigned.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..utils.logging import get_logger

log = get_logger("geo_codec")

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgeocodec.so"
_lib = None
_lib_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            if not _LIB_PATH.exists():
                subprocess.run(["make", "-C", str(_NATIVE_DIR), "libgeocodec.so"],
                               check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(str(_LIB_PATH))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.geo_encode_u16.restype = ctypes.c_int
            lib.geo_encode_u16.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, i32p,
                ctypes.POINTER(ctypes.c_uint16), f32p, f32p, f32p]
            lib.geo_torsion_f64.restype = ctypes.c_int
            lib.geo_torsion_f64.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, i32p,
                ctypes.POINTER(ctypes.c_double)]
            _lib = lib
        except Exception as e:  # no toolchain: the numpy routes below
            log.info("native geo codec unavailable (%s); using numpy", e)
        return _lib


def encode_u16_delta(pts: np.ndarray, lens: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(S, P, 3) float32 points -> (codes uint16 (S, P-1, 3), p0, lo, sc
    float32 (S, 3)).  Codes beyond a streamline's ``lens - 1`` deltas are 0."""
    pts = np.ascontiguousarray(pts, np.float32)
    lens32 = np.ascontiguousarray(lens, np.int32)
    S, P, _ = pts.shape
    lib = _load()
    if lib is not None:
        codes = np.empty((S, P - 1, 3), np.uint16)
        p0 = np.empty((S, 3), np.float32)
        lo = np.empty((S, 3), np.float32)
        sc = np.empty((S, 3), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        rc = lib.geo_encode_u16(
            pts.ctypes.data_as(f32p), S, P,
            lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            p0.ctypes.data_as(f32p), lo.ctypes.data_as(f32p),
            sc.ctypes.data_as(f32p))
        if rc == 0:
            return codes, p0, lo, sc
    d = np.diff(pts, axis=1)
    seg = np.arange(P - 1)[None, :] < (lens32[:, None] - 1)
    dm = np.where(seg[..., None], d, np.nan)
    with np.errstate(all="ignore"):
        lo = np.nan_to_num(np.nanmin(dm, axis=1), nan=0.0)
        hi = np.nan_to_num(np.nanmax(dm, axis=1), nan=0.0)
    sc = (hi - lo) / np.float32(65535.0)
    sc = np.where(sc > 0, sc, 1.0).astype(np.float32)
    codes = np.clip(np.rint((d - lo[:, None, :]) / sc[:, None, :]),
                    0, 65535).astype(np.uint16)
    codes[~seg] = 0
    return codes, pts[:, 0].copy(), lo.astype(np.float32), sc


def torsion_f64(pts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The reference's ``torsion_mean`` a streamline in float64
    (tract_geom_proc.py:85-96) from the original float32 points; 0 for
    fewer than 4 points."""
    pts = np.ascontiguousarray(pts, np.float32)
    lens32 = np.ascontiguousarray(lens, np.int32)
    S, P, _ = pts.shape
    lib = _load()
    if lib is not None:
        out = np.empty(S, np.float64)
        rc = lib.geo_torsion_f64(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), S, P,
            lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc == 0:
            return out
    out = np.zeros(S, np.float64)
    for s in range(S):
        n = int(lens32[s])
        if n < 4:
            continue
        x = pts[s, :n].astype(np.float64)
        v = np.gradient(x, axis=0)
        a = np.gradient(v, axis=0)
        b = np.cross(v, a)
        db = np.gradient(b, axis=0)
        tau = np.einsum("ij,ij->i", b, db) / (
            np.einsum("ij,ij->i", b, b) + 1e-12)
        tau = tau[np.isfinite(tau)]
        out[s] = tau.mean() if tau.size else 0.0
    return out


def decode_points(codes: torch.Tensor, p0: torch.Tensor, lo: torch.Tensor,
                  sc: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(S, P, 3) float32 points from the codes (int16 bit patterns of the
    uint16 codes, (S, P-1, 3)), p0, lo, sc (S, 3) and lengths (S,):

        d_j = lo + code_j * sc  (0 for j >= length - 1)
        x_0 = p0,  x_{j+1} = p0 + (d_0 + ... + d_j)

    The running sum is taken in order, one float32 rounding a step, as the
    kernel's decode takes it.  Pad deltas are 0, so pad points repeat the
    last real point."""
    S, PD, _ = codes.shape
    c = (codes.to(torch.int32) & 0xFFFF).to(torch.float32)
    d = lo[:, None, :] + c * sc[:, None, :]
    seg = (torch.arange(PD, device=codes.device)[None, :]
           < (lengths.to(torch.int64) - 1)[:, None])
    d = torch.where(seg[..., None], d, torch.zeros((), dtype=d.dtype, device=d.device))
    rows = [p0]
    run = None
    for j in range(PD):
        run = d[:, j] if run is None else run + d[:, j]
        rows.append(p0 + run)
    return torch.stack(rows, dim=1)
