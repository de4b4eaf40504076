"""uint16 fixed-point upload of the fleet's raw tensors (opt-in): the port of
lesionvae_tpu/train/quantize.py (its native and numpy encoders, :42-143,
and the decoder, :146-155).

The raw blocks feed the on-device normalization
(``train.data.normalize_on_device``), whose output is z-scored and clamped,
so the upload needs only enough precision to keep z-scores stable: a code
per (member, feature) range gives 65533 levels and halves the bytes that
cross to the card.

Encoding: code = floor((x - lo) / scale + 0.5) with lo and hi over the
finite values of the member's feature; non-finite values take reserved
codes, so that the median-imputation on the device sees them as it would
in float32:

    0xFFFF -> NaN   0xFFFE -> +inf   0xFFFD -> -inf   values <= 0xFFFC

The host encoder is the repository's native one (native/quantize.cpp, one
min/max pass and one code pass a (member, feature), built with ``make`` at
first use) where it builds, else the numpy one: the two give the same
codes, bit for bit.  This is a choice of host encoder, not of device.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import native

SENT_NAN = 0xFFFF
SENT_PINF = 0xFFFE
SENT_NINF = 0xFFFD
MAX_CODE = 0xFFFC


def _codes(X: np.ndarray, lo: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Round-half-up codes of values in [lo, hi]; scale 0 (a constant or
    empty feature) codes to 0."""
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0),
                   0.0).astype(np.float32)
    codes = ((X - lo) * inv + np.float32(0.5)).astype(np.uint16)
    np.minimum(codes, np.uint16(MAX_CODE), out=codes)  # float edge guard
    return codes


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.quant_u16.restype = ctypes.c_int
    lib.quant_u16.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16),
                              f32p, f32p]


def _load() -> Optional[ctypes.CDLL]:
    """The native encoder's library, or None where it cannot be built."""
    return native.load("libquantize.so", _bind)


def _quantize_native(X: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``quantize_u16`` by the native encoder; None where the library is
    missing or refuses the block (more than 256 features)."""
    lib = _load()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, np.float32)
    T, n, L, C = X.shape
    codes = np.empty((T, n, L, C), np.uint16)
    lo = np.empty((T, C), np.float32)
    scale = np.empty((T, C), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.quant_u16(X.ctypes.data_as(f32p), T, n, L, C,
                       codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                       lo.ctypes.data_as(f32p), scale.ctypes.data_as(f32p))
    if rc != 0:
        return None
    return codes, lo.reshape(T, 1, 1, C), scale.reshape(T, 1, 1, C)


def encoder() -> str:
    """Which host encoder ``quantize_u16`` uses here: "native" or "numpy"."""
    return "native" if _load() is not None else "numpy"


def quantize_u16(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A (T, n, L, C) float32 block -> (codes (T, n, L, C) uint16,
    lo (T, 1, 1, C) float32, scale (T, 1, 1, C) float32), with the range of
    each (member, feature) taken over its finite values.  Constant and
    all-non-finite features get scale 0 (their codes decode to lo).  The
    native encoder where it builds, else ``quantize_u16_numpy``."""
    out = _quantize_native(X)
    return out if out is not None else quantize_u16_numpy(X)


def quantize_u16_numpy(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``quantize_u16`` in numpy (lesionvae_tpu/train/quantize.py:104-143)."""
    X = np.asarray(X, np.float32)
    lo = np.min(X, axis=(1, 2), keepdims=True)
    hi = np.max(X, axis=(1, 2), keepdims=True)
    if np.isfinite(lo).all() and np.isfinite(hi).all():
        # every value finite (min and max pass a non-finite one on)
        scale = ((hi - lo) / MAX_CODE).astype(np.float32)
        return _codes(X, lo, scale), lo.astype(np.float32), scale
    # the range over the finite values only (filling with zero first would
    # widen it to include 0), then the reserved codes where they belong
    fin = np.isfinite(X)
    masked = np.where(fin, X, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN features
        lo = np.nanmin(masked, axis=(1, 2), keepdims=True)
        hi = np.nanmax(masked, axis=(1, 2), keepdims=True)
    lo = np.nan_to_num(lo, nan=0.0).astype(np.float32)
    hi = np.nan_to_num(hi, nan=0.0).astype(np.float32)
    scale = ((hi - lo) / MAX_CODE).astype(np.float32)
    codes = _codes(np.where(fin, X, lo), lo, scale)
    bad = np.nonzero(~fin)
    vals = X[bad]
    codes[bad] = np.where(np.isnan(vals), np.uint16(SENT_NAN),
                          np.where(vals > 0, np.uint16(SENT_PINF),
                                   np.uint16(SENT_NINF)))
    return codes, lo, scale


def codes_to_tensor(codes: np.ndarray, device) -> torch.Tensor:
    """The uint16 codes on ``device`` as int16 bit patterns: two bytes a
    value cross to the card, and ``dequantize_u16`` reads them unsigned."""
    return torch.from_numpy(np.ascontiguousarray(codes).view(np.int16)).to(device)


def dequantize_u16(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    """The inverse on the device: int16 bit patterns of the codes (or any
    integer tensor of their values) with lo and scale broadcastable to them
    -> float32 with NaN and ±inf restored."""
    c = codes.to(torch.int32) & 0xFFFF
    x = lo + c.to(torch.float32) * scale
    x = torch.where(c == SENT_NAN, x.new_full((), float("nan")), x)
    x = torch.where(c == SENT_PINF, x.new_full((), float("inf")), x)
    return torch.where(c == SENT_NINF, x.new_full((), float("-inf")), x)
