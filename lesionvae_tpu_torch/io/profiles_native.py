"""ctypes bindings for the repository's native tract-profile CSV reader
(native/csv_parser.cpp), loaded by the port itself: the port of
lesionvae_tpu/io/profiles_native.py.

The reader knows the profile CSV's fixed schema (one tract_id string column
and float columns, tract values in contiguous runs) and returns what a
tensor builder needs: a float32 column matrix and the tract runs, with no
per-row string objects; its float parse is pandas' float64 parse cast to
float32, bit for bit.  ``make -C native libcsvparser.so`` runs at first use
(``utils.native``); ``available()`` says whether it could be built and
loaded, and callers keep pandas for hosts where it cannot: a choice of host
reader, not of device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import native


def _bind(lib: ctypes.CDLL) -> None:
    lib.csvp_parse.restype = ctypes.c_void_p
    lib.csvp_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int32, ctypes.c_int32]
    lib.csvp_error.restype = ctypes.c_char_p
    lib.csvp_error.argtypes = [ctypes.c_void_p]
    lib.csvp_n_rows.restype = ctypes.c_int64
    lib.csvp_n_rows.argtypes = [ctypes.c_void_p]
    lib.csvp_n_runs.restype = ctypes.c_int32
    lib.csvp_n_runs.argtypes = [ctypes.c_void_p]
    lib.csvp_values.restype = ctypes.POINTER(ctypes.c_float)
    lib.csvp_values.argtypes = [ctypes.c_void_p]
    lib.csvp_run_starts.restype = ctypes.POINTER(ctypes.c_int64)
    lib.csvp_run_starts.argtypes = [ctypes.c_void_p]
    lib.csvp_run_names.restype = ctypes.c_void_p  # raw: may contain NULs
    lib.csvp_run_names.argtypes = [ctypes.c_void_p]
    lib.csvp_free.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    return native.load("libcsvparser.so", _bind)


def available() -> bool:
    return _load() is not None


def read_profile_columns(path: str | Path, columns: Sequence[str],
                         tract_column: str = "tract_id"
                         ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             List[str], np.ndarray]]:
    """Read ``columns`` (floats) + tract run boundaries from a profile CSV.

    Returns ``(values, run_starts, run_names, present)`` where ``values``
    is (n_rows, len(columns)) float32 — columns absent from the file are
    NaN and flagged False in the ``present`` bool array — ``run_starts``
    the first row of each contiguous tract run, and ``run_names`` the
    tract per run.  Returns None when the native library is unavailable;
    raises ValueError on malformed input.
    """
    lib = _load()
    if lib is None:
        return None
    data = Path(path).read_bytes()
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError(f"{path}: empty CSV")
    header = data[:nl].decode("utf-8", "replace").rstrip("\r").split(",")
    col_idx = {c: i for i, c in enumerate(header)}
    if tract_column not in col_idx:
        raise ValueError(f"{path}: no {tract_column} column")
    # map wanted names -> field index; absent columns keep NaN output.
    # csvp_parse needs >= 1 wanted field; point absentees at the tract
    # column (string -> NaN) so the slot exists
    want = np.asarray([col_idx.get(c, col_idx[tract_column])
                       for c in columns], np.int32)
    absent = [i for i, c in enumerate(columns) if c not in col_idx]
    h = lib.csvp_parse(data, len(data),
                       want.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       len(want), col_idx[tract_column])
    if not h:
        raise MemoryError("csvp_parse allocation failed")
    try:
        err = lib.csvp_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n_rows = lib.csvp_n_rows(h)
        n_runs = lib.csvp_n_runs(h)
        vals = np.ctypeslib.as_array(lib.csvp_values(h),
                                     shape=(n_rows, len(want))).copy()
        starts = np.ctypeslib.as_array(lib.csvp_run_starts(h),
                                       shape=(n_runs,)).copy()
        # names are NUL-joined; string_at stops at the FIRST NUL, so walk
        # the buffer run by run
        names: List[str] = []
        ptr = lib.csvp_run_names(h)
        off = 0
        for _ in range(n_runs):
            s = ctypes.string_at(ptr + off)
            names.append(s.decode("utf-8", "replace"))
            off += len(s) + 1
        present = np.ones(len(columns), bool)
        if absent:
            vals[:, absent] = np.nan
            present[absent] = False
        return vals, starts, names, present
    finally:
        lib.csvp_free(h)
