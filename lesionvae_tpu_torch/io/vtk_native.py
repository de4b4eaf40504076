"""ctypes bindings for the repository's native C++ VTK parser
(native/vtk_parser.cpp), loaded by the port itself.

Host parsing is the geometry stage's read cost; the native parser replaces
the Python tokenizer.  ``make -C native`` runs at first use (the Makefile
makes it a no-op when the library is fresh) and ``io.vtk`` keeps its Python
parser for hosts where the library cannot be built or loaded: this is a
choice of host parser, not of device.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("vtk_native")

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libvtkparser.so"
_lib = None
_tried = False
_lock = threading.Lock()   # the cohort reader calls in from a thread pool


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        return _build_and_load()


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib
    # Always invoke make: the Makefile's dependency check makes this a no-op
    # when the .so is fresh, and it rebuilds when vtk_parser.cpp changed —
    # a stale binary must never shadow edited source.  The .so is build
    # output, not versioned (see .gitignore).
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
    except Exception as e:
        if not _LIB_PATH.exists():
            log.info("native VTK parser unavailable (%s); using Python parser", e)
            return None
        log.warning("make failed (%s); loading existing %s", e, _LIB_PATH)
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        log.info("could not load %s: %s", _LIB_PATH, e)
        return None
    lib.vtk_parse.restype = ctypes.c_void_p
    lib.vtk_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vtk_error.restype = ctypes.c_char_p
    lib.vtk_error.argtypes = [ctypes.c_void_p]
    for fn in ("vtk_n_points", "vtk_n_cells", "vtk_n_conn"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.vtk_points.restype = ctypes.POINTER(ctypes.c_double)
    lib.vtk_points.argtypes = [ctypes.c_void_p]
    lib.vtk_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.vtk_offsets.argtypes = [ctypes.c_void_p]
    lib.vtk_connectivity.restype = ctypes.POINTER(ctypes.c_int64)
    lib.vtk_connectivity.argtypes = [ctypes.c_void_p]
    lib.vtk_free.restype = None
    lib.vtk_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    log.info("native VTK parser loaded: %s", _LIB_PATH)
    return _lib


def available() -> bool:
    return _load() is not None


def parse_polydata(data: bytes
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a (decompressed) legacy VTK buffer via the native library.

    Returns (points, offsets, connectivity) like vtk.read_vtk_polydata, or
    None when the native library is unavailable.  Raises ValueError on parse
    errors (same contract as the Python parser)."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.vtk_parse(data, len(data))
    try:
        err = lib.vtk_error(handle)
        if err:
            raise ValueError(f"native VTK parse error: {err.decode()}")
        n_pts = lib.vtk_n_points(handle)
        n_cells = lib.vtk_n_cells(handle)
        n_conn = lib.vtk_n_conn(handle)
        points = (np.ctypeslib.as_array(lib.vtk_points(handle),
                                        shape=(n_pts, 3)).copy()
                  if n_pts else np.empty((0, 3)))
        offsets = np.ctypeslib.as_array(
            lib.vtk_offsets(handle), shape=(n_cells + 1,)).copy()
        connectivity = (np.ctypeslib.as_array(lib.vtk_connectivity(handle),
                                              shape=(n_conn,)).copy()
                        if n_conn else np.empty(0, np.int64))
        return points, offsets, connectivity
    finally:
        lib.vtk_free(handle)
