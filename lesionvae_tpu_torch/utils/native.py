"""Build and load one of the repository's native host libraries (native/).

``load(target, bind)`` runs ``make -C native <target>`` (a no-op when the
library is fresh; it rebuilds when the C++ source changed, so a stale
binary never shadows edited source), loads the library with ctypes, lets
``bind`` declare its functions' argument and result types, and caches the
result, ``None`` included, for the process.  A host where the library
cannot be built or loaded gets ``None`` and a log line saying why: the
callers keep a Python route with the same results, a choice of host code,
not of device.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

from .logging import get_logger

log = get_logger("native")

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()   # loaders are called from reader thread pools


def load(target: str, bind: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    with _lock:
        if target not in _libs:
            _libs[target] = _build_and_load(target, bind)
        return _libs[target]


def _build_and_load(target: str, bind) -> Optional[ctypes.CDLL]:
    path = NATIVE_DIR / target
    try:
        subprocess.run(["make", "-C", str(NATIVE_DIR), target], check=True,
                       capture_output=True, timeout=120)
    except Exception as e:
        if not path.exists():
            log.info("native %s unavailable (%s)", target, e)
            return None
        log.warning("make %s failed (%s); loading the existing library", target, e)
    try:
        lib = ctypes.CDLL(str(path))
        bind(lib)
    except (OSError, AttributeError) as e:
        log.info("could not load %s: %s", path, e)
        return None
    log.info("native library loaded: %s", path)
    return lib
