"""Native host-side components (C++), bound via ctypes.

The compute path is JAX/XLA/Pallas on the device; these are the host runtime
pieces where Python is the bottleneck — currently the multithreaded numeric
CSV parser (``fastcsv``) used by :mod:`bulklmm_tpu.io` for genotype /
phenotype matrices (the reference gets this from Julia's compiled
DelimitedFiles/CSV stack, reference src/readData.jl).

The shared library is compiled on first use with g++ into the package
directory and cached; import never fails — callers check
``fastcsv_available()`` and fall back to the pure-Python parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "fastcsv.cpp"
_LIB = _HERE / "libfastcsv.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    # Build to a per-process temp name and rename into place: concurrent
    # processes (pytest-xdist, parallel CLI runs) must never CDLL a
    # half-written library, and rename() within one directory is atomic.
    tmp = _LIB.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode == 0 and tmp.is_file():
            os.replace(tmp, _LIB)
            return _LIB.is_file()
        return False
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        needs_build = not _LIB.is_file() or (
            _SRC.is_file() and _LIB.stat().st_mtime < _SRC.stat().st_mtime
        )
        if needs_build and (not _SRC.is_file() or not _compile()):
            # keep the contract: availability checks never raise; a stale
            # prebuilt library (source not shipped) is still usable
            if not _LIB.is_file():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        lib.fastcsv_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.fastcsv_dims.restype = ctypes.c_int
        lib.fastcsv_read.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_long,
        ]
        lib.fastcsv_read.restype = ctypes.c_int
        _lib = lib
        return _lib


def fastcsv_available() -> bool:
    return _load() is not None


def read_numeric_csv(
    path,
    *,
    delim: str = ",",
    skip_rows: int = 0,
    skip_cols_left: int = 0,
    skip_cols_right: int = 0,
) -> np.ndarray:
    """Parse a numeric CSV into a float64 matrix with the native parser.

    Skips ``skip_rows`` header lines and the given number of leading/trailing
    columns (id / sex columns). Non-numeric cells become NaN. Raises
    ``RuntimeError`` if the native library is unavailable — callers should
    gate on :func:`fastcsv_available`.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastcsv library unavailable")
    p = str(path).encode()
    d = delim.encode()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    if lib.fastcsv_dims(p, d, skip_rows, ctypes.byref(rows), ctypes.byref(cols)):
        raise OSError(f"cannot read {path}")
    out_cols = cols.value - skip_cols_left - skip_cols_right
    if rows.value <= 0 or out_cols <= 0:
        return np.empty((max(rows.value, 0), max(out_cols, 0)), dtype=np.float64)
    out = np.empty((rows.value, out_cols), dtype=np.float64)
    rc = lib.fastcsv_read(
        p, d, skip_rows, skip_cols_left, skip_cols_right,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.value, out_cols,
    )
    if rc:
        raise OSError(f"fastcsv_read failed on {path} (rc={rc})")
    return out


def dims(path, *, delim: str = ",", skip_rows: int = 0) -> Tuple[int, int]:
    """(rows, cols) of the numeric block after header skipping."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastcsv library unavailable")
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    if lib.fastcsv_dims(str(path).encode(), delim.encode(), skip_rows,
                        ctypes.byref(rows), ctypes.byref(cols)):
        raise OSError(f"cannot read {path}")
    return rows.value, cols.value
