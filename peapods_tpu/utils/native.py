"""ctypes bindings for the native host helpers (``native/lattice_native.cc``).

The library is built from source at first use (``make -C native``, into a
process-private file that is renamed into place, so concurrent first users
never load a half-written library).  Every entry point has a pure-python
fallback, so the package works where no C++ compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "build_neighbor_tables", "greedy_color", "union_find_labels"]

_LIB = None
_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_NAME = "libpeapods_native.so"


def _build():
    """Compile the library into ``native/`` (atomic rename); True on success."""
    src = _NATIVE_DIR / "lattice_native.cc"
    if not src.exists():
        return False
    tmp = f".{_LIB_NAME}.{os.getpid()}"
    try:
        subprocess.run(
            ["make", "-s", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(_NATIVE_DIR / tmp, _NATIVE_DIR / _LIB_NAME)
    except (OSError, subprocess.SubprocessError):
        (_NATIVE_DIR / tmp).unlink(missing_ok=True)
        return False
    return True


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if os.environ.get("PEAPODS_NO_NATIVE") == "1":
        _LIB = False
        return _LIB
    path = _NATIVE_DIR / _LIB_NAME
    if not path.exists() and not _build():
        _LIB = False
        return _LIB
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _LIB = False
        return _LIB
    lib.build_neighbor_tables.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.greedy_color.restype = ctypes.c_int32
    lib.greedy_color.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.union_find_labels.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return bool(_load())


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_neighbor_tables(shape, offsets):
    """``(fwd, bwd)`` int32 ``[n_spins, n_neighbors]`` or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    shape = np.ascontiguousarray(shape, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_spins = int(np.prod(shape))
    n_nb = offsets.shape[0]
    fwd = np.empty((n_spins, n_nb), np.int32)
    bwd = np.empty((n_spins, n_nb), np.int32)
    lib.build_neighbor_tables(
        _ptr(shape, ctypes.c_int64),
        len(shape),
        _ptr(offsets, ctypes.c_int64),
        n_nb,
        _ptr(fwd, ctypes.c_int32),
        _ptr(bwd, ctypes.c_int32),
    )
    return fwd, bwd


def greedy_color(fwd, bwd):
    """``(colors int32 [n_spins], n_colors)`` or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    fwd = np.ascontiguousarray(fwd, dtype=np.int32)
    bwd = np.ascontiguousarray(bwd, dtype=np.int32)
    n_spins, n_nb = fwd.shape
    colors = np.empty(n_spins, np.int32)
    n_colors = lib.greedy_color(
        _ptr(fwd, ctypes.c_int32),
        _ptr(bwd, ctypes.c_int32),
        n_spins,
        n_nb,
        _ptr(colors, ctypes.c_int32),
    )
    return colors, int(n_colors)


def union_find_labels(active_fwd, fwd):
    """Min-index component labels, or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    active = np.ascontiguousarray(active_fwd, dtype=np.uint8)
    fwd = np.ascontiguousarray(fwd, dtype=np.int32)
    n_spins, n_nb = fwd.shape
    labels = np.empty(n_spins, np.int32)
    lib.union_find_labels(
        _ptr(active, ctypes.c_uint8),
        _ptr(fwd, ctypes.c_int32),
        n_spins,
        n_nb,
        _ptr(labels, ctypes.c_int32),
    )
    return labels
