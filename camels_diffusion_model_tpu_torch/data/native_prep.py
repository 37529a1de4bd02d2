"""ctypes bindings of the repository's C++ host-prep library
(counterpart of ``camels_diffusion_model_tpu/data/native_prep.py``).

``native/camels_prep.cpp`` holds multithreaded fused versions of the
``"code"`` map normalisation and of the torch-semantics bilinear resize.
The first call compiles it with the recipe of ``native/Makefile`` --
``$CXX`` (default ``g++``) ``-O3 -fPIC -std=c++17 -pthread -Wall -shared``
-- into ``build/native_prep/<hash of source and flags>/libcamels_prep.so``
at the repository root, written atomically, and never writes under
``native/``.  ``CAMELS_NO_NATIVE=1`` skips the build when no library is
built yet, as in the JAX package (``native_prep.py:42``).  Where none can
be built, :func:`available` is False and the numpy path of
``data.pipeline`` runs.

The functions and their C signatures are the JAX package's
(``native_prep.py:55-113``), so both packages prepare the same maps bit for
bit from the same library build recipe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "camels_prep.cpp"
BUILD_ROOT = ROOT / "build" / "native_prep"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall")  # native/Makefile:2
LIB_NAME = "libcamels_prep.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of this source with this compiler and these flags
    lives."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join((cxx,) + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``native/camels_prep.cpp`` in place into
    :func:`library_path` unless it is there; returns that path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                if os.environ.get("CAMELS_NO_NATIVE") == "1":
                    return None
                path = build()
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.camels_minmax.argtypes = [f32p, ctypes.c_int64, f32p, f32p]
        lib.camels_normalize.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ]
        lib.camels_resize_bilinear.argtypes = [
            f32p, f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (or could be built now) and loads."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native prep library is not available")
    return lib


def minmax_native(data: np.ndarray):
    """``(min, max)`` of a float32 array in one multithreaded pass."""
    lib = _require()
    data = np.ascontiguousarray(data, np.float32)
    lo, hi = ctypes.c_float(), ctypes.c_float()
    lib.camels_minmax(_ptr(data), data.size, ctypes.byref(lo), ctypes.byref(hi))
    return float(lo.value), float(hi.value)


def normalize_maps_native(raw: np.ndarray) -> np.ndarray:
    """The ``"code"`` normalisation (shift positive, divide by the maximum,
    log10, min-max to [0, 1]) fused in C++; float32 output."""
    lib = _require()
    data = np.ascontiguousarray(raw, np.float32)
    lo, hi = minmax_native(data)
    shift = (-lo + 1e-8) if lo <= 0 else 0.0
    out = np.empty_like(data)
    lib.camels_normalize(_ptr(data), _ptr(out), data.size, shift, hi + shift)
    return out


def resize_maps_native(maps: np.ndarray, size: int) -> np.ndarray:
    """Bilinear (torch ``align_corners=False``) resize of a ``(B, H, W)``
    stack to ``size`` x ``size``."""
    lib = _require()
    maps = np.ascontiguousarray(maps, np.float32)
    b, h, w = maps.shape
    out = np.empty((b, size, size), np.float32)
    lib.camels_resize_bilinear(_ptr(maps), _ptr(out), b, h, w, size, size)
    return out
