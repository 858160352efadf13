"""ctypes bridge to the native CSV parser (native/vqio.cc).

Builds the shared library from the committed source on first use, into
native/ (gitignored), if g++ is available; raises ImportError otherwise
(no compiler, read-only checkout) so csvio falls back to the pure-Python
parser."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "vqio.cc")
_LIB = os.path.join(_REPO_ROOT, "native", "libvqio.so")
_lock = threading.Lock()
_lib = None
_failed = False  # a failed build/load is cached: fall back to Python once,
                 # not once per CSV file


def _build(lib_path: str) -> None:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread", _SRC, "-o", lib_path],
        check=True, capture_output=True,
    )


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed:
            raise ImportError("libvqio build previously failed")
        try:
            lib_path = _try_build()
            lib = ctypes.CDLL(lib_path)
        except Exception as exc:
            _failed = True
            raise ImportError(f"cannot build/load libvqio: {exc}") from exc
        lib.vqio_parse.restype = ctypes.c_void_p
        lib.vqio_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.vqio_error.restype = ctypes.c_char_p
        lib.vqio_error.argtypes = [ctypes.c_void_p]
        lib.vqio_header.restype = ctypes.c_char_p
        lib.vqio_header.argtypes = [ctypes.c_void_p]
        for name in ("vqio_rows", "vqio_dim"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.vqio_clips.restype = ctypes.POINTER(ctypes.c_int64)
        lib.vqio_clips.argtypes = [ctypes.c_void_p]
        lib.vqio_values.restype = ctypes.POINTER(ctypes.c_double)
        lib.vqio_values.argtypes = [ctypes.c_void_p]
        lib.vqio_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _try_build() -> str:
    if not os.path.exists(_SRC):
        raise ImportError("native/vqio.cc not found")
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    try:
        _build(_LIB)
    except (OSError, subprocess.CalledProcessError) as exc:
        raise ImportError(f"{_LIB}: {exc}") from exc
    return _LIB


def parse(path: str, n_threads: int | None = None):
    """Returns (header_fields, clips i64[N], values f64[N, D]) or None on a
    parse the native code can't handle (caller falls back to Python)."""
    lib = _load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    handle = lib.vqio_parse(path.encode(), n_threads)
    if not handle:
        return None
    try:
        err = lib.vqio_error(handle)
        if err:
            return None
        n = lib.vqio_rows(handle)
        d = lib.vqio_dim(handle)
        header = lib.vqio_header(handle).decode("utf-8", "replace").split(",")
        clips = np.ctypeslib.as_array(lib.vqio_clips(handle), (n,)).copy()
        values = np.ctypeslib.as_array(lib.vqio_values(handle), (n, d)).copy()
        return header, clips, values
    finally:
        lib.vqio_free(handle)
