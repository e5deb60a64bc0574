"""Loader for the first-party native (C++) helper library (the port's own
copy of ``metaasr_tpu/utils/native.py``; it loads the same
``native/libmetaasr_native.so``).

Builds ``native/libmetaasr_native.so`` on first use (g++ via make) and loads
it with ctypes. Every native entry point has a pure-Python fallback so the
framework works even without a toolchain; the native path is used when
available (it is ~50-100x faster for WER scoring on long hypothesis lists).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmetaasr_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def get_native_lib():
    """Return the loaded ctypes library, building it if needed, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            lib.metaasr_edit_distance.restype = ctypes.c_int64
            lib.metaasr_edit_distance.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
            ]
            lib.metaasr_edit_distance_batch.restype = None
            lib.metaasr_edit_distance_batch.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.metaasr_load_wav.restype = ctypes.c_int64
            lib.metaasr_load_wav.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
            ]
            lib.metaasr_write_wav.restype = ctypes.c_int32
            lib.metaasr_write_wav.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int32,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib
