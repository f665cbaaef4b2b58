"""Native (C) runtime components, loaded via ctypes.

The reference's host-side runtime is C throughout (SURVEY §2); here the
device path is JAX/XLA, and the host runtime keeps native components where
throughput matters: currently the QOI image codec (qoi.c). Compiled on first
use with the system compiler into raytracing_jax/native/_build; all users
degrade gracefully to pure-Python fallbacks if no compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "_build")
_lock = threading.Lock()
_qoi = None
_qoi_failed = False


def _compile(src: str, out: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    for cc in ("cc", "gcc", "g++", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", out, src],
                capture_output=True,
                timeout=120,
            )
            if r.returncode == 0:
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


class _QoiNative:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.qoi_encode_rgb.restype = ctypes.c_long
        lib.qoi_encode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_long,
        ]
        lib.qoi_decode_header.restype = ctypes.c_int
        lib.qoi_decode_header.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.qoi_decode_rgb.restype = ctypes.c_int
        lib.qoi_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int,
        ]

    def encode(self, img: np.ndarray) -> bytes:
        h, w, c = img.shape
        assert c == 3 and img.dtype == np.uint8
        raw = np.ascontiguousarray(img).tobytes()
        cap = 14 + w * h * 4 + 8
        out = ctypes.create_string_buffer(cap)
        n = self._lib.qoi_encode_rgb(raw, w, h, out, cap)
        if n < 0:
            raise RuntimeError("qoi encode failed")
        return out.raw[:n]

    def decode(self, data: bytes) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        if self._lib.qoi_decode_header(data, len(data), w, h) != 0:
            raise ValueError("not a qoi file")
        out = ctypes.create_string_buffer(w.value * h.value * 3)
        if self._lib.qoi_decode_rgb(data, len(data), out, w.value, h.value) != 0:
            raise ValueError("qoi decode failed")
        return np.frombuffer(out.raw, np.uint8).reshape(h.value, w.value, 3)


def qoi_native():
    """Return the native QOI codec, or None if it can't be built."""
    global _qoi, _qoi_failed
    if _qoi is not None or _qoi_failed:
        return _qoi
    with _lock:
        if _qoi is not None or _qoi_failed:
            return _qoi
        so = os.path.join(_BUILD, "libqoi.so")
        src = os.path.join(_HERE, "qoi.c")
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            if not _compile(src, so):
                _qoi_failed = True
                return None
        try:
            _qoi = _QoiNative(ctypes.CDLL(so))
        except OSError:
            _qoi_failed = True
    return _qoi
