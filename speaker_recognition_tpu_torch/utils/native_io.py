"""Reading wav files: a ctypes binding to the repo's native decoder
(native/wavio.cc, `make -C native` builds native/libwavio.so), with scipy
where the library cannot be built. The port's own copy of the read path of
speaker_recognition_tpu/utils/native_io.py; tests/test_torch_operators.py
holds the two to the same (fs, samples).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["read_wav"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libwavio.so")
_lib = None
_lib_tried = False


def _load_library():
    """libwavio.so, built on the first call if missing; None when it cannot
    be built or loaded."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.wavio_read.restype = ctypes.c_long
    lib.wavio_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_long, ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def read_wav(path: str):
    """(fs, float32 mono samples at int16 scale). Native when available."""
    lib = _load_library()
    if lib is not None:
        fs = ctypes.c_int32(0)
        n = lib.wavio_read(path.encode(), None, 0, ctypes.byref(fs))
        if n >= 0:
            buf = np.empty(n, np.float32)
            lib.wavio_read(path.encode(), buf.ctypes.data_as(ctypes.c_void_p),
                           n, ctypes.byref(fs))
            return int(fs.value), buf
    import scipy.io.wavfile as wavfile
    try:
        fs, signal = wavfile.read(path)
    except Exception as e:  # scipy can raise anything on corrupt headers
        raise ValueError(f"cannot decode wav file {path!r}: {e}") from e
    if signal.ndim > 1:
        signal = signal[:, 0]
    return int(fs), signal.astype(np.float32)
