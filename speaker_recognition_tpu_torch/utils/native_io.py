"""Reading wav files: a ctypes binding to the repo's native decoder
(native/wavio.cc, `make -C native` builds native/libwavio.so), with scipy
where the library cannot be built. The port's own copy of
speaker_recognition_tpu/utils/native_io.py: `load_library`, `read_wav`
(held to the JAX package's by tests/test_torch_operators.py) and
`load_batch`, the threaded decode + silence removal + padded-batch
assembly (host only; held to the JAX package's on both paths by
tests/test_torch_conversation.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["load_library", "read_wav", "load_batch"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libwavio.so")
_lib = None
_lib_tried = False


def load_library(build_if_missing: bool = True):
    """libwavio.so, built on the first call if missing (unless
    build_if_missing is False); None when it cannot be built or loaded."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH) and build_if_missing:
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
    lib.wavio_load_batch.restype = ctypes.c_long
    lib.wavio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_double, ctypes.c_int]
    lib.wavio_remove_silence.restype = ctypes.c_long
    lib.wavio_remove_silence.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double]
    _lib = lib
    return _lib


def read_wav(path: str):
    """(fs, float32 mono samples at int16 scale). Native when available."""
    lib = load_library()
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


def load_batch(paths, max_len: int | None = None, remove_silence: bool = False,
               silence_perc: float = 0.15, n_threads: int = 0,
               pad_multiple: int = 4096):
    """Decode many wavs into a zero-padded float32 [B, L] batch: (batch,
    lengths [B] int32, sample rates [B] int32), L the longest (after
    silence removal, when asked) rounded up to pad_multiple. A file that
    cannot be decoded gets length 0. The library does it in threads; where
    it cannot be loaded, scipy and vad/energy.remove_silence do."""
    paths = list(paths)
    B = len(paths)
    lib = load_library()
    if max_len is None:
        max_len = 0
        if lib is not None:
            fs = ctypes.c_int32(0)
            for p in paths:
                n = lib.wavio_read(p.encode(), None, 0, ctypes.byref(fs))
                max_len = max(max_len, max(int(n), 0))
        else:
            for p in paths:
                _, s = read_wav(p)
                max_len = max(max_len, len(s))
    max_len = max(-(-max_len // pad_multiple) * pad_multiple, pad_multiple)

    batch = np.zeros((B, max_len), np.float32)
    lengths = np.zeros(B, np.int32)
    fss = np.zeros(B, np.int32)
    if lib is not None:
        arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
        lib.wavio_load_batch(
            arr, B, batch.ctypes.data_as(ctypes.c_void_p), max_len,
            lengths.ctypes.data_as(ctypes.c_void_p),
            fss.ctypes.data_as(ctypes.c_void_p),
            1 if remove_silence else 0, silence_perc, n_threads)
        return batch, lengths, fss

    from ..vad.energy import remove_silence as rs
    for i, p in enumerate(paths):
        try:
            fs, s = read_wav(p)
        except (OSError, ValueError):  # missing or undecodable: length 0
            continue
        if remove_silence:
            s = rs(fs, s.astype(np.int64), perc=silence_perc).astype(
                np.float32)
        n = min(len(s), max_len)
        batch[i, :n] = s[:n]
        lengths[i] = n
        fss[i] = fs
    return batch, lengths, fss
