"""Energy-based silence removal, src/filters/silence.py:11-50.

The port's own copy of speaker_recognition_tpu/vad/energy.py (numpy only;
tests/test_torch_vad.py holds the two np.array_equal). The reference's
loop advances by frame_length over silent stretches and by frame_shift
over voiced ones, copying only the first frame_shift samples of each voiced
frame; the advance is data-dependent, so this is O(n_frames) host-side
control flow around O(1) numpy math, not a device kernel.

Parity notes:
  * integer math is Python-2 floor division: unsigned centering subtracts
    (max+1)//2 but de-centering adds max//2 (silence.py:20,48), an
    asymmetry kept because it shifts uint8/uint16 output by one.
  * average energy uses the int64-cast signal (silence.py:23-33).
"""

from __future__ import annotations

import numpy as np

__all__ = ["remove_silence"]


def remove_silence(fs: int, signal: np.ndarray,
                   frame_duration: float = 0.02,
                   frame_shift: float = 0.01,
                   perc: float = 0.15) -> np.ndarray:
    signal = np.asarray(signal)
    orig_dtype = signal.dtype
    is_unsigned = False
    if np.issubdtype(orig_dtype, np.integer):
        typeinfo = np.iinfo(orig_dtype)
        is_unsigned = typeinfo.min >= 0
    work = signal.astype(np.int64) if np.issubdtype(orig_dtype, np.integer) \
        else signal.astype(np.float64)
    if is_unsigned:
        work = work - (typeinfo.max + 1) // 2

    siglen = len(work)
    frame_length = int(frame_duration * fs)
    frame_shift_length = int(frame_shift * fs)
    average_energy = np.sum(work ** 2) / float(siglen)

    out = np.zeros(siglen, dtype=work.dtype)
    new_len = 0
    i = 0
    while i < siglen:
        sub = work[i:i + frame_length]
        ave_energy = np.sum(sub ** 2) / float(len(sub))
        if ave_energy < average_energy * perc:
            i += frame_length
        else:
            add = min(frame_shift_length, len(sub))
            out[new_len:new_len + add] = sub[:add]
            new_len += add
            i += frame_shift_length
    out = out[:new_len]
    if is_unsigned:
        out = out + typeinfo.max // 2
    return out.astype(orig_dtype)
