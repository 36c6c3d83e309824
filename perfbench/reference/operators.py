"""The frontend's constant operators, built from the published formulas.

Frozen copies for the benchmark's plain reference: the window, the two mel
filterbanks and the DCT of the reference implementation
(ppwwyyxx/speaker-recognition, src/feature/MFCC.py:14-16, :81-113; the
bounded bank of src/feature/BOB.py:13-18), in float64 numpy. Nothing here
comes from the program under test.
"""

from __future__ import annotations

import math

import numpy as np


def hamming(n: int) -> np.ndarray:
    """The reference's Hamming window, with its half-sample phase offset:
    0.54 - 0.46 cos(2 pi / n (i + 0.5))."""
    return 0.54 - 0.46 * np.cos(2 * np.pi / n * (np.arange(n) + 0.5))


def mel_filterbank(fs: int, fft_size: int, n_bands: int) -> np.ndarray:
    """The melfb.m bank over [0, fs/2] the reference uses: [n_bands,
    fft_size/2 + 1], mel energies = M @ power."""
    f0 = 700.0 / fs
    fn2 = fft_size // 2
    lr = math.log(1 + 0.5 / f0) / (n_bands + 1)
    bl = fft_size * f0 * (np.exp(np.array([0.0, 1.0, n_bands, n_bands + 1])
                                 * lr) - 1)
    b1 = int(math.floor(bl[0])) + 1
    b2 = int(math.ceil(bl[1]))
    b3 = int(math.floor(bl[2]))
    b4 = min(fn2, int(math.ceil(bl[3]))) - 1
    pf = np.log(1 + np.arange(b1, b4 + 1, dtype=np.float64) / f0
                / fft_size) / lr
    fp = np.floor(pf).astype(np.int64)
    pm = pf - fp
    M = np.zeros((n_bands, 1 + fn2), dtype=np.float64)
    # falling edge of filter fp - 1 over bins [b2, b4], rising edge of
    # filter fp over bins [1, b3]; bin c + 1 takes pf[c] (b1 is always 1)
    c1 = np.arange(b2 - 1, b4)
    np.add.at(M, (fp[c1] - 1, c1 + 1), 2 * (1 - pm[c1]))
    c2 = np.arange(0, b3)
    np.add.at(M, (fp[c2], c2 + 1), 2 * pm[c2])
    return M


def mel_filterbank_bounded(fs: int, fft_size: int, n_bands: int,
                           f_min: float, f_max: float,
                           mel_scale: bool = True) -> np.ndarray:
    """The bob.ap.Ceps-style bank: n_bands triangles with peaks equally
    spaced on the mel scale (or linearly) over [f_min, min(f_max, fs/2)],
    [n_bands, fft_size/2 + 1]."""
    f_max = min(float(f_max), fs / 2.0)
    if not 0.0 <= f_min < f_max:
        raise ValueError(f"mel band [{f_min}, {f_max}] at {fs} Hz")

    def warp(f):
        f = np.asarray(f, dtype=np.float64)
        return 2595.0 * np.log10(1.0 + f / 700.0) if mel_scale else f

    edges = np.linspace(warp(f_min), warp(f_max), n_bands + 2)
    m = warp(np.arange(fft_size // 2 + 1, dtype=np.float64) * fs
             / fft_size)[None, :]
    left, center, right = (edges[:-2, None], edges[1:-1, None],
                           edges[2:, None])
    rising = (m - left) / np.maximum(center - left, 1e-30)
    falling = (right - m) / np.maximum(right - center, 1e-30)
    return np.clip(np.minimum(rising, falling), 0.0, None)


def dct_matrix(n: int) -> np.ndarray:
    """The orthonormal DCT-II of order n."""
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    D = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * x + 1) * y / (2 * n))
    D[0] /= np.sqrt(2)
    return D


def mel_bank(fs: int, mfcc: dict) -> np.ndarray:
    """The bank a configuration's MFCC group names: [n_filters, fft/2+1]."""
    if mfcc.get("f_max") is None:
        return mel_filterbank(fs, mfcc["fft_size"], mfcc["n_filters"])
    return mel_filterbank_bounded(fs, mfcc["fft_size"], mfcc["n_filters"],
                                  mfcc.get("f_min", 0.0), mfcc["f_max"],
                                  mfcc.get("mel_scale", True))


def frame_geometry(fs: int, win_length_ms: float, win_shift_ms: float):
    """Frame length and shift in samples (src/feature/MFCC.py:28-29)."""
    return (int(float(win_length_ms) / 1000 * fs),
            int(float(win_shift_ms) / 1000 * fs))
