"""The least work of batch identification, counted by one frozen rule.

The count is the algorithm's, over the valid frames only, the same whatever
route or kernel computes it:

- framing, window and pre-emphasis: 3 FLOPs a sample of each frame;
- a real FFT of N points, 2.5 N log2 N, and the power of its N/2 + 1 bins
  (3 FLOPs a bin). N is the least transform whose power spectrum gives the
  configuration's fft_size-point one: the fft_size itself where it is below
  two frame lengths (the frame folds), else the least power of two of at
  least two frame lengths (the frame's autocorrelation then has no alias,
  and every fft_size-point bin is a fixed sum of the N-point ones);
- the projection of the N/2 + 1 bins onto the mel energies and the
  autocorrelation lags: 2 FLOPs per nonzero of those operators in the
  N-point bin domain (in float32, as a kernel holds them);
- the log of each mel energy, the DCT (2 n_mel n_ceps), an order-p
  Levinson (2 p^2) and, with LPC cepstra, their recursion (2 n_lpcc p);
- scoring, the product [x^2 | x] . op: 4 d S K FLOPs a frame;
- bytes: the valid samples read once, each output written once, each
  operator and the bank read once.

Each term is charged at the peak of the fastest unit that keeps float32
accuracy: the two products (the projection and the scoring product) at the
TF32 tensor cores' peak in three passes, everything else at the float32
peak, bytes at the HBM rate. The least time is the largest of the three
terms. No kernel that computes the same function at float32 accuracy can
take less, so a share of it cannot pass 100%.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from ..reference import operators
from . import peaks


@dataclasses.dataclass(frozen=True)
class Work:
    """FLOPs at float32 outside the tensor cores, FLOPs on the TF32 tensor
    cores (their passes counted), and bytes."""

    fp32_flops: float = 0.0
    tf32_flops: float = 0.0
    nbytes: float = 0.0

    def terms(self) -> dict:
        """Seconds of each term at its peak."""
        return {"fp32": self.fp32_flops / peaks.FP32_FLOPS,
                "tf32": self.tf32_flops / peaks.TF32_FLOPS,
                "bytes": self.nbytes / peaks.HBM_BYTES_S}

    def least_s(self) -> float:
        """The least time, in seconds: the largest term."""
        return max(self.terms().values())


def least_fft_size(frame_len: int, fft_size: int) -> int:
    """N of the module's docstring."""
    if fft_size < 2 * frame_len:
        return fft_size
    return 1 << max(2 * frame_len - 1, 1).bit_length()


def halfspec_to_fullspec(frame_len: int, fft_small: int,
                         fft_big: int) -> np.ndarray:
    """The linear map from the fft_small-point power spectrum of a
    frame_len-sample frame (fft_small >= 2 frame_len) to its fft_big-point
    one, [fft_small/2 + 1, fft_big/2 + 1], by Wiener-Khinchin."""
    k = np.arange(fft_small // 2 + 1, dtype=np.float64)[:, None]
    lag = np.arange(frame_len, dtype=np.float64)[None, :]
    p2r = 2.0 * np.cos(2.0 * np.pi * k * lag / fft_small) / fft_small
    p2r[0] /= 2.0
    p2r[-1] /= 2.0
    kb = np.arange(fft_big // 2 + 1, dtype=np.float64)[None, :]
    r2p = 2.0 * np.cos(2.0 * np.pi * lag.T * kb / fft_big)
    r2p[0] /= 2.0
    return p2r @ r2p


def _acorr_operator(n_fft: int, order: int) -> np.ndarray:
    """The N-point power -> autocorrelation lags 0..order map (up to its
    scale), [N/2 + 1, order + 1]."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    j = np.arange(order + 1, dtype=np.float64)[None, :]
    R = 2.0 * np.cos(2.0 * np.pi * k * j / n_fft)
    R[0] /= 2.0
    R[-1] /= 2.0
    return R


@functools.lru_cache(maxsize=32)
def _projection_nonzeros(fs: int, frame_len: int, mfcc_items: tuple,
                         order: int) -> int:
    mfcc = dict(mfcc_items)
    n = least_fft_size(frame_len, mfcc["fft_size"])
    mel_t = operators.mel_bank(fs, mfcc).T
    if n != mfcc["fft_size"]:
        mel_t = halfspec_to_fullspec(frame_len, n, mfcc["fft_size"]) @ mel_t
    ops = [mel_t] + ([_acorr_operator(n, order)] if order >= 0 else [])
    return sum(int((op.astype(np.float32) != 0).sum()) for op in ops)


def projection_nonzeros(fs: int, features: dict) -> int:
    """Nonzeros of the mel and autocorrelation operators in the N-point bin
    domain of a configuration's `features` group."""
    mf = features["mfcc"]
    flen, _ = operators.frame_geometry(fs, mf["win_length_ms"],
                                       mf["win_shift_ms"])
    order = features["lpc"]["n_lpc"] if features.get("use_lpc", True) else -1
    return _projection_nonzeros(int(fs), flen, tuple(sorted(mf.items())),
                                order)


def feature_dim(features: dict) -> int:
    """The dimension of a frame's features."""
    lp = features["lpc"]
    base = features["mfcc"]["n_ceps"]
    if features.get("use_lpc", True):
        base += lp["n_lpcc"] - 1 if lp.get("n_lpcc", 0) > 0 else lp["n_lpc"]
    return base * (1 + features.get("n_deltas", 0))


def valid_frames(fs: int, features: dict, lengths) -> int:
    """Frames wholly inside the signals of the given lengths, in all."""
    mf = features["mfcc"]
    flen, fshift = operators.frame_geometry(fs, mf["win_length_ms"],
                                            mf["win_shift_ms"])
    lengths = np.asarray(lengths, dtype=np.int64)
    return int(np.where(lengths >= flen, (lengths - flen) // fshift + 1,
                        0).sum())


def frontend_work(fs: int, features: dict, lengths) -> Work:
    """The least work of the frontend on signals of the given lengths."""
    mf, lp = features["mfcc"], features["lpc"]
    flen, _ = operators.frame_geometry(fs, mf["win_length_ms"],
                                       mf["win_shift_ms"])
    frames = valid_frames(fs, features, lengths)
    n = least_fft_size(flen, mf["fft_size"])
    nmel, nceps = mf["n_filters"], mf["n_ceps"]
    use_lpc = features.get("use_lpc", True)
    p = lp["n_lpc"] if use_lpc else 0
    n_lpcc = lp.get("n_lpcc", 0) if use_lpc else 0
    per_frame = (3 * flen + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1)
                 + nmel + 2 * nmel * nceps + 2 * p * p + 2 * n_lpcc * p)
    nnz = projection_nonzeros(fs, features)
    nbytes = (4 * int(np.sum(lengths)) + 4 * frames * feature_dim(features)
              + 4 * (nnz + nmel * nceps))
    return Work(frames * per_frame, peaks.TF32_PASSES * 2 * nnz * frames,
                nbytes)


def score_work(frames: int, d: int, speakers: int, components: int,
               utterances: int) -> Work:
    """The least work of scoring `frames` valid frames of d features against
    S speakers of K components: the product at the TF32 peak in three
    passes; the features and the frame mask read, the bank read, [B, S]
    scores written."""
    sk = speakers * components
    return Work(0.0, peaks.TF32_PASSES * 4.0 * d * sk * frames,
                4.0 * frames * d + frames + 4.0 * sk * (2 * d + 1)
                + 4.0 * utterances * speakers)


def predict_work(fs: int, features: dict, lengths, speakers: int,
                 components: int) -> Work:
    """The least work of one batch end to end: the frontend's and the
    scoring's FLOPs; the signals, the operators and the bank read once,
    the scores written once (the features are never bytes of their own)."""
    fe = frontend_work(fs, features, lengths)
    frames = valid_frames(fs, features, lengths)
    d = feature_dim(features)
    sc = score_work(frames, d, speakers, components, len(lengths))
    feat_bytes = 4.0 * frames * d
    return Work(fe.fp32_flops + sc.fp32_flops, fe.tf32_flops + sc.tf32_flops,
                fe.nbytes - feat_bytes + sc.nbytes - feat_bytes - frames)
