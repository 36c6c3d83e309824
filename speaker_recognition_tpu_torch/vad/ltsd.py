"""LTSD (long-term spectral divergence) voice-activity detection, as in
speaker_recognition_tpu/vad/ltsd.py.

The reference delegates the LTSD to pyssp (src/filters/ltsd.py:36-38) and
calibrates its thresholds on a noise clip; the JAX package implements the
detector itself, and this is the port's copy of it. The spectra of a
signal's frames are one batched `torch.fft.rfft` on the device, the
long-term spectral envelope a max over shifted copies, the score one
weighted sum per frame; only the O(n_intervals) segmentation runs on the
host. The JAX package has no Pallas kernel here (its spectra are
`jnp.fft.rfft`), so neither has the port: this is plain torch.

    amp[l, k]  = |FFT(frame_l * hanning)|            (hop = window_size/2)
    LTSE[l, k] = max_{|j| <= order} amp[l+j, k]
    LTSD[l]    = 10 log10( (1/N) sum_k LTSE[l,k]^2 / noise[k]^2 )

with noise[k] the per-bin average amplitude over the calibration clip's
frames (pyssp's compute_noise_avg_spectrum). Frames within `order` of
either edge score 0. window_size = int(0.04644 fs) (371 at 8 kHz: the
rfft is not of a power of two), Hanning, order 5; lambda0 = 1.1 max(LTSD
of the noise clip against its own profile), lambda1 = 2 lambda0; a voiced
interval is a maximal run of frames with LTSD > lambda0 holding one frame
with LTSD > lambda1, reported in samples as [start*ws/2, (finish+1)*ws/2).

The JAX package pads the frame count to a bucket so that its jitted
program compiles once per bucket; that is a compile-cache artifact and is
left out (a zero row never changes a valid frame's envelope or score).
Spectra run in `dtype` (float32 by default, as the JAX package's; float64
serves the CPU's reference in chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LtsdVad", "ltsd_scores", "noise_profile", "segment_intervals"]

MAGIC_WINDOW_FACTOR = 0.04644  # src/filters/ltsd.py:17


def _amplitudes(signal, window_size: int, device, dtype) -> torch.Tensor:
    """[T, ws // 2 + 1] one-sided amplitude spectra of the Hann-windowed
    frames of `signal` at hop ws/2; T = len // (ws/2) - 1 frames, the pyssp
    convention the reference's interval arithmetic assumes."""
    hop = window_size // 2
    T = max(len(signal) // hop - 1, 0)
    x = torch.tensor(np.asarray(signal), dtype=dtype, device=device)
    # an odd window's last frame reads one sample past (T + 1) hops: zeros
    # where the signal ends there
    x = torch.nn.functional.pad(x, (0, window_size))
    frames = x.unfold(0, window_size, hop)[:T]
    window = torch.as_tensor(np.hanning(window_size), dtype=dtype,
                             device=device)
    return torch.fft.rfft(frames * window, dim=-1).abs()


def noise_profile(noise_signal, window_size: int,
                  device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Per-bin average amplitude over the noise clip's frames: [nb]."""
    amps = _amplitudes(noise_signal, window_size, device, dtype)
    T = amps.shape[0]
    if T == 0:
        raise ValueError("noise clip shorter than one LTSD window")
    return (amps.sum(dim=0) / T).cpu().numpy()


def ltsd_scores(signal, noise_amp, window_size: int, order: int = 5,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32) -> np.ndarray:
    """LTSD score per frame: [T]. Edge frames (no full +-order context)
    are 0."""
    amps = _amplitudes(signal, window_size, device, dtype)
    T, nb = amps.shape
    if T == 0:
        return torch.zeros(0, dtype=dtype).numpy()
    # LTSE: the max over 2*order+1 shifted copies, zero rows past the ends
    padded = torch.nn.functional.pad(amps, (0, 0, order, order))
    ltse = padded.unfold(0, 2 * order + 1, 1).amax(dim=-1)
    # full-spectrum sum via one-sided bins: DC once, Nyquist (even n)
    # once, interior bins twice (|X_k| == |X_{n-k}|)
    w = torch.full((nb,), 2.0, dtype=dtype, device=amps.device)
    w[0] = 1.0
    if window_size % 2 == 0:
        w[-1] = 1.0
    noise = torch.tensor(np.asarray(noise_amp), dtype=dtype,
                            device=amps.device)
    ratio = torch.where(noise > 0,
                        (ltse / torch.clamp_min(noise, 1e-30)) ** 2,
                        torch.zeros_like(ltse))
    score = 10.0 * torch.log10(torch.clamp_min(
        (ratio * w).sum(dim=-1) / window_size, 1e-30))
    # frames lacking full long-term context score 0, like pyssp's guard
    l = torch.arange(T, device=amps.device)
    score = torch.where((l >= order) & (l + order < T), score,
                        torch.zeros_like(score))
    return score.cpu().numpy()


def segment_intervals(scores: np.ndarray, lambda0: float, lambda1: float):
    """Two-threshold hysteresis over frame scores -> [(start, finish)] frame
    index pairs (inclusive), host-side O(T)."""
    above0 = scores > lambda0
    intervals = []
    start = None
    strong = False
    for i, a in enumerate(above0):
        if a:
            if start is None:
                start = i
                strong = False
            if scores[i] > lambda1:
                strong = True
        else:
            if start is not None and strong:
                intervals.append((start, i - 1))
            start = None
    if start is not None and strong:
        intervals.append((start, len(scores) - 1))
    return intervals


class LtsdVad:
    """Session-level detector mirroring src/filters/ltsd.py:LTSD_VAD. The
    calibration constants default to the reference's (ltsd.py:17,38-41);
    the spectra run on `device` in `dtype`."""

    def __init__(self, order: int = 5,
                 window_factor: float = MAGIC_WINDOW_FACTOR,
                 lambda0_scale: float = 1.1, lambda1_scale: float = 2.0,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.order = order
        self.window_factor = window_factor
        self.lambda0_scale = lambda0_scale
        self.lambda1_scale = lambda1_scale
        self.device = torch.device(device)
        self.dtype = dtype
        self.fs = 0
        self.window_size = 0
        self.noise_amp = None
        self.lambda0 = 0.0
        self.lambda1 = 0.0

    def _init_window(self, fs: int):
        self.fs = fs
        self.window_size = int(self.window_factor * fs)

    @staticmethod
    def _mononize(signal) -> np.ndarray:
        signal = np.asarray(signal)
        if signal.ndim > 1:
            signal = signal[:, 0]  # first channel, ltsd.py:86-89
        return signal

    def scores(self, signal) -> np.ndarray:
        """The LTSD of each frame of `signal` against the noise profile."""
        return ltsd_scores(self._mononize(signal), self.noise_amp,
                           self.window_size, self.order, self.device,
                           self.dtype)

    def init_params_by_noise(self, fs: int, noise_signal):
        """Calibrate thresholds from a noise clip (ltsd.py:32-44)."""
        noise_signal = self._mononize(noise_signal)
        self._init_window(fs)
        self.noise_amp = noise_profile(noise_signal, self.window_size,
                                       self.device, self.dtype)
        scores = self.scores(noise_signal)
        max_ltsd = float(scores.max()) if len(scores) else 0.0
        self.lambda0 = max_ltsd * self.lambda0_scale
        self.lambda1 = self.lambda0 * self.lambda1_scale

    def filter(self, signal):
        """-> (concatenated voiced samples, [(start_sample, end_sample)]);
        the interval arithmetic of ltsd.py:52-64."""
        if self.noise_amp is None:
            raise RuntimeError("LTSD VAD not initialized with noise")
        signal = self._mononize(signal)
        frame_ivs = segment_intervals(self.scores(signal), self.lambda0,
                                      self.lambda1)
        hop = self.window_size // 2
        sample_ivs = [(s * hop, (f + 1) * hop) for s, f in frame_ivs]
        parts = [signal[s:f] for s, f in sample_ivs]
        if not parts:
            return np.array([]), []
        return np.concatenate(parts), sample_ivs
