"""Profile-based spectral noise reduction, as in
speaker_recognition_tpu/vad/noisered.py.

The reference shells out to sox (src/filters/noisered.py:21-38: `sox ...
noiseprof` on a noise clip, then `sox ... noisered <prof> 0.21` on every
utterance). The JAX package keeps the same two-phase API as one STFT
program, and so does the port: the STFT, the 5-frame moving average, the
gain and the inverse STFT are plain torch on the device (the JAX package
has no Pallas kernel here either: `jnp.fft.rfft` / `irfft`).

    profile[k]   = mean_l |STFT(noise)[l, k]|^2              (init_noise)
    Psm[l, k]    = 5-frame moving average of |STFT(x)|^2     (filter)
    gain[l, k]   = (1-a) + a * sqrt(max(1 - 2*profile[k]/Psm[l,k], 0))
    out          = ISTFT(gain * STFT(x))

with `a` the reduction amount in [0, 1] (0 passes the input through; the
default 0.21 is the reference's THRES, noisered.py:17). Analysis and
synthesis use a Hann window at 50% overlap with window-square normalized
overlap-add, so a = 0 reconstructs the input up to rounding.

The overlap-add is not a scatter-add (index_add_ on the card sums with
atomics, in an order that changes from run to run): at hop = ws/2 every
output sample has exactly two contributions, the first half of one frame
and the second half of the one before, so it is the sum of two shifted
halves, and two calls are bitwise equal.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NoiseReduction", "spectral_gate"]

DEFAULT_AMOUNT = 0.21  # sox noisered threshold, src/filters/noisered.py:17


def _window_size(fs: int) -> int:
    # 32 ms, even; the feature frontend's frame length at fs=8000
    return max(int(0.032 * fs) // 2 * 2, 32)


def _frame_count(n: int, ws: int) -> int:
    # frames over [hop zeros | signal | tail zeros]: every real sample is
    # covered by two analysis windows
    hop = ws // 2
    return (hop + n + hop - 1) // hop + 1


def _frames(signal, ws: int, device, dtype):
    """(window [ws], frames [n_frames, ws]) of the signal behind hop zeros,
    on `device` in `dtype`."""
    hop = ws // 2
    n = len(signal)
    n_frames = _frame_count(n, ws)
    x = torch.tensor(np.asarray(signal), dtype=dtype, device=device)
    padded = torch.nn.functional.pad(x, (hop, n_frames * hop + ws - hop - n))
    window = torch.as_tensor(np.hanning(ws), dtype=dtype, device=device)
    return window, padded.unfold(0, ws, hop)[:n_frames]


def _overlap_add(frames: torch.Tensor) -> torch.Tensor:
    """[n_frames, ws] -> [(n_frames + 1) * ws/2] overlap-add at hop ws/2:
    block b is the first half of frame b plus the second half of frame
    b - 1."""
    hop = frames.shape[1] // 2
    zero = frames.new_zeros((1, hop))
    return (torch.cat([frames[:, :hop], zero])
            + torch.cat([zero, frames[:, hop:]])).reshape(-1)


def _noise_power(signal, ws: int, device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The per-bin mean power of a noise clip's STFT: [ws // 2 + 1]."""
    window, frames = _frames(signal, ws, device, dtype)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return (spec.abs() ** 2).mean(dim=0).cpu().numpy()


def spectral_gate(signal, profile, ws: int, amount: float,
                  device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Attenuate the profiled noise in `signal`; returns len(signal)
    samples."""
    n = len(signal)
    hop = ws // 2
    window, frames = _frames(signal, ws, device, dtype)
    spec = torch.fft.rfft(frames * window, dim=-1)              # [T, nb]
    power = spec.abs() ** 2
    # the local power: a centred 5-frame moving average (zeros past the
    # ends), against 2x the profile, the Berouti-style gate
    p = torch.nn.functional.pad(power, (0, 0, 2, 2))
    T = power.shape[0]
    smooth = sum(p[j:j + T] for j in range(5)) * 0.2
    prof = torch.tensor(np.asarray(profile), dtype=dtype,
                        device=power.device)
    sub = torch.sqrt(torch.clamp_min(
        1.0 - 2.0 * prof / torch.clamp_min(smooth, 1e-30), 0.0))
    gain = (1.0 - amount) + amount * sub
    cleaned = torch.fft.irfft(spec * gain, n=ws, dim=-1) * window  # [T, ws]
    acc = _overlap_add(cleaned)
    wsq = _overlap_add((window * window).expand(T, ws))
    # the first hop is the padding of _frames; the region returned has two
    # frames over every sample, so wsq >= ~0.5 throughout
    out = acc / torch.clamp_min(wsq, 1e-8)
    return out[hop:hop + n].cpu().numpy()


class NoiseReduction:
    """Same surface as the reference's NoiseReduction (noisered.py:19-38);
    the STFTs run on `device` in `dtype`."""

    def __init__(self, amount: float = DEFAULT_AMOUNT,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.amount = float(amount)
        self.device = torch.device(device)
        self.dtype = dtype
        self.fs = 0
        self.window_size = 0
        self.profile = None

    @staticmethod
    def _mono(signal) -> np.ndarray:
        signal = np.asarray(signal, np.float32)
        if signal.ndim > 1:
            signal = signal.mean(axis=1)  # utils.monophonic semantics
        return signal

    def init_noise(self, fs: int, signal):
        """Build the per-bin noise power profile (vs `sox noiseprof`)."""
        self.fs = int(fs)
        self.window_size = _window_size(self.fs)
        self.profile = _noise_power(self._mono(signal), self.window_size,
                                   self.device, self.dtype)

    def filter(self, fs: int, signal) -> np.ndarray:
        """Suppress the profiled noise (vs `sox noisered prof 0.21`)."""
        if self.profile is None:
            raise RuntimeError("NoiseReduction not initialized with noise")
        return spectral_gate(self._mono(signal), self.profile,
                             self.window_size, self.amount, self.device,
                             self.dtype)
