"""Typed configuration, field for field the one of speaker_recognition_tpu.

The dataclasses mirror speaker_recognition_tpu/config.py (same fields, same
defaults, so one session artifact configures both packages); only
`jnp_dtype` becomes `torch_dtype`. The reference file:line behind each
default is cited in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MfccConfig:
    """MFCC parameters, src/feature/MFCC.py:116-118."""

    win_length_ms: float = 32.0
    win_shift_ms: float = 16.0
    fft_size: int = 2048
    n_filters: int = 50
    n_ceps: int = 13
    pre_emph: float = 0.95
    power_floor: float = 1e-100
    cmvn: bool = True
    # f_max=None: the melfb.m bank over [0, fs/2]; a value selects the
    # bounded bob.ap-style bank over [f_min, f_max]
    f_min: float = 0.0
    f_max: Optional[float] = None
    mel_scale: bool = True
    preemph_first: bool = False


def bob_mfcc_config(**overrides) -> "MfccConfig":
    """The bob.ap.Ceps defaults (src/feature/BOB.py:13-18)."""
    kw = dict(n_filters=55, n_ceps=19, f_min=0.0, f_max=6000.0,
              preemph_first=True)
    kw.update(overrides)
    return MfccConfig(**kw)


@dataclasses.dataclass(frozen=True)
class LpcConfig:
    """LPC parameters, src/feature/LPC.py:60-61."""

    win_length_ms: float = 32.0
    win_shift_ms: float = 16.0
    n_lpc: int = 15
    pre_emph: float = 0.95
    n_lpcc: int = 0


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """concat(MFCC, LPC) per frame (src/feature/__init__.py:25-30), with
    n_deltas temporal differences appended."""

    mfcc: MfccConfig = MfccConfig()
    lpc: LpcConfig = LpcConfig()
    use_lpc: bool = True
    n_deltas: int = 0

    @property
    def base_dim(self) -> int:
        if not self.use_lpc:
            return self.mfcc.n_ceps
        lpc_dim = (self.lpc.n_lpcc - 1 if self.lpc.n_lpcc > 0
                   else self.lpc.n_lpc)
        return self.mfcc.n_ceps + lpc_dim

    @property
    def dim(self) -> int:
        return self.base_dim * (1 + self.n_deltas)


@dataclasses.dataclass(frozen=True)
class GmmConfig:
    """GMM/EM training parameters (src/gmm/python/pygmm.py:39-46)."""

    n_mixtures: int = 32
    n_iterations: int = 200
    min_covar: float = 1e-3
    threshold: float = 0.01
    init_with_kmeans: bool = False
    min_prob_sum: float = 1e-15
    min_nk: float = 1e-6
    relevance_factor: float = 16.0
    check_every: int = 2
    seed: int = 0

    @property
    def min_sigma(self) -> float:
        return float(self.min_covar) ** 0.5


@dataclasses.dataclass(frozen=True)
class VadConfig:
    """LTSD VAD parameters, src/filters/ltsd.py."""

    window_factor: float = 0.04644
    order: int = 5
    lambda0_scale: float = 1.1
    lambda1_scale: float = 2.0
    keep_fraction: float = 1.0 / 3.0


@dataclasses.dataclass(frozen=True)
class SilenceConfig:
    """Energy-based silence removal, src/filters/silence.py:11-50."""

    frame_duration: float = 0.02
    frame_shift: float = 0.01
    perc: float = 0.15


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level session configuration."""

    features: FeatureConfig = FeatureConfig()
    gmm: GmmConfig = GmmConfig()
    vad: VadConfig = VadConfig()
    silence: SilenceConfig = SilenceConfig()
    reject_threshold: float = 10.0
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def frame_geometry(fs: int, win_length_ms: float, win_shift_ms: float):
    """Frame length/shift in samples, src/feature/MFCC.py:28-29."""
    frame_len = int(float(win_length_ms) / 1000 * fs)
    frame_shift = int(float(win_shift_ms) / 1000 * fs)
    return frame_len, frame_shift


def n_frames(signal_len: int, frame_len: int, frame_shift: int) -> int:
    """Frame count for a signal, src/feature/MFCC.py:57."""
    if signal_len < frame_len:
        return 0
    return (signal_len - frame_len) // frame_shift + 1
