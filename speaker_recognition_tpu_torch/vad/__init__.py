"""Voice-activity detection and noise filtering, as in
speaker_recognition_tpu/vad.

The reference's filter stack (src/filters/): LTSD VAD (ltsd.py), energy
silence removal (energy.py, numpy), profile-based noise reduction
(noisered.py: a spectral gate in place of the reference's sox), and the
composing VAD class (src/filters/VAD.py:13-34). The spectra run in plain
torch on the device; no kernel of the JAX package lies on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from .energy import remove_silence
from .ltsd import LtsdVad
from .noisered import NoiseReduction

__all__ = ["VAD", "LtsdVad", "NoiseReduction", "remove_silence"]


class VAD:
    """NoiseReduction + LTSD, the shape of src/filters/VAD.py.

    The reference profiles noise for both stages but routes signals through
    LTSD only (the noise-reduction call at VAD.py:30-31 is commented out);
    `use_noise_reduction=True` runs the full chain.
    """

    def __init__(self, use_noise_reduction: bool = False,
                 device: torch.device | str = "cuda"):
        self.initted = False
        self.use_noise_reduction = use_noise_reduction
        self.nr = NoiseReduction(device=device)
        self.ltsd = LtsdVad(device=device)

    def init_noise(self, fs: int, signal):
        """Calibrate both stages from a noise clip (VAD.py:20-25)."""
        self.initted = True
        self.nr.init_noise(fs, signal)
        self.ltsd.init_params_by_noise(fs, np.asarray(signal))

    def filter(self, fs: int, signal):
        """-> (voiced samples, [(start, end)] sample intervals)."""
        if not self.initted:
            raise RuntimeError("NoiseFilter Not Initialized")  # VAD.py:29
        if self.use_noise_reduction:
            signal = self.nr.filter(fs, signal)
        return self.ltsd.filter(np.asarray(signal))
