"""Session API for serving (src/gui/interface.py:28-109).

ModelInterface loads a session artifact (written by either package) and
predicts batches of utterances through api/fastpath on one device. The
batch is padded to a power-of-two bucket of at least 8 utterances and the
samples to a multiple of features/extract.LENGTH_BUCKET, as in
speaker_recognition_tpu/api/interface.py; padding rows score as invalid
and are dropped. Enrollment, training and VAD are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig, frame_geometry
from ..features import extract
from ..models.gmmset import GMMSet
from ..utils import serialization
from . import fastpath

__all__ = ["ModelInterface"]


class ModelInterface:
    def __init__(self, config: PipelineConfig | None = None,
                 device: torch.device | str = "cuda"):
        self.config = config or PipelineConfig()
        self.device = torch.device(device)
        self.gmmset = GMMSet(reject_threshold=self.config.reject_threshold,
                             device=self.device)
        # VAD calibration of a loaded session, written back by dump()
        self.vad_state: dict | None = None

    def _require_trained(self, what: str):
        if self.gmmset.bank is None:
            raise RuntimeError(f"train() must run before {what}()")

    def predict(self, fs: int, signal):
        """Label of one utterance, or None when it is too short
        (interface.py:85-94, MFCC.py:56)."""
        self._require_trained("predict")
        signal = np.asarray(signal)
        if extract.signal_too_short(fs, self.config.features, len(signal)):
            return None
        return self.predict_batch(fs, [signal])[0]

    def predict_batch(self, fs: int, signals) -> list:
        """Labels of many utterances in input order; None for an utterance
        with no valid frame."""
        scores, valid = self.scores_batch(fs, signals)
        idx = scores.argmax(axis=-1)
        return [self.gmmset.y[int(i)] if ok else None
                for i, ok in zip(idx, valid)]

    def scores_batch(self, fs: int, signals):
        """([n, S] per-speaker average log-likelihoods in gmmset.y's order,
        [n] validity) through one padded predict program."""
        self._require_trained("scores_batch")
        if self.config.dtype != "float32":
            raise NotImplementedError(
                f"dtype {self.config.dtype!r}: the port serves float32 only")
        sigs = [np.asarray(s, np.float64) for s in signals]
        sigs = [s.mean(axis=1) if s.ndim > 1 else s for s in sigs]
        n_real = len(sigs)
        B = 8
        while B < n_real:
            B *= 2
        L = max(len(s) for s in sigs)
        L = -(-L // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
        batch = np.zeros((B, L), np.float32)
        lengths = np.zeros(B, np.int32)
        for i, s in enumerate(sigs):
            batch[i, :len(s)] = s
            lengths[i] = len(s)
        scores = fastpath.predict_scores(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(lengths).to(self.device), self.gmmset.bank, fs,
            self.config.features)
        mf = self.config.features.mfcc
        flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
        # deltas consume n_deltas frames: an utterance keeps a valid frame
        # iff (L - flen)//fshift + 1 > nd  <=>  L >= flen + nd*fshift
        valid = lengths >= flen + self.config.features.n_deltas * fshift
        return scores.cpu().numpy()[:n_real], valid[:n_real]

    def dump(self, fname: str):
        """Write the session artifact (the npz of save_session)."""
        serialization.save_session(fname, gmmset_state=self.gmmset.state(),
                                   config=self.config,
                                   vad_state=self.vad_state)

    @staticmethod
    def load(fname: str,
             device: torch.device | str = "cuda") -> "ModelInterface":
        st, config, vad_state = serialization.load_session(fname)
        m = ModelInterface(config, device)
        m.gmmset = GMMSet.from_state(st, device=m.device)
        m.vad_state = vad_state
        return m
