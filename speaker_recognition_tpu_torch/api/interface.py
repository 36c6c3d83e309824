"""Session API (src/gui/interface.py:28-109), as in
speaker_recognition_tpu/api/interface.py.

ModelInterface calibrates an LTSD VAD on room noise and filters signals
with it (init_noise, filter), accumulates per-speaker features (enroll),
trains a GMMSet bank in one batched EM (train), predicts batches of
utterances through api/fastpath, decides single utterances against the UBM
(predict_with_rejection) and reads and writes the session artifact, with
the VAD's calibration, all on one device. A batch is padded to a
power-of-two bucket of at least 8 utterances and the samples to a multiple
of features/extract.LENGTH_BUCKET; padding rows score as invalid and are
dropped.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..config import PipelineConfig, frame_geometry
from ..features import extract
from ..models.gmmset import GMMSet
from ..utils import serialization
from ..vad.ltsd import LtsdVad
from . import fastpath

__all__ = ["ModelInterface"]


class ModelInterface:
    UBM_MODEL_FILE: str | None = None  # interface.py:30 semantics

    def __init__(self, config: PipelineConfig | None = None,
                 device: torch.device | str = "cuda"):
        self.config = config or PipelineConfig()
        self.device = torch.device(device)
        self.features: dict[str, list] = defaultdict(list)
        vc = self.config.vad
        self.vad = LtsdVad(order=vc.order, window_factor=vc.window_factor,
                           lambda0_scale=vc.lambda0_scale,
                           lambda1_scale=vc.lambda1_scale,
                           device=self.device)
        self.gmmset = self._new_gmmset()

    def _new_gmmset(self) -> GMMSet:
        ubm = None
        if self.UBM_MODEL_FILE:
            with open(self.UBM_MODEL_FILE) as f:
                ubm = serialization.load_reference_gmm(f)
        return GMMSet(gmm_order=self.config.gmm.n_mixtures, ubm=ubm,
                      reject_threshold=self.config.reject_threshold,
                      config=self.config.gmm, dtype=self.config.dtype,
                      device=self.device)

    def _feature(self, fs: int, signal) -> np.ndarray:
        return extract.mix_feature(fs, np.asarray(signal),
                                   self.config.features,
                                   dtype=self.config.dtype,
                                   device=self.device)

    # -- VAD ---------------------------------------------------------------

    def init_noise(self, fs: int, signal):
        """Calibrate the LTSD VAD from an environment-noise clip
        (interface.py:36-41)."""
        self.vad.init_params_by_noise(fs, np.asarray(signal))

    def filter(self, fs: int, signal):
        """The voiced samples of a signal, or an empty array when the VAD
        keeps no more than config.vad.keep_fraction of it (the length-1/3
        rule of interface.py:43-53)."""
        ret, _ = self.vad.filter(np.asarray(signal))
        if len(ret) > len(signal) * self.config.vad.keep_fraction:
            return ret
        return np.array([])

    # -- enroll / train ----------------------------------------------------

    def enroll(self, name: str, fs: int, signal):
        """Extract features and append them to the speaker's pool
        (interface.py:55-61)."""
        self.features[name].append(self._feature(fs, signal))

    def train(self, seed: int = 0):
        """Fit every enrolled speaker in one batched EM (interface.py:77-83
        fits them one by one)."""
        self.gmmset = self._new_gmmset()
        for name, feats in self.features.items():
            self.gmmset.fit_new(np.concatenate(feats, axis=0), name)
        self.gmmset.train(seed=seed)

    # -- predict -----------------------------------------------------------

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

    def predict_with_rejection(self, fs: int, signal):
        """Open-set label of one utterance, or None when the UBM explains
        it within reject_threshold (GMMSet.predict_one_with_rejection)."""
        self._require_trained("predict_with_rejection")
        return self.gmmset.predict_one_with_rejection(
            self._feature(fs, signal))

    def calibrate_rejection(self, fs: int, genuine_signals, imposter_signals,
                            target: str = "eer", max_far: float = 0.05):
        """Set the open-set threshold from development audio
        (GMMSet.calibrate_rejection); it persists with the session."""
        self._require_trained("calibrate_rejection")
        return self.gmmset.calibrate_rejection(
            [self._feature(fs, s) for s in genuine_signals],
            [self._feature(fs, s) for s in imposter_signals],
            target=target, max_far=max_far)

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
        sigs = [np.asarray(s, np.float64) for s in signals]
        sigs = [s.mean(axis=1) if s.ndim > 1 else s for s in sigs]
        n_real = len(sigs)
        B = 8
        while B < n_real:
            B *= 2
        L = max(len(s) for s in sigs)
        L = -(-L // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
        # float64 keeps the signals full-width (the JAX package's parity
        # path, api/interface.py:172-176)
        batch = np.zeros((B, L), np.float64 if self.config.dtype == "float64"
                         else np.float32)
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

    def warmup(self, fs: int, durations=(1.5, 3.0, 5.0), batch_sizes=(1,)):
        """Build the kernels and the frontend operators of `fs` before the
        first request, by predicting silent-but-for-a-click signals of the
        given durations and batch sizes. Requires a trained bank."""
        self._require_trained("warmup")
        for b in batch_sizes:
            for dur in durations:
                n = int(fs * dur)
                sig = np.zeros(n, np.float32)
                sig[: min(n, 2048)] = 1.0  # non-silent, deterministic
                self.predict_batch(fs, [sig] * max(int(b), 1))

    # -- persistence -------------------------------------------------------

    def dump(self, fname: str):
        """Write the session artifact (the npz of save_session), with the
        VAD's calibration once init_noise has run."""
        vad_state = None
        if self.vad.noise_amp is not None:
            vad_state = {"noise_amp": self.vad.noise_amp,
                         "lambda0": self.vad.lambda0,
                         "lambda1": self.vad.lambda1,
                         "window_size": self.vad.window_size,
                         "order": self.vad.order,
                         "fs": self.vad.fs}
        serialization.save_session(fname, gmmset_state=self.gmmset.state(),
                                   config=self.config, vad_state=vad_state)

    @staticmethod
    def load(fname: str,
             device: torch.device | str = "cuda") -> "ModelInterface":
        st, config, vad_state = serialization.load_session(fname)
        m = ModelInterface(config, device)
        m.gmmset = GMMSet.from_state(st, config=config.gmm,
                                     dtype=config.dtype, device=m.device)
        if vad_state is not None:  # the calibration init_noise made
            m.vad.order = int(vad_state["order"])
            m.vad.noise_amp = np.asarray(vad_state["noise_amp"])
            m.vad.lambda0 = float(vad_state["lambda0"])
            m.vad.lambda1 = float(vad_state["lambda1"])
            m.vad.window_size = int(vad_state["window_size"])
            m.vad.fs = int(vad_state["fs"])
        return m
