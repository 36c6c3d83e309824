"""Speaker model bank: enrollment, serial scoring, open-set rejection
(src/testbench/gmmset.py:16-105, src/gui/skgmm.py:11-39).

Mirrors speaker_recognition_tpu/models/gmmset.py. The bank's parameters
persist as numpy (`params`, weights [S, K], means/sigmas [S, K, d]) and
serve from a device as a GmmBank (`bank`). Training pads every pending
speaker to a common frame count and fits the whole bank in one batched EM
(models/gmm.fit / fit_from_ubm). Serial scoring pads one utterance to a
SCORE_FRAME_BUCKET multiple and runs ops/gpu_gmm.serial_scores, which at
float32 on CUDA is the serial kernel (csrc/gmm_serial.cu); the open-set
quantities
score the bank and the UBM, appended as one more speaker, in one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GmmConfig
from ..ops import gpu_gmm
from . import gmm
from .gmm import GmmBank, GmmParams

__all__ = ["GMMSet"]

# An utterance's frame axis is padded (masked) to a multiple of this, as in
# the JAX package, so serial calls see few distinct shapes.
SCORE_FRAME_BUCKET = 256


def _pad_frames_bucket(x: np.ndarray):
    """[T, d] exact-length frames -> ([Tp, d], [Tp] mask) with Tp a
    SCORE_FRAME_BUCKET multiple (numpy)."""
    T = x.shape[0]
    Tp = -(-max(T, 1) // SCORE_FRAME_BUCKET) * SCORE_FRAME_BUCKET
    if Tp != T:
        x = np.concatenate(
            [x, np.zeros((Tp - T, x.shape[1]), x.dtype)], axis=0)
    return x, np.arange(Tp) < T


def _pad_stack(feature_list):
    """list of [T_i, d] -> ([S, T_max, d] float64, [S, T_max] mask), each
    speaker's valid frames a prefix."""
    d = feature_list[0].shape[1]
    T = max(f.shape[0] for f in feature_list)
    X = np.zeros((len(feature_list), T, d), np.float64)
    mask = np.zeros((len(feature_list), T), bool)
    for i, f in enumerate(feature_list):
        X[i, : f.shape[0]] = f
        mask[i, : f.shape[0]] = True
    return X, mask


class GMMSet:
    """Bank of per-speaker GMMs with an optional UBM for MAP adaptation and
    rejection. `dtype` is the training and scoring dtype: float32 serves
    the kernels, float64 runs the plain versions on the CPU or the card
    (ops/gpu_gmm.serial_scores)."""

    def __init__(self, gmm_order: int = 32, ubm: GmmParams | None = None,
                 reject_threshold: float = 10.0,
                 config: GmmConfig | None = None, dtype: str = "float32",
                 device: torch.device | str = "cuda"):
        self.ubm = ubm
        self.reject_threshold = reject_threshold  # gmmset.py:18
        # gmmset.py:24-27: a UBM fixes the order
        self.gmm_order = ubm.n_mixtures if ubm is not None else gmm_order
        self.config = config or GmmConfig(n_mixtures=self.gmm_order)
        self.dtype = dtype
        self.device = torch.device(device)
        self.y: list[str] = []
        self._pending: list[np.ndarray] = []
        self.params: GmmParams | None = None
        self.bank: GmmBank | None = None
        # iterations and host syncs of the last train() (EM's, and
        # k-means' as kmeans_rounds, kmeans_iterations and
        # kmeans_host_syncs)
        self.train_log: dict = {}
        self._with_ubm = None  # (params, ubm, GmmBank of bank + UBM)

    @property
    def _torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def _set_params(self, params: GmmParams):
        self.params = params
        self.bank = GmmBank.from_numpy(*params, device=self.device,
                                       dtype=self._torch_dtype)

    def _append(self, new: GmmParams):
        if self.params is None:
            self._set_params(new)
        else:
            self._set_params(GmmParams(*(
                np.concatenate([old, n], axis=0)
                for old, n in zip(self.params, new))))

    # -- enrollment --------------------------------------------------------

    def fit_new(self, x: np.ndarray, label: str):
        """Queue one speaker's frames; train() fits every queued speaker in
        one batched EM (gmmset.py:29-34)."""
        self.y.append(label)
        self._pending.append(np.asarray(x, np.float64))

    def fit(self, X, y):
        """Group samples by label and enroll (gmmset.py:36-53)."""
        grouped: dict[str, list] = {}
        for xi, yi in zip(X, y):
            grouped.setdefault(yi, []).append(np.asarray(xi))
        for label, parts in grouped.items():
            self.fit_new(np.concatenate(parts, axis=0), label)
        self.train()

    def train(self, seed: int = 0):
        """Fit every pending speaker in one batched EM: MAP from the UBM
        when there is one, else EM from the reference init, its means
        seeded by k-means|| when config.init_with_kmeans; speaker s draws
        from models/gmm.speaker_generator(seed, s)."""
        if not self._pending:
            return
        cfg = self.config
        dt = self._torch_dtype
        Xs, masks = _pad_stack(self._pending)
        X = torch.as_tensor(Xs, dtype=dt, device=self.device)
        mask = torch.as_tensor(masks, device=self.device)
        self.train_log = {}
        if self.ubm is not None:
            ubm = gmm.params_to(self.ubm, dt, self.device)
            new, _ = gmm.fit_from_ubm(X, mask, ubm, cfg, self.train_log)
        else:
            new, _ = gmm.fit_with_init(X, mask, cfg, seed, self.train_log)
        self._append(gmm.params_numpy(new))
        self._pending = []

    # -- scoring -----------------------------------------------------------

    def _require_bank(self):
        if self.bank is None:  # a real error, not an assert (python -O)
            raise RuntimeError("train() must run before predict")

    def _utterance(self, x: np.ndarray):
        Xp, mask = _pad_frames_bucket(
            np.asarray(x, np.dtype(self.dtype)))
        return (torch.from_numpy(Xp).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _bank_with_ubm(self) -> GmmBank:
        """The bank with the UBM appended as speaker S, cached per (bank,
        UBM) so serial calls do not rebuild the operator."""
        cached = self._with_ubm
        if (cached is None or cached[0] is not self.params
                or cached[1] is not self.ubm):
            u = self.ubm
            both = GmmParams(*(np.concatenate(
                [np.asarray(a, np.float64),
                 np.asarray(b, np.float64)[None]], axis=0)
                for a, b in zip(self.params, u)))
            self._with_ubm = (self.params, self.ubm, GmmBank.from_numpy(
                *both, device=self.device, dtype=self._torch_dtype))
        return self._with_ubm[2]

    def _scores(self, x: np.ndarray) -> np.ndarray:
        """Per-speaker average log-likelihood of one utterance: [S]."""
        self._require_bank()
        X, mask = self._utterance(x)
        return gpu_gmm.serial_scores(self.bank, X, mask).cpu().numpy()

    def llr_scores(self, x: np.ndarray):
        """(per-speaker scores [S], UBM per-frame score) of one utterance,
        the open-set decision quantities (gmmset.py:69-81), from one
        scoring launch over the bank and the UBM."""
        self._require_bank()
        if self.ubm is None:
            raise RuntimeError("llr_scores requires a UBM")
        X, mask = self._utterance(x)
        out = gpu_gmm.serial_scores(self._bank_with_ubm(), X,
                                    mask).cpu().numpy()
        return out[:-1], float(out[-1])

    def predict_one_scores(self, x):
        return list(self._scores(x))

    def predict_one(self, x) -> str:
        """argmax over the per-speaker scores (skgmm.py:33-39)."""
        return self.y[int(np.argmax(self._scores(x)))]

    def predict(self, X):
        return [self.predict_one(x) for x in X]

    def predict_one_with_rejection(self, x):
        """Open-set decision (gmmset.py:69-81): None when the best
        per-frame score beats the UBM's by less than reject_threshold."""
        if self.ubm is None:
            # the reference's own message (testbench/gmmset.py:71)
            raise RuntimeError(
                "UBM must be given prior to conduct reject prediction.")
        scores, ubm_score = self.llr_scores(x)
        best = int(np.argmax(scores))
        if scores[best] - ubm_score < self.reject_threshold:
            return None
        return self.y[best]

    def predict_with_reject(self, X):
        return [self.predict_one_with_rejection(x) for x in X]

    # -- rejection calibration ---------------------------------------------

    def rejection_margin(self, x) -> float:
        """Best per-frame bank score minus the UBM's: the statistic that
        predict_one_with_rejection thresholds."""
        scores, ubm_score = self.llr_scores(x)
        return float(np.max(scores) - ubm_score)

    def calibrate_rejection(self, dev_genuine, dev_imposter,
                            target: str = "eer", max_far: float = 0.05):
        """Set reject_threshold from development data (lists of [T, d]
        features of enrolled speakers and of impostors) instead of the
        reference's fixed 10 (gmmset.py:18). target "eer": where false
        accepts and false rejects cross; "far": the smallest threshold with
        FAR <= max_far. Returns the operating point; the threshold persists
        with the session through state()."""
        if self.ubm is None:
            raise RuntimeError("calibrate_rejection requires a UBM")
        if not dev_genuine or not dev_imposter:
            raise ValueError("both dev sets must be non-empty")
        g = np.asarray([self.rejection_margin(x) for x in dev_genuine])
        i = np.asarray([self.rejection_margin(x) for x in dev_imposter])
        # candidate thresholds: midpoints of the pooled sorted margins
        # (every distinct (FAR, FRR) trade-off appears at one of these)
        pooled = np.sort(np.concatenate([g, i]))
        cands = np.concatenate([[pooled[0] - 1.0],
                                (pooled[:-1] + pooled[1:]) / 2.0,
                                [pooled[-1] + 1.0]])
        far = np.asarray([(i >= t).mean() for t in cands])   # false accept
        frr = np.asarray([(g < t).mean() for t in cands])    # false reject
        if target == "eer":
            k = int(np.argmin(np.abs(far - frr)))
        elif target == "far":
            ok = np.nonzero(far <= max_far)[0]
            if len(ok) == 0:
                k = len(cands) - 1  # reject everything: FAR = 0
            else:
                k = int(ok[0])      # smallest such threshold: lowest FRR
        else:
            raise ValueError(f"unknown target {target!r}")
        self.reject_threshold = float(cands[k])
        return {"threshold": self.reject_threshold,
                "far": float(far[k]), "frr": float(frr[k]),
                "eer": float((far[k] + frr[k]) / 2.0),
                "target": target, "n_genuine": len(g), "n_imposter": len(i),
                "genuine_margins": [round(float(v), 4) for v in g],
                "imposter_margins": [round(float(v), 4) for v in i]}

    def load_gmm(self, label: str, fname: str):
        """Append a GMM from a reference-format text model file as a new
        speaker (GMMSet.load_gmm, gmmset.py:83-88)."""
        from ..utils import serialization

        with open(fname) as f:
            params = serialization.load_reference_gmm(f)
        self.y.append(label)
        self._append(GmmParams(*(a[None] for a in params)))

    # -- persistence -------------------------------------------------------

    def state(self) -> dict:
        if self.params is None:
            raise RuntimeError("train() must run before state()")
        st = {
            "labels": list(self.y),
            "weights": np.asarray(self.params.weights),
            "means": np.asarray(self.params.means),
            "sigmas": np.asarray(self.params.sigmas),
            "reject_threshold": self.reject_threshold,
        }
        if self.ubm is not None:
            st["ubm_weights"] = np.asarray(self.ubm.weights)
            st["ubm_means"] = np.asarray(self.ubm.means)
            st["ubm_sigmas"] = np.asarray(self.ubm.sigmas)
        return st

    @classmethod
    def from_state(cls, st: dict, config: GmmConfig | None = None,
                   dtype: str = "float32",
                   device: torch.device | str = "cuda") -> "GMMSet":
        ubm = None
        if "ubm_weights" in st:
            ubm = GmmParams(st["ubm_weights"], st["ubm_means"],
                            st["ubm_sigmas"])
        obj = cls(gmm_order=st["weights"].shape[-1], ubm=ubm,
                  reject_threshold=float(st["reject_threshold"]),
                  config=config, dtype=dtype, device=device)
        obj.y = [str(label) for label in st["labels"]]
        obj._set_params(GmmParams(st["weights"], st["means"], st["sigmas"]))
        return obj
