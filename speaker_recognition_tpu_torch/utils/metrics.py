"""Evaluation metrics: identification accuracy, EER / DET points.

BASELINE.md asks for identification accuracy *and* EER parity; the
reference only ever prints accuracy (its rejection test, testbench/
test-reject.py, thresholds LLR at a fixed 10). These helpers compute the
full operating curve from genuine/imposter score sets so any threshold —
including the reference's — can be read off.
"""

from __future__ import annotations

import numpy as np

__all__ = ["eer", "det_points", "accuracy"]


def accuracy(predictions, truth) -> float:
    predictions = list(predictions)
    truth = list(truth)
    return float(np.mean([p == t for p, t in zip(predictions, truth)]))


def det_points(genuine_scores, imposter_scores):
    """FRR/FAR at every distinct threshold.

    Returns (thresholds, far, frr): far[i] = fraction of imposter scores
    >= thresholds[i] (falsely accepted), frr[i] = fraction of genuine
    scores < thresholds[i] (falsely rejected). Higher score = more genuine.
    """
    g = np.sort(np.asarray(genuine_scores, np.float64))
    i = np.sort(np.asarray(imposter_scores, np.float64))
    thresholds = np.unique(np.concatenate([g, i]))
    # counts via searchsorted on the sorted arrays
    far = 1.0 - np.searchsorted(i, thresholds, side="left") / max(len(i), 1)
    frr = np.searchsorted(g, thresholds, side="left") / max(len(g), 1)
    return thresholds, far, frr


def eer(genuine_scores, imposter_scores):
    """Equal error rate and the threshold achieving it (linear
    interpolation between the two DET points straddling FAR == FRR)."""
    thresholds, far, frr = det_points(genuine_scores, imposter_scores)
    diff = far - frr
    idx = np.nonzero(diff <= 0)[0]
    if len(idx) == 0:
        return 1.0, float(thresholds[-1])
    k = idx[0]
    if k == 0:
        return float((far[0] + frr[0]) / 2), float(thresholds[0])
    # interpolate between k-1 (diff>0) and k (diff<=0)
    d0, d1 = diff[k - 1], diff[k]
    w = d0 / (d0 - d1) if d0 != d1 else 0.5
    eer_val = far[k - 1] + w * (far[k] - far[k - 1])
    frr_val = frr[k - 1] + w * (frr[k] - frr[k - 1])
    thr = thresholds[k - 1] + w * (thresholds[k] - thresholds[k - 1])
    return float((eer_val + frr_val) / 2), float(thr)
