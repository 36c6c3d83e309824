"""UBM workflow tools (src/testbench/train-ubm.py, adapt-ubm.py), as in
speaker_recognition_tpu/tools/ubm.py.

train_ubm pools background utterances' features and fits one large
diagonal GMM (the reference pools 300 random utterances and runs 500 EM
iterations at threshold 1e-15, train-ubm.py:41-51); adapt_speakers
MAP-adapts every enrolled speaker from the UBM in one batched EM
(adapt-ubm.py:25-36).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import GmmConfig
from ..models import gmm
from ..models.gmmset import _pad_stack

__all__ = ["train_ubm", "adapt_speakers"]


def train_ubm(feature_arrays, n_mixtures: int = 32, n_iterations: int = 500,
              threshold: float = 1e-15, seed: int = 0, mesh=None,
              dtype="float32", checkpoint_path: str | None = None,
              checkpoint_every: int = 50,
              device: torch.device | str = "cuda") -> gmm.GmmParams:
    """Fit a UBM (numpy GmmParams, weights [K]) on pooled background
    features, an iterable of [T_i, d] arrays. Defaults mirror
    train-ubm.py:47 (GMM(32, nr_iteration=500, threshold=1e-15)).

    checkpoint_path makes a long run resumable (the reference dumps an
    intermediate model every second iteration, gmm.cc:622-630): EM runs in
    checkpoint_every-iteration segments, writing the reference text format
    after each and resuming from an existing file; the run stops between
    segments when the summed log-likelihood improves by less than the
    threshold."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: multi-device UBM training is not ported yet")
    from ..utils import serialization

    dt = getattr(torch, dtype)
    pooled = np.concatenate([np.asarray(f) for f in feature_arrays], axis=0)
    X = torch.as_tensor(pooled[None], dtype=dt, device=device)
    mask = torch.ones(X.shape[:2], dtype=torch.bool, device=device)

    if checkpoint_path is None:
        cfg = GmmConfig(n_mixtures=n_mixtures, n_iterations=n_iterations,
                        threshold=threshold)
        params, _ = gmm.fit(X, mask, cfg, seed)
        return _single(params)

    seg_cfg = GmmConfig(n_mixtures=n_mixtures, n_iterations=checkpoint_every,
                        threshold=0.0)
    if os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            params = gmm.params_to(serialization.load_reference_gmm(f), dt,
                                   device)
        params = gmm.GmmParams(*(a[None] for a in params))
    else:
        params = gmm.init_params(X, mask, n_mixtures, seed)

    last_ll = -np.finfo(np.float64).max
    done_iters = 0
    while done_iters < n_iterations:
        params, ll = gmm.fit_from_params(X, mask, params, seg_cfg)
        ll = float(ll[0])
        done_iters += checkpoint_every
        with open(checkpoint_path, "w") as f:
            serialization.dump_reference_gmm(_single(params), f)
        ll_diff = ll - last_ll
        if (abs(ll_diff) / max(abs(ll), 1e-300) < threshold
                and ll_diff < threshold):
            break
        last_ll = ll
    return _single(params)


def _single(params: gmm.GmmParams) -> gmm.GmmParams:
    """The one GMM of a 1-speaker bank, as numpy."""
    return gmm.params_numpy(gmm.GmmParams(*(a[0] for a in params)))


def adapt_speakers(ubm: gmm.GmmParams, speaker_features: dict,
                   cfg: GmmConfig | None = None, dtype="float32",
                   device: torch.device | str = "cuda"):
    """MAP-adapt every speaker ({label: [T_i, d] array}) from the UBM in one
    batched EM. Returns (labels, numpy bank). Mirrors adapt-ubm.py:25-36."""
    cfg = cfg or GmmConfig(n_mixtures=int(np.asarray(ubm.weights).shape[-1]))
    labels = list(speaker_features.keys())
    Xs, masks = _pad_stack([np.asarray(speaker_features[label])
                            for label in labels])
    dt = getattr(torch, dtype)
    bank, _ = gmm.fit_from_ubm(
        torch.as_tensor(Xs, dtype=dt, device=device),
        torch.as_tensor(masks, device=device),
        gmm.params_to(ubm, dt, device), cfg)
    return labels, gmm.params_numpy(bank)
