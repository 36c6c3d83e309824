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
    threshold.

    With a `mesh` (parallel/mesh.make_mesh; `device` is then the mesh's),
    every rank passes the same pooled features and fits its shard of the
    frames through parallel/mesh.sharded_fit, the statistics summed over
    the mesh; the result is the same on every rank, and only rank 0 writes
    the checkpoint."""
    from ..utils import serialization

    pooled = np.concatenate([np.asarray(f) for f in feature_arrays], axis=0)
    fit, writer = _ubm_fit(pooled, mesh, seed, dtype, device)
    if checkpoint_path is None:
        params, _ = fit(GmmConfig(n_mixtures=n_mixtures,
                                  n_iterations=n_iterations,
                                  threshold=threshold), None)
        return gmm.params_numpy(params)

    seg_cfg = GmmConfig(n_mixtures=n_mixtures, n_iterations=checkpoint_every,
                        threshold=0.0)
    params = None
    if os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            params = serialization.load_reference_gmm(f)
    last_ll = -np.finfo(np.float64).max
    done_iters = 0
    while done_iters < n_iterations:
        params, ll = fit(seg_cfg, params)
        ll = float(ll)
        done_iters += checkpoint_every
        if writer:
            with open(checkpoint_path, "w") as f:
                serialization.dump_reference_gmm(gmm.params_numpy(params), f)
        ll_diff = ll - last_ll
        if (abs(ll_diff) / max(abs(ll), 1e-300) < threshold
                and ll_diff < threshold):
            break
        last_ll = ll
    return gmm.params_numpy(params)


def _ubm_fit(pooled: np.ndarray, mesh, seed: int, dtype: str, device):
    """(fit(cfg, params0) -> (one GMM, log-likelihood), whether this process
    writes the checkpoint): EM from the seed's init when params0 is None,
    else from params0; on one device, or over a mesh through
    parallel/mesh.sharded_fit, where rank 0 writes."""
    if mesh is not None:
        import torch.distributed as dist

        from ..parallel import mesh as pmesh

        mask = np.ones(len(pooled), bool)

        def fit(cfg, params0):
            return pmesh.sharded_fit(mesh, cfg, dtype)(pooled, mask, seed,
                                                       params0)
        return fit, dist.get_rank() == 0

    dt = getattr(torch, dtype)
    X = torch.as_tensor(pooled[None], dtype=dt, device=device)
    mask = torch.ones(X.shape[:2], dtype=torch.bool, device=device)

    def fit(cfg, params0):
        if params0 is None:
            params, ll = gmm.fit(X, mask, cfg, seed)
        else:
            params, ll = gmm.fit_from_params(X, mask, gmm.GmmParams(*(
                a[None] for a in gmm.params_to(params0, dt, device))), cfg)
        return gmm.GmmParams(*(a[0] for a in params)), ll[0]
    return fit, True


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
