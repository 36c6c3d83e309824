"""Diagonal-covariance GMM speaker bank: parameters and batched scoring.

Mirrors the serving half of speaker_recognition_tpu/models/gmm.py. The
per-frame, per-component joint log-density of a bank is one product

    logp[t, (s,k)] = [x_t^2 | x_t] @ op + cw,
    op = [-1/(2 sigma^2) | mu/sigma^2]^T,
    cw = -1/2 sum_d mu^2/sigma^2 - sum_d log(sqrt(2 pi) sigma) + log w,

followed by a per-speaker logsumexp over the K components, the reference's
underflow floor (gmm.cc:482-492) and a masked per-utterance mean.
`GmmBank` holds (op, cw) on a device; `batch_bank_avg_loglik` here is the
plain torch version that ops/gpu_gmm's kernel is held to.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

LOG_SQRT_2_PI = 0.5 * math.log(2.0 * math.pi)
# log-space equivalent of the reference's linear-space 1e-15 floor, which
# engages only when the sum of w_k N(x) underflows double precision
_UNDERFLOW_LOG = -745.0


class GmmParams(NamedTuple):
    """weights [..., K], means [..., K, d], sigmas [..., K, d] (numpy);
    leading axes, if any, are a speaker bank."""

    weights: np.ndarray
    means: np.ndarray
    sigmas: np.ndarray

    @property
    def n_mixtures(self) -> int:
        return self.weights.shape[-1]


def stack_params(params_list) -> GmmParams:
    """Stack per-speaker GmmParams into a bank with a leading S axis."""
    return GmmParams(*(np.stack([np.asarray(getattr(p, f))
                                 for p in params_list])
                       for f in GmmParams._fields))


def bank_operators(bank: GmmParams):
    """Fold a bank into its joint-log-density operator, in float64:
    (op [2d, S*K], cw [S*K])."""
    w = np.asarray(bank.weights, np.float64)
    mu = np.asarray(bank.means, np.float64)
    sig = np.asarray(bank.sigmas, np.float64)
    S, K = w.shape
    d = mu.shape[-1]
    inv_var = 1.0 / (sig * sig)
    op = np.concatenate([-0.5 * inv_var, mu * inv_var],
                        axis=-1).reshape(S * K, 2 * d).T
    cw = (-0.5 * np.sum(mu ** 2 * inv_var, axis=-1)
          - np.sum(LOG_SQRT_2_PI + np.log(sig), axis=-1)
          + np.log(w)).reshape(S * K)
    return op, cw


class GmmBank(nn.Module):
    """A speaker bank of S GMMs with K components each, as the buffers
    op [2d, S*K] and cw [S*K] (float32) on one device."""

    def __init__(self, op: torch.Tensor, cw: torch.Tensor, n_speakers: int,
                 n_mixtures: int):
        super().__init__()
        if op.shape[1] != n_speakers * n_mixtures or op.shape[0] % 2:
            raise ValueError(f"op {tuple(op.shape)} does not fit "
                             f"S={n_speakers}, K={n_mixtures}")
        self.register_buffer("op", op.contiguous())
        self.register_buffer("cw", cw.contiguous())
        self.n_speakers = n_speakers
        self.n_mixtures = n_mixtures

    @property
    def dim(self) -> int:
        return self.op.shape[0] // 2

    @classmethod
    def from_numpy(cls, weights, means, sigmas,
                   device: torch.device | str) -> "GmmBank":
        """From a bank's arrays (weights [S, K], means/sigmas [S, K, d]),
        e.g. the GmmParams of either package's session."""
        params = GmmParams(np.asarray(weights), np.asarray(means),
                           np.asarray(sigmas))
        S, K = params.weights.shape
        op, cw = bank_operators(params)
        to = dict(dtype=torch.float32, device=device)
        return cls(torch.as_tensor(op, **to), torch.as_tensor(cw, **to), S, K)


def batch_bank_avg_loglik(bank: GmmBank, feats: torch.Tensor,
                          mask: torch.Tensor,
                          min_prob_sum: float = 1e-15) -> torch.Tensor:
    """[B, T, d] features, [B, T] mask -> [B, S] masked per-frame average
    log-likelihoods (src/testbench/gmmset.py:96-100), plain torch."""
    B, T, d = feats.shape
    S, K = bank.n_speakers, bank.n_mixtures
    Z = torch.cat([feats * feats, feats], dim=-1).reshape(B * T, 2 * d)
    logp = Z @ bank.op + bank.cw
    lse = torch.logsumexp(logp.reshape(B, T, S, K), dim=-1)
    lse = torch.where(lse > _UNDERFLOW_LOG, lse,
                      torch.full_like(lse, math.log(min_prob_sum)))
    m = mask.to(feats.dtype)
    n = torch.clamp_min(m.sum(dim=-1), 1.0)
    return torch.einsum("bts,bt->bs", lse, m) / n[:, None]
