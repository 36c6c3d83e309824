"""The serving program: padded signals -> [B, S] bank scores.

predict = frontend kernel (ops/gpu_frontend: framing, packed DFT, mel, log,
DCT, CMVN, Levinson) -> bank-scoring kernel (ops/gpu_gmm: joint
log-density, per-speaker logsumexp, floor, masked mean). On CUDA tensors
both stages are the hand-written kernels, always; on CPU tensors both are
their plain torch versions.
"""

from __future__ import annotations

import torch

from ..config import FeatureConfig
from ..features import extract
from ..models.gmm import GmmBank
from ..ops import gpu_gmm

__all__ = ["predict_scores"]


def predict_scores(signals: torch.Tensor, lengths: torch.Tensor,
                   bank: GmmBank, fs: int,
                   cfg: FeatureConfig = FeatureConfig()) -> torch.Tensor:
    """[B, Lp] zero-padded signals, [B] lengths -> [B, S] per-speaker
    average log-likelihoods."""
    feats, mask = extract.extract_batch(signals, lengths, fs, cfg)
    return gpu_gmm.batch_bank_avg_loglik(bank, feats, mask)
