"""The serving program: padded signals -> [B, S] bank scores.

predict = frontend (features/extract.frontend) -> bank-scoring kernel
(ops/gpu_gmm: joint log-density, per-speaker logsumexp, floor, masked
mean). The frontend takes one of three routes, each through its kernel in
ops/gpu_frontend:
  * packed, the default when fft_size >= 2*frame_len: the signal-level
    kernel (framing, packed DFT, mel, log, DCT, CMVN, Levinson);
  * packed with LPC cepstra (n_lpcc > 0): the frame-level packed kernel,
    then CMVN, Levinson and the LPCC recursion in torch;
  * full spectrum, for fft_size < 2*frame_len (every rate above 32 kHz at
    the default config) and SRTPU_FRONTEND=full: window and pre-emphasis
    in torch, the full-spectrum kernel, then CMVN and LPC (or LPCC).
On CUDA tensors every stage is a hand-written kernel, always; on CPU
tensors each is its plain torch version.
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
