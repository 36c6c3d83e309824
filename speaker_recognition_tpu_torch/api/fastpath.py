"""The serving program: padded signals -> [B, S] bank scores.

predict = frontend (features/extract.frontend) -> bank-scoring kernel
(ops/gpu_gmm: joint log-density, per-speaker logsumexp, floor, masked
mean). The frontend takes one of three routes, each through its kernel in
ops/gpu_frontend:
  * packed, the default when fft_size >= 2*frame_len: the signal-level
    kernel (framing, packed DFT, mel, log, DCT, CMVN, Levinson);
  * packed with LPC cepstra (n_lpcc > 0): the same kernel without its
    Levinson (the raw autocorrelation comes out), then Levinson and the
    LPCC recursion in torch;
  * full spectrum, for fft_size < 2*frame_len (every rate above 32 kHz at
    the default config) and SRTPU_FRONTEND=full: window and pre-emphasis
    in torch, the full-spectrum kernel, then CMVN and LPC (or LPCC).
`mm="bf16"` rounds the frontend's DFT operands to bf16 (K1's bf16 mode on
the packed route, the plain bf16 product on the full route) and keeps the
scoring at f32, as the JAX package's predict_scores_fn(mm="bf16") does.
On CUDA tensors every stage is a hand-written kernel, always; on CPU
tensors each is its plain torch version. With a float64 bank (the parity
path) every stage is its plain version on either device, as in the JAX
package, counted in features/extract.F64_CALLS and ops/gpu_gmm.F64_CALLS.
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
                   cfg: FeatureConfig = FeatureConfig(),
                   mm: str = "f32") -> torch.Tensor:
    """[B, Lp] zero-padded signals, [B] lengths -> [B, S] per-speaker
    average log-likelihoods, at the bank's dtype (float32 or float64), the
    frontend's DFT operands at `mm` ("f32" or "bf16")."""
    dtype = str(bank.op.dtype).removeprefix("torch.")
    feats, mask = extract.extract_batch(signals, lengths, fs, cfg, dtype, mm)
    return gpu_gmm.batch_scores(bank, feats, mask)
