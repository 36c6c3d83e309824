"""Speaker-bank scoring: CUDA kernel and its plain torch version.

`batch_bank_avg_loglik` launches csrc/gmm_score.cu on a CUDA tensor and
runs `batch_bank_avg_loglik_reference` (models/gmm.batch_bank_avg_loglik)
on a CPU tensor; any other device raises. Both map [B, T, d] features and a
[B, T] mask against a GmmBank to [B, S] masked per-frame average
log-likelihoods, with the reference's -745 -> log(1e-15) underflow floor.
"""

from __future__ import annotations

import torch

from .. import _build
from ..models.gmm import GmmBank
from ..models.gmm import (
    batch_bank_avg_loglik as batch_bank_avg_loglik_reference)

# kernel launches since the last reset; the CPU path does not count
LAUNCHES = 0

_MAX_SMEM = 232448   # bytes of shared memory a block may use on sm_90
_MAX_GRID_Y = 65535

__all__ = ["LAUNCHES", "batch_bank_avg_loglik",
           "batch_bank_avg_loglik_reference"]


def batch_bank_avg_loglik(bank: GmmBank, feats: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """[B, T, d] f32 features, [B, T] bool mask -> [B, S] f32."""
    if feats.device.type == "cpu":
        return batch_bank_avg_loglik_reference(bank, feats, mask)
    if feats.device.type != "cuda":
        raise ValueError(f"no bank scoring for device {feats.device}")
    dev = feats.device
    _build.check_tensor(feats, "feats", torch.float32, 3, dev)
    _build.check_tensor(mask, "mask", torch.bool, 2, dev)
    _build.check_tensor(bank.op, "bank.op", torch.float32, 2, dev)
    _build.check_tensor(bank.cw, "bank.cw", torch.float32, 1, dev)
    B, T, d = feats.shape
    S, K = bank.n_speakers, bank.n_mixtures
    if tuple(mask.shape) != (B, T) or bank.dim != d or B > _MAX_GRID_Y:
        raise ValueError(f"mask {tuple(mask.shape)} must be [{B}, {T}], "
                         f"bank dim {bank.dim} must be {d}, batch "
                         f"{B} <= {_MAX_GRID_Y}")
    lib = _build.load()
    smem = lib.srt_gmm_smem_bytes(d, K)
    if smem > _MAX_SMEM:
        raise ValueError(f"bank block needs {smem} bytes of shared memory "
                         f"(> {_MAX_SMEM}) at K={K}, d={d}")
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_bank_avg_loglik(
            feats.data_ptr(), mask.data_ptr(), bank.op.data_ptr(),
            bank.cw.data_ptr(), out.data_ptr(), B, T, d, S, K, stream)
    _build.check(err, "bank scoring kernel")
    LAUNCHES += 1
    return out
