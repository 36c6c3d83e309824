"""Speaker-bank scoring: CUDA kernels and their plain torch versions.

Batched: `batch_bank_avg_loglik` launches csrc/gmm_score.cu and maps
[B, T, d] features and a [B, T] mask to [B, S] masked per-frame average
log-likelihoods. Serial: `bank_sum_loglik` / `bank_avg_loglik` launch
csrc/gmm_serial.cu and map one utterance [n, d] with mask [n] to [S] sums
or averages. All apply the reference's -745 -> log(1e-15) underflow floor.
Each runs its kernel on a CUDA tensor and its plain version (`*_reference`,
from models/gmm) on a CPU tensor; any other device raises.

Both kernels are bound by FP32 operations (2*d FMAs per frame and
component) and share one inner loop (csrc/gmm_lse.cuh): a lane keeps its
frames in registers, the bank's components arrive as 16-byte rows
(`GmmBank.component_operator`, packed once per bank) that stream through
shared memory in chunks, and the logsumexp runs online across chunks. So
neither the feature dimension nor the number of components has a cap:
past a padded d of 128 the frame stays in device memory (a route chosen
on the shape, no fallback). The only limits are the grid's: at most 65535
utterances a batched call and 65535 speakers a serial call. Every sum
runs in a fixed order with no atomics: two calls give the same bits.
"""

from __future__ import annotations

import torch

from .. import _build
from ..models.gmm import GmmBank
from ..models.gmm import (
    bank_sum_loglik as bank_sum_loglik_reference,
    bank_avg_loglik as bank_avg_loglik_reference,
    batch_bank_avg_loglik as batch_bank_avg_loglik_reference)

# kernel launches since the last reset, batched (gmm_score.cu) and serial
# (gmm_serial.cu); the CPU path does not count
LAUNCHES = 0
SERIAL_LAUNCHES = 0

_MAX_GRID_Y = 65535

__all__ = ["LAUNCHES", "SERIAL_LAUNCHES", "bank_avg_loglik",
           "bank_avg_loglik_reference", "bank_sum_loglik",
           "bank_sum_loglik_reference", "batch_bank_avg_loglik",
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
    comp = bank.component_operator(lib.srt_component_row(d))
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    global LAUNCHES
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.srt_bank_scratch_floats(B, T, d, S),
                              dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_bank_avg_loglik(
            feats.data_ptr(), mask.data_ptr(), comp.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, T, d, S, K, stream)
    _build.check(err, "bank scoring kernel")
    LAUNCHES += 1
    return out


def _serial(bank: GmmBank, X: torch.Tensor, mask: torch.Tensor,
            avg: bool) -> torch.Tensor:
    """Launch csrc/gmm_serial.cu on one utterance: [S] sums or averages."""
    dev = X.device
    _build.check_tensor(X, "X", torch.float32, 2, dev)
    _build.check_tensor(mask, "mask", torch.bool, 1, dev)
    _build.check_tensor(bank.op, "bank.op", torch.float32, 2, dev)
    _build.check_tensor(bank.cw, "bank.cw", torch.float32, 1, dev)
    n, d = X.shape
    S, K = bank.n_speakers, bank.n_mixtures
    if mask.shape[0] != n or bank.dim != d or S > _MAX_GRID_Y:
        raise ValueError(f"mask {tuple(mask.shape)} must be [{n}], bank dim "
                         f"{bank.dim} must be {d}, speakers {S} <= "
                         f"{_MAX_GRID_Y}")
    lib = _build.load()
    comp = bank.component_operator(lib.srt_component_row(d))
    partial = torch.empty((S, lib.srt_serial_chunks(n), 2),
                          dtype=torch.float32, device=dev)
    out = torch.empty(S, dtype=torch.float32, device=dev)
    global SERIAL_LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_bank_sum_loglik(
            X.data_ptr(), mask.data_ptr(), comp.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, d, S, K, int(avg), stream)
    _build.check(err, "serial bank scoring kernel")
    SERIAL_LAUNCHES += 1
    return out


def bank_sum_loglik(bank: GmmBank, X: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """[n, d] f32 utterance, [n] bool mask -> [S] f32 sums of per-frame
    log-likelihoods over the valid frames."""
    if X.device.type == "cpu":
        return bank_sum_loglik_reference(bank, X, mask)
    if X.device.type != "cuda":
        raise ValueError(f"no bank scoring for device {X.device}")
    return _serial(bank, X, mask, avg=False)


def bank_avg_loglik(bank: GmmBank, X: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """[n, d] f32 utterance, [n] bool mask -> [S] f32 per-frame averages,
    sums / max(valid frames, 1): what GMMSet ranks speakers by."""
    if X.device.type == "cpu":
        return bank_avg_loglik_reference(bank, X, mask)
    if X.device.type != "cuda":
        raise ValueError(f"no bank scoring for device {X.device}")
    return _serial(bank, X, mask, avg=True)
