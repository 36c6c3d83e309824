"""Batched MFCC+LPC feature extraction (src/feature/{__init__,MFCC,LPC}.py).

The port serves the packed frontend of speaker_recognition_tpu's
features/extract.py: the window, pre-emphasis and a 2*frame_len-point DFT
fold into one operator D, and everything after the squaring is linear in
the power spectrum (speaker_recognition_tpu.ops.frontend.
packed_frontend_operators), so a frame's MFCC and LPC are three chained
products plus a log and a Levinson recursion. `PackedFrontend` holds those
operators on a device and runs them through ops/gpu_frontend. A config the
packed frontend cannot express raises NotImplementedError; it is never
served by another path.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn

from speaker_recognition_tpu.ops import frontend as operators

from ..config import (FeatureConfig, LpcConfig, MfccConfig, frame_geometry,
                      n_frames)
from ..ops import framing, gpu_frontend
from ..ops.gpu_frontend import masked_cmvn

__all__ = ["LENGTH_BUCKET", "PackedFrontend", "apply_deltas", "extract_batch",
           "lpc_extract", "masked_cmvn", "mfcc_extract", "mix_feature",
           "packed_frontend", "signal_too_short"]

# Signals are zero-padded to a multiple of this many samples.
LENGTH_BUCKET = 4096


def apply_deltas(feat: torch.Tensor, mask: torch.Tensor, nd: int):
    """The reference's diff_feature row semantics on a masked padded batch
    (src/feature/utils.py:24-31): nd frames are consumed from the front.
    Columns come out as [mfcc, lpc, d_mfcc, d_lpc], as in the JAX package."""
    if nd == 0:
        return feat, mask
    d1 = feat[..., 1:, :] - feat[..., :-1, :]
    if nd == 1:
        return torch.cat([feat[..., 1:, :], d1], dim=-1), mask[..., 1:]
    if nd == 2:
        d2 = d1[..., 1:, :] - d1[..., :-1, :]
        return (torch.cat([feat[..., 2:, :], d1[..., 1:, :], d2], dim=-1),
                mask[..., 2:])
    raise ValueError(f"n_deltas must be 0, 1 or 2, got {nd}")


def signal_too_short(fs: int, cfg: FeatureConfig, n_samples: int) -> bool:
    """The reference's minimum-length rule (MFCC.py:56: <= 5 frame lengths
    raises 'Signal too short!')."""
    flen, _ = frame_geometry(fs, cfg.mfcc.win_length_ms,
                             cfg.mfcc.win_shift_ms)
    return n_samples <= 5 * flen


class PackedFrontend(nn.Module):
    """The packed frontend of one (fs, FeatureConfig) on one device: buffers
    D [flen, 2*flen], W [2*flen, n_mel], dct [n_mel, n_ceps] and
    A [2*flen, order+1] (zero columns without LPC)."""

    def __init__(self, fs: int, cfg: FeatureConfig,
                 device: torch.device | str = "cpu"):
        super().__init__()
        mf, lp = cfg.mfcc, cfg.lpc
        flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
        if os.environ.get("SRTPU_FRONTEND", "packed") == "full":
            raise NotImplementedError(
                "SRTPU_FRONTEND=full: the full-spectrum frontend is not "
                "ported; only the packed frontend is")
        if mf.fft_size < 2 * flen:
            raise NotImplementedError(
                f"fft_size {mf.fft_size} < 2*frame_len {2 * flen}: the packed "
                "frontend needs fft_size >= 2*frame_len")
        if cfg.use_lpc:
            if lp.n_lpcc > 0:
                raise NotImplementedError(
                    "n_lpcc > 0: LPC cepstra are not ported; the frontend "
                    "emits raw LPC coefficients only")
            if frame_geometry(fs, lp.win_length_ms,
                              lp.win_shift_ms) != (flen, fshift):
                raise ValueError("MFCC and LPC must share frame geometry "
                                 "(src/feature/__init__.py:25-30)")
            if lp.pre_emph != mf.pre_emph:
                raise ValueError("MFCC and LPC must share pre-emphasis")
        if mf.f_max is not None:
            mel = operators.mel_filterbank_bounded(
                fs, mf.fft_size, mf.n_filters, mf.f_min, mf.f_max,
                mf.mel_scale).T
        else:
            mel = operators.mel_filterbank(fs, mf.fft_size, mf.n_filters).T
        dct = operators.dct_matrix(mf.n_filters)[1:mf.n_ceps + 1].T
        D, W, A = operators.packed_frontend_operators(
            flen, mf.fft_size, mf.pre_emph, mel,
            lpc_order=lp.n_lpc if cfg.use_lpc else None,
            preemph_first=mf.preemph_first)
        if A is None:
            A = np.zeros((D.shape[1], 0))
        to = dict(dtype=torch.float32, device=device)
        for name, op in (("D", D), ("W", W), ("dct", dct), ("A", A)):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(op), **to))
        self.frame_len, self.frame_shift = flen, fshift
        # the reference's 1e-100 floor is below the f32 range; 1e-35 is the
        # JAX package's clamp (features/extract.py:194-199)
        self.floor = max(mf.power_floor, 1e-35)
        self.cmvn = mf.cmvn
        self.n_deltas = cfg.n_deltas

    def valid_frames(self, lengths: torch.Tensor, T: int) -> torch.Tensor:
        """[B] lengths -> [B] int32 count of frames wholly inside each
        signal, at most T (JAX features/extract.py:252-254)."""
        lengths = lengths.to(torch.int64)
        n = torch.div(lengths - self.frame_len, self.frame_shift,
                      rounding_mode="floor") + 1
        return torch.where(lengths >= self.frame_len, n,
                           torch.zeros_like(n)).clamp(max=T).to(torch.int32)

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """[B, Lp] zero-padded signals, [B] lengths -> ([B, T', d] features,
        [B, T'] mask); zeros past each utterance's valid frames."""
        signals = signals.to(torch.float32).contiguous()
        T = n_frames(signals.shape[-1], self.frame_len, self.frame_shift)
        n_valid = self.valid_frames(lengths.to(signals.device), T)
        feat = gpu_frontend.packed_from_signals(
            signals, n_valid, self.D, self.W, self.dct, self.A, self.floor,
            self.frame_shift, self.cmvn)
        mask = framing.frame_validity_mask(lengths.to(signals.device), T,
                                           self.frame_len, self.frame_shift)
        if self.n_deltas:
            feat, mask = apply_deltas(feat, mask, self.n_deltas)
            feat = torch.where(mask[..., None], feat, torch.zeros_like(feat))
        return feat, mask


@functools.lru_cache(maxsize=16)
def packed_frontend(fs: int, cfg: FeatureConfig,
                    device: torch.device) -> PackedFrontend:
    """The PackedFrontend of (fs, cfg) on `device`, built once."""
    return PackedFrontend(fs, cfg, device)


def extract_batch(signals: torch.Tensor, lengths: torch.Tensor, fs: int,
                  cfg: FeatureConfig = FeatureConfig()):
    """Features for a zero-padded batch: [B, L] -> ([B, T, d], [B, T] mask)."""
    return packed_frontend(int(fs), cfg, signals.device)(signals, lengths)


def mix_feature(fs: int, signal, cfg: FeatureConfig = FeatureConfig(),
                dtype: str = "float32",
                device: torch.device | str = "cpu") -> np.ndarray:
    """One utterance's concat(MFCC, LPC) per frame, [T - n_deltas, d] numpy
    (src/feature/__init__.py:25-30). Int or float PCM; multi-channel input
    is averaged (MFCC.py:52-54). The signal is padded to LENGTH_BUCKET in
    float32 and runs through the packed frontend on `device`."""
    if dtype != "float32":
        raise NotImplementedError(
            f"dtype {dtype!r}: the port extracts features in float32 only")
    signal = np.asarray(signal, dtype=np.float64)
    if signal.ndim > 1:
        signal = signal.mean(axis=1)
    if signal_too_short(fs, cfg, len(signal)):
        raise ValueError("Signal too short!")  # MFCC.py:56
    mf = cfg.mfcc
    T = n_frames(len(signal), *frame_geometry(fs, mf.win_length_ms,
                                              mf.win_shift_ms))
    padded = np.zeros((1, -(-len(signal) // LENGTH_BUCKET) * LENGTH_BUCKET),
                      np.float32)
    padded[0, :len(signal)] = signal
    device = torch.device(device)
    feat, _ = extract_batch(torch.from_numpy(padded).to(device),
                            torch.tensor([len(signal)], device=device), fs,
                            cfg)
    return feat[0, :T - cfg.n_deltas].cpu().numpy()


def mfcc_extract(fs: int, signal, cfg: MfccConfig = MfccConfig(),
                 dtype: str = "float32",
                 device: torch.device | str = "cpu") -> np.ndarray:
    """MFCC only (src/feature/MFCC.py:extract)."""
    return mix_feature(fs, signal, FeatureConfig(mfcc=cfg, use_lpc=False),
                       dtype, device)


def lpc_extract(fs: int, signal, cfg: LpcConfig = LpcConfig(),
                dtype: str = "float32",
                device: torch.device | str = "cpu") -> np.ndarray:
    """LPC only (src/feature/LPC.py:extract)."""
    fcfg = FeatureConfig(
        mfcc=MfccConfig(win_length_ms=cfg.win_length_ms,
                        win_shift_ms=cfg.win_shift_ms, pre_emph=cfg.pre_emph),
        lpc=cfg, use_lpc=True)
    return mix_feature(fs, signal, fcfg, dtype, device)[:, fcfg.mfcc.n_ceps:]
