"""Batched MFCC+LPC feature extraction (src/feature/{__init__,MFCC,LPC}.py).

The port serves both frontends of speaker_recognition_tpu's
features/extract.py, and `frontend(fs, cfg, device)` picks one as the JAX
package does (extract.py:211): the packed frontend when SRTPU_FRONTEND is
"packed" (the default) and fft_size >= 2*frame_len, else the full-spectrum
frontend.

- `PackedFrontend`: the window, pre-emphasis and a 2*frame_len-point DFT
  fold into one operator D, and everything after the squaring is linear in
  the power spectrum (speaker_recognition_tpu.ops.frontend.
  packed_frontend_operators). Without LPC cepstra the signal-level kernel
  (ops/gpu_frontend.packed_from_signals) does framing, CMVN and Levinson
  too; with them (n_lpcc > 0) the frame-level kernel
  (packed_from_frames) gives the raw autocorrelation that the LPCC
  recursion takes.
- `FullFrontend`: the reference's own fft_size-point power spectrum of
  windowed, pre-emphasized frames (mfcc_from_frames). It serves
  SRTPU_FRONTEND=full and every fft_size < 2*frame_len, i.e. every sample
  rate above 32 kHz at the default 2048-point FFT and 32 ms frames.
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
from ..ops import framing, gpu_frontend, levinson
from ..ops.gpu_frontend import masked_cmvn

__all__ = ["LENGTH_BUCKET", "FullFrontend", "PackedFrontend", "apply_deltas",
           "extract_batch", "frontend", "frontend_mode", "lpc_extract",
           "masked_cmvn", "mfcc_extract", "mix_feature", "signal_too_short"]

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


def _mel_dct(fs: int, mf: MfccConfig):
    """The float64 mel bank [fft/2+1, n_mel] and DCT [n_mel, n_ceps] (c0
    dropped, MFCC.py:36-38)."""
    if mf.f_max is not None:
        mel = operators.mel_filterbank_bounded(
            fs, mf.fft_size, mf.n_filters, mf.f_min, mf.f_max, mf.mel_scale)
    else:
        mel = operators.mel_filterbank(fs, mf.fft_size, mf.n_filters)
    return mel.T, operators.dct_matrix(mf.n_filters)[1:mf.n_ceps + 1].T


class _Frontend(nn.Module):
    """What both frontends share: the frame geometry, the floor, and the
    steps after a frame-level kernel (CMVN, LPC or LPC cepstra, deltas,
    masking)."""

    def __init__(self, fs: int, cfg: FeatureConfig):
        super().__init__()
        mf, lp = cfg.mfcc, cfg.lpc
        flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
        if cfg.use_lpc:
            if frame_geometry(fs, lp.win_length_ms,
                              lp.win_shift_ms) != (flen, fshift):
                raise ValueError("MFCC and LPC must share frame geometry "
                                 "(src/feature/__init__.py:25-30)")
            if lp.pre_emph != mf.pre_emph:
                raise ValueError("MFCC and LPC must share pre-emphasis")
        self.frame_len, self.frame_shift = flen, fshift
        # the reference's 1e-100 floor is below the f32 range; 1e-35 is the
        # JAX package's clamp (features/extract.py:194-199)
        self.floor = max(mf.power_floor, 1e-35)
        self.cmvn = mf.cmvn
        self.n_deltas = cfg.n_deltas
        self.use_lpc = cfg.use_lpc
        self.n_lpcc = lp.n_lpcc if cfg.use_lpc else 0
        self.lpc_order = lp.n_lpc

    def _register(self, device, **ops):
        """The float64 numpy operators as float32 buffers on `device`."""
        for name, op in ops.items():
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(op), dtype=torch.float32, device=device))

    def valid_frames(self, lengths: torch.Tensor, T: int) -> torch.Tensor:
        """[B] lengths -> [B] int32 count of frames wholly inside each
        signal, at most T (JAX features/extract.py:252-254)."""
        lengths = lengths.to(torch.int64)
        n = torch.div(lengths - self.frame_len, self.frame_shift,
                      rounding_mode="floor") + 1
        return torch.where(lengths >= self.frame_len, n,
                           torch.zeros_like(n)).clamp(max=T).to(torch.int32)

    def _frames(self, signals: torch.Tensor, lengths: torch.Tensor):
        """(contiguous f32 signals, T, [B, T] frame mask)."""
        signals = signals.to(torch.float32).contiguous()
        T = n_frames(signals.shape[-1], self.frame_len, self.frame_shift)
        mask = framing.frame_validity_mask(lengths.to(signals.device), T,
                                           self.frame_len, self.frame_shift)
        return signals, T, mask

    def finish(self, ceps: torch.Tensor, r: torch.Tensor,
               mask: torch.Tensor):
        """[B, T, n_ceps] pre-CMVN cepstra and [B, T, order+1] raw
        autocorrelation (zero-width without LPC) -> ([B, T', d] features,
        [B, T'] mask), as speaker_recognition_tpu/features/extract.py:335-350:
        masked CMVN; LPC, or Levinson -> LPC cepstra -> non-finite to 0
        (no lpc_from_autocorr first: an all-zero frame gives 0 cepstra);
        deltas; zeros past each utterance's valid frames."""
        if self.cmvn:
            ceps = masked_cmvn(ceps, mask)
        parts = [ceps]
        if self.use_lpc:
            if self.n_lpcc > 0:
                a, _ = levinson.levinson(r)
                parts.append(torch.nan_to_num(
                    levinson.lpcc_from_lpc(a, self.n_lpcc), nan=0.0,
                    posinf=0.0, neginf=0.0))
            else:
                parts.append(levinson.lpc_from_autocorr(r))
        feat, mask = apply_deltas(torch.cat(parts, dim=-1), mask,
                                  self.n_deltas)
        return torch.where(mask[..., None], feat, torch.zeros_like(feat)), mask


class PackedFrontend(_Frontend):
    """The packed frontend of one (fs, FeatureConfig) on one device: buffers
    D [flen, 2*flen], W [2*flen, n_mel], dct [n_mel, n_ceps] and
    A [2*flen, order+1] (zero columns without LPC). Needs
    fft_size >= 2*frame_len."""

    def __init__(self, fs: int, cfg: FeatureConfig,
                 device: torch.device | str = "cpu"):
        super().__init__(fs, cfg)
        mf = cfg.mfcc
        if mf.fft_size < 2 * self.frame_len:
            raise ValueError(
                f"fft_size {mf.fft_size} < 2*frame_len {2 * self.frame_len}: "
                "the packed frontend cannot express it; frontend() serves "
                "it with FullFrontend")
        mel, dct = _mel_dct(fs, mf)
        D, W, A = operators.packed_frontend_operators(
            self.frame_len, mf.fft_size, mf.pre_emph, mel,
            lpc_order=self.lpc_order if cfg.use_lpc else None,
            preemph_first=mf.preemph_first)
        if A is None:
            A = np.zeros((D.shape[1], 0))
        self._register(device, D=D, W=W, dct=dct, A=A)

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """[B, Lp] zero-padded signals, [B] lengths -> ([B, T', d] features,
        [B, T'] mask); zeros past each utterance's valid frames."""
        signals, T, mask = self._frames(signals, lengths)
        if self.n_lpcc > 0:
            B = signals.shape[0]
            frames = framing.frame_signal(signals, self.frame_len,
                                          self.frame_shift)
            # a copy: for B = 1 the reshape is a strided view of the signal
            ceps, r = gpu_frontend.packed_from_frames(
                frames.reshape(B * T, self.frame_len).contiguous(), self.D,
                self.W, self.dct, self.floor, self.A)
            return self.finish(ceps.view(B, T, -1), r.view(B, T, -1), mask)
        n_valid = self.valid_frames(lengths.to(signals.device), T)
        feat = gpu_frontend.packed_from_signals(
            signals, n_valid, self.D, self.W, self.dct, self.A, self.floor,
            self.frame_shift, self.cmvn)
        if self.n_deltas:
            feat, mask = apply_deltas(feat, mask, self.n_deltas)
            feat = torch.where(mask[..., None], feat, torch.zeros_like(feat))
        return feat, mask


class FullFrontend(_Frontend):
    """The full-spectrum frontend of one (fs, FeatureConfig) on one device:
    buffers C, S [flen, nb] (the cos/sin DFT projections), mel [nb, n_mel],
    dct [n_mel, n_ceps] and acorr [nb, order+1] (zero columns without LPC),
    nb = fft/2+1 rounded up to a multiple of 4, as speaker_recognition_tpu/
    features/extract.py:306-350."""

    def __init__(self, fs: int, cfg: FeatureConfig,
                 device: torch.device | str = "cpu"):
        super().__init__(fs, cfg)
        mf = cfg.mfcc
        C, S = operators.dft_power_projection(self.frame_len, mf.fft_size)
        # the autocorrelation is power @ acorr even when fft_size <
        # 2*frame_len, as in the JAX package: circular aliasing starts at lag
        # fft_size - frame_len + 1 (513 at 48 kHz), far past the LPC order
        acorr = (levinson.autocorr_operator(self.frame_len, mf.fft_size,
                                            self.lpc_order)
                 if cfg.use_lpc else np.zeros((C.shape[1], 0)))
        mel, dct = _mel_dct(fs, mf)
        # bins padded to a multiple of 4 (16-byte rows for the kernel's
        # copies): zero DFT columns whose mel and autocorrelation rows are
        # zero, so they add nothing to either
        pad = -C.shape[1] % 4
        C, S = (np.pad(x, ((0, 0), (0, pad))) for x in (C, S))
        mel, acorr = (np.pad(x, ((0, pad), (0, 0))) for x in (mel, acorr))
        self._register(device, C=C, S=S, mel=mel, dct=dct, acorr=acorr)
        self.pre_emph = mf.pre_emph
        self.preemph_first = mf.preemph_first

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """[B, Lp] zero-padded signals, [B] lengths -> ([B, T', d] features,
        [B, T'] mask); zeros past each utterance's valid frames."""
        signals, T, mask = self._frames(signals, lengths)
        B = signals.shape[0]
        wp = framing.window_preemph(
            framing.frame_signal(signals, self.frame_len, self.frame_shift),
            self.frame_len, self.pre_emph, self.preemph_first)
        ceps, r = gpu_frontend.mfcc_from_frames(
            wp.reshape(B * T, self.frame_len), self.C, self.S, self.mel,
            self.dct, self.floor, self.acorr)
        return self.finish(ceps.view(B, T, -1), r.view(B, T, -1), mask)


def frontend_mode() -> str:
    """SRTPU_FRONTEND: "packed" (the default) or "full", as in the JAX
    package (features/extract.py:56-66)."""
    mode = os.environ.get("SRTPU_FRONTEND", "packed")
    if mode not in ("packed", "full"):
        raise ValueError(f"SRTPU_FRONTEND={mode!r}: expected packed or full")
    return mode


def frontend(fs: int, cfg: FeatureConfig,
             device: torch.device | str) -> _Frontend:
    """The frontend of (fs, cfg) on `device` under the current
    SRTPU_FRONTEND, built once per (fs, cfg, device, mode)."""
    return _frontend(int(fs), cfg, torch.device(device), frontend_mode())


@functools.lru_cache(maxsize=16)
def _frontend(fs: int, cfg: FeatureConfig, device: torch.device,
              mode: str) -> _Frontend:
    flen, _ = frame_geometry(fs, cfg.mfcc.win_length_ms,
                             cfg.mfcc.win_shift_ms)
    if mode == "packed" and cfg.mfcc.fft_size >= 2 * flen:
        return PackedFrontend(fs, cfg, device)
    return FullFrontend(fs, cfg, device)


def extract_batch(signals: torch.Tensor, lengths: torch.Tensor, fs: int,
                  cfg: FeatureConfig = FeatureConfig()):
    """Features for a zero-padded batch: [B, L] -> ([B, T, d], [B, T] mask)."""
    return frontend(fs, cfg, signals.device)(signals, lengths)


def mix_feature(fs: int, signal, cfg: FeatureConfig = FeatureConfig(),
                dtype: str = "float32",
                device: torch.device | str = "cpu") -> np.ndarray:
    """One utterance's concat(MFCC, LPC) per frame, [T - n_deltas, d] numpy
    (src/feature/__init__.py:25-30). Int or float PCM; multi-channel input
    is averaged (MFCC.py:52-54). The signal is padded to LENGTH_BUCKET in
    float32 and runs through the frontend of (fs, cfg) on `device`."""
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
