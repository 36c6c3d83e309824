"""Batched MFCC+LPC feature extraction (src/feature/{__init__,MFCC,LPC}.py).

The port serves both frontends of speaker_recognition_tpu's
features/extract.py, and `frontend(fs, cfg, device)` picks one as the JAX
package does (extract.py:211): the packed frontend when SRTPU_FRONTEND is
"packed" (the default) and fft_size >= 2*frame_len, else the full-spectrum
frontend.

- `PackedFrontend`: everything after the squaring is linear in the power
  spectrum of a short transform. The signal-level kernel
  (ops/gpu_frontend.packed_from_signals) does framing, CMVN and Levinson
  too; on the card it runs an FFT of rfft_size(frame_len) points with the
  bin-domain operators of ops/frontend.fft_packed_operators (the `fft`
  route), on the CPU its plain version with the dense packed operators D,
  W, A (ops/frontend.packed_frontend_operators: window, pre-emphasis and
  a 2*frame_len-point DFT folded into D). With LPC cepstra (n_lpcc > 0)
  the same kernel's LPC-cepstra mode runs the recursion after the Levinson
  on the card, in one call; the bf16 kernel (mm="bf16"), which has no such
  mode, returns the
  raw autocorrelation (`fuse_lpc=False`, the JAX kernel's route,
  features/extract.py:255-297), and Levinson and the recursion follow in
  torch. The fused
  predict monolith (ops/gpu_predict) takes the `fft` route on the card
  and reads D, W, A for its CPU plain version and its bf16 route.
- `FullFrontend`: the reference's own fft_size-point power spectrum of
  windowed, pre-emphasized frames. It serves SRTPU_FRONTEND=full and every
  fft_size < 2*frame_len, i.e. every sample rate above 32 kHz at the
  default 2048-point FFT and 32 ms frames. At float32 with f32 operands
  and a power-of-two fft_size below 32768 it runs
  ops/gpu_frontend.mfcc_from_signals, which frames the signals, normalizes
  and computes the LPC columns itself (on the card one kernel, csrc/
  frontend_full_signals.cu); every other route (an fft_size that is not a
  power of two, 32768 points or more, bf16 operands, float64) frames the
  signals in torch, runs a frame-level kernel (mfcc_from_frames) or its
  plain version, and the tail in torch (`finish`).

Both take `mm`, the DFT product's operand precision of the JAX
extractor's `matmul_dtype` (features/extract.py:166-167): "f32", or "bf16",
which rounds the frames and the DFT operator to bf16 and sums in f32. It
applies at float32 only, as in the JAX package; at float64 the float64
route runs unchanged. On the packed route bf16 takes K1's bf16 mode (the
dense product, so the frontend builds D, W, A at any size); on the full
route the JAX package computes the bf16 product outside any kernel, and so
does the port (ops/gpu_frontend.mfcc_from_frames_bf16, plain torch on
either device, K5 not launched).

Both take a dtype. float32 is the kernels' (on the card) and their plain
versions' (on the CPU). float64 is the parity path of the JAX package
(features/extract.py:40-53: its Pallas kernels are f32-only): the
operators are float64 buffers and each call runs the plain torch version
on whatever device the frontend lives, counted in F64_CALLS, a dtype route
chosen in the open. The kernel wrappers refuse a float64 CUDA tensor.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn

from ..config import (FeatureConfig, LpcConfig, MfccConfig, frame_geometry,
                      n_frames)
from ..ops import framing, gpu_frontend, levinson
from ..ops import frontend as operators
from ..ops.gpu_frontend import masked_cmvn
from ..utils.profiling import span

__all__ = ["LENGTH_BUCKET", "FullFrontend", "PackedFrontend", "apply_deltas",
           "diff_feature", "extract_batch", "frontend", "frontend_mode",
           "lpc_extract", "masked_cmvn", "mfcc_extract", "mix_feature",
           "signal_too_short"]

# Signals are zero-padded to a multiple of this many samples.
LENGTH_BUCKET = 4096

# frontend calls at float64 since the last reset: the plain versions, on
# the CPU or the card
F64_CALLS = 0
# the DFT product's operand precisions (JAX: matmul_dtype)
MM = ("f32", "bf16")


def apply_deltas(feat: torch.Tensor, mask: torch.Tensor, nd: int):
    """The reference's diff_feature row semantics on a masked padded batch
    (src/feature/utils.py:24-31): nd frames are consumed from the front.
    Columns come out as [mfcc, lpc, d_mfcc, d_lpc], as in the JAX package.
    Both results are contiguous: the scoring kernels read raw pointers."""
    if nd == 0:
        return feat, mask
    d1 = feat[..., 1:, :] - feat[..., :-1, :]
    if nd == 1:
        return (torch.cat([feat[..., 1:, :], d1], dim=-1),
                mask[..., 1:].contiguous())
    if nd == 2:
        d2 = d1[..., 1:, :] - d1[..., :-1, :]
        return (torch.cat([feat[..., 2:, :], d1[..., 1:, :], d2], dim=-1),
                mask[..., 2:].contiguous())
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

    def __init__(self, fs: int, cfg: FeatureConfig,
                 dtype: torch.dtype = torch.float32, mm: str = "f32"):
        super().__init__()
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: float32 or float64")
        if mm not in MM:
            raise ValueError(f"mm {mm!r}: one of {MM}")
        self.dtype = dtype
        # bf16 DFT operands: at float32 only (the JAX package's mm_dt)
        self.mm_bf16 = mm == "bf16" and dtype == torch.float32
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
        """The float64 numpy operators as buffers of the frontend's dtype on
        `device`."""
        for name, op in ops.items():
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(op), dtype=self.dtype, device=device))

    def _count_f64(self) -> bool:
        """Whether this call takes the float64 route (and count it)."""
        if self.dtype != torch.float64:
            return False
        global F64_CALLS
        F64_CALLS += 1
        return True

    def valid_frames(self, lengths: torch.Tensor, T: int) -> torch.Tensor:
        """[B] lengths -> [B] int32 count of frames wholly inside each
        signal, at most T (JAX features/extract.py:252-254)."""
        lengths = lengths.to(torch.int64)
        n = torch.div(lengths - self.frame_len, self.frame_shift,
                      rounding_mode="floor") + 1
        return torch.where(lengths >= self.frame_len, n,
                           torch.zeros_like(n)).clamp(max=T).to(torch.int32)

    def _frames(self, signals: torch.Tensor, lengths: torch.Tensor):
        """(contiguous signals of the frontend's dtype, T, [B, T] frame
        mask)."""
        signals = signals.to(self.dtype).contiguous()
        T = n_frames(signals.shape[-1], self.frame_len, self.frame_shift)
        mask = framing.frame_validity_mask(lengths.to(signals.device), T,
                                           self.frame_len, self.frame_shift)
        return signals, T, mask

    def finish(self, ceps: torch.Tensor, r: torch.Tensor,
               mask: torch.Tensor, cmvn_done: bool = False):
        """[B, T, n_ceps] cepstra (pre-CMVN unless cmvn_done: the signal
        kernel normalizes them itself) and [B, T, order+1] raw
        autocorrelation (zero-width without LPC) -> ([B, T', d] features,
        [B, T'] mask), as speaker_recognition_tpu/features/extract.py:335-350:
        masked CMVN; LPC, or Levinson -> LPC cepstra -> non-finite to 0
        (no lpc_from_autocorr first: an all-zero frame gives 0 cepstra);
        deltas; zeros past each utterance's valid frames."""
        with span("srt.frontend.glue"):
            if self.cmvn and not cmvn_done:
                ceps = masked_cmvn(ceps, mask)
            feat, mask = apply_deltas(
                torch.cat([ceps, self._lpc_part(r)], dim=-1), mask,
                self.n_deltas)
            return _zero_past(feat, mask), mask

    def _deltas(self, feat: torch.Tensor, mask: torch.Tensor):
        """A signal kernel's features (zeros past each utterance's valid
        frames) with their deltas: apply_deltas, then zeros past the valid
        frames again."""
        if not self.n_deltas:
            return feat, mask
        with span("srt.frontend.glue"):
            feat, mask = apply_deltas(feat, mask, self.n_deltas)
            return _zero_past(feat, mask), mask

    def _lpc_part(self, r: torch.Tensor) -> torch.Tensor:
        """[..., order+1] raw autocorrelation -> the LPC columns: LPC, or
        Levinson -> LPC cepstra -> non-finite to 0, or none without LPC."""
        return gpu_frontend.lpc_columns(r if self.use_lpc else r[..., :0],
                                        self.n_lpcc)

    def _lpcc_in_kernel(self) -> bool:
        """Whether the LPC cepstra (if any) come out of the signal kernels'
        tail: not from the bf16 kernel, and up to LPCC_MAX_LAGS lags."""
        return (self.n_lpcc == 0 or not self.mm_bf16
                and self.lpc_order < gpu_frontend.LPCC_MAX_LAGS)


def _zero_past(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, n] with zeros where the [B, T] mask is false."""
    return torch.where(mask[..., None], x, torch.zeros_like(x))


class PackedFrontend(_Frontend):
    """The packed frontend of one (fs, FeatureConfig) on one device: buffers
    D [flen, 2*flen], W [2*flen, n_mel], dct [n_mel, n_ceps] and
    A [2*flen, order+1] (zero columns without LPC), and the FFT route's
    window [flen], fft_mel [N/2+1, n_mel] and fft_acorr [N/2+1, order+1],
    N = ops/frontend.rfft_size(flen). Needs fft_size >= 2*frame_len. From
    N = 32768 on (frames longer than 8192 samples) it builds no D, W, A
    (D alone would be 1.2 GB at 384 kHz) unless mm="bf16", whose kernel
    rounds D: every other route, the CPU's and float64's too, takes the FFT
    route's operators there."""

    def __init__(self, fs: int, cfg: FeatureConfig,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32, mm: str = "f32"):
        super().__init__(fs, cfg, dtype, mm)
        mf = cfg.mfcc
        if mf.fft_size < 2 * self.frame_len:
            raise ValueError(
                f"fft_size {mf.fft_size} < 2*frame_len {2 * self.frame_len}: "
                "the packed frontend cannot express it; frontend() serves "
                "it with FullFrontend")
        mel, dct = _mel_dct(fs, mf)
        lpc_order = self.lpc_order if cfg.use_lpc else None
        self.n_fft = operators.rfft_size(self.frame_len)
        dense = {}
        if self.n_fft < gpu_frontend.BIG_N or self.mm_bf16:
            D, W, A = operators.packed_frontend_operators(
                self.frame_len, mf.fft_size, mf.pre_emph, mel,
                lpc_order=lpc_order, preemph_first=mf.preemph_first)
            dense = {"D": D, "W": W,
                     "A": np.zeros((D.shape[1], 0)) if A is None else A}
        else:
            for name in ("D", "W", "A"):
                self.register_buffer(name, None)
        M, R = operators.fft_packed_operators(
            self.frame_len, mf.fft_size, mel, lpc_order=lpc_order,
            n_fft=self.n_fft)
        if R is None:
            R = np.zeros((M.shape[0], 0))
        self._register(device, dct=dct,
                       window=operators.hamming(self.frame_len), fft_mel=M,
                       fft_acorr=R, **dense)
        self.pre_emph = mf.pre_emph
        self.preemph_first = mf.preemph_first

    @property
    def fft(self) -> gpu_frontend.FftRoute:
        """The operators of the signal-level kernel's FFT route."""
        return gpu_frontend.FftRoute(self.n_fft, self.window, self.pre_emph,
                                     self.preemph_first, self.fft_mel,
                                     self.fft_acorr)

    def _signal_kernel(self, signals, lengths, cmvn: bool):
        """(the signal kernel's output, [B, T] mask) for [B, Lp] signals: K1
        at float32, the FFT route's or the dense plain version at float64.
        [B, T, n_ceps + w], the LPC columns from the kernel's tail (LPC, or
        the LPC cepstra), unless the LPC cepstra follow in torch
        (_lpcc_in_kernel: then the cepstra and the raw autocorrelation,
        [B, T, order+1])."""
        with span("srt.frontend.glue"):
            signals, T, mask = self._frames(signals, lengths)
            n_valid = self.valid_frames(lengths.to(signals.device), T)
        fuse_lpc = self._lpcc_in_kernel()
        n_lpcc = self.n_lpcc if fuse_lpc else 0
        with span("srt.frontend.kernel"):
            if not self._count_f64():
                out = gpu_frontend.packed_from_signals(
                    signals, n_valid, self.D, self.W, self.dct, self.A,
                    self.floor, self.frame_shift, cmvn, fft=self.fft,
                    fuse_lpc=fuse_lpc, mm_bf16=self.mm_bf16, n_lpcc=n_lpcc)
            elif self.D is None:
                out = gpu_frontend.packed_from_signals_fft_reference(
                    signals, n_valid, self.fft, self.dct, self.floor,
                    self.frame_shift, cmvn, fuse_lpc, n_lpcc)
            else:
                out = gpu_frontend.packed_from_signals_reference(
                    signals, n_valid, self.D, self.W, self.dct, self.A,
                    self.floor, self.frame_shift, cmvn, fuse_lpc,
                    n_lpcc=n_lpcc)
        return out, mask

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """[B, Lp] zero-padded signals, [B] lengths -> ([B, T', d] features,
        [B, T'] mask); zeros past each utterance's valid frames."""
        feat, mask = self._signal_kernel(signals, lengths, self.cmvn)
        if not self._lpcc_in_kernel():
            return self.finish(*feat, mask, cmvn_done=True)
        return self._deltas(feat, mask)

    def pre_cmvn(self, signals: torch.Tensor, lengths: torch.Tensor):
        """([B, T, n_ceps] cepstra before CMVN, [B, T, w] LPC columns,
        [B, T] mask): forward's kernel with its CMVN off and no deltas;
        zeros past each utterance's valid frames."""
        out, mask = self._signal_kernel(signals, lengths, False)
        if self._lpcc_in_kernel():
            nc = self.dct.shape[1]
            return out[..., :nc], out[..., nc:], mask
        return (_zero_past(out[0], mask),
                _zero_past(self._lpc_part(out[1]), mask), mask)


class FullFrontend(_Frontend):
    """The full-spectrum frontend of one (fs, FeatureConfig) on one device:
    buffers mel [nb, n_mel], dct [n_mel, n_ceps] and acorr [nb, order+1]
    (zero columns without LPC), nb = fft/2+1 rounded up to a multiple of 4,
    as speaker_recognition_tpu/features/extract.py:306-350, and C, S
    [flen, nb] (the cos/sin DFT projections) where a route reads them: the
    plain version on the CPU, the dense kernel at an fft_size that is not a
    power of two past the chirp-z route's reach (gpu_frontend.chirp_size),
    the bf16 product. The FFT and chirp-z kernels take the first fft/2+1
    rows of mel and acorr. `signal_route`: whether forward and pre_cmvn
    run gpu_frontend.mfcc_from_signals (float32, f32 operands, a
    power-of-two fft_size below BIG_N, LPC cepstra within LPCC_MAX_LAGS),
    with the window [flen] in `fft`; otherwise the frame route
    (_frame_kernel, then `finish`)."""

    def __init__(self, fs: int, cfg: FeatureConfig,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32, mm: str = "f32"):
        super().__init__(fs, cfg, dtype, mm)
        mf = cfg.mfcc
        nb = mf.fft_size // 2 + 1
        # the autocorrelation is power @ acorr even when fft_size <
        # 2*frame_len, as in the JAX package: circular aliasing starts at lag
        # fft_size - frame_len + 1 (513 at 48 kHz), far past the LPC order
        acorr = (levinson.autocorr_operator(self.frame_len, mf.fft_size,
                                            self.lpc_order)
                 if cfg.use_lpc else np.zeros((nb, 0)))
        mel, dct = _mel_dct(fs, mf)
        # bins padded to a multiple of 4 (16-byte rows for the dense
        # kernel's copies): zero DFT columns whose mel and autocorrelation
        # rows are zero, so they add nothing to either
        pad = -nb % 4
        mel, acorr = (np.pad(x, ((0, pad), (0, 0))) for x in (mel, acorr))
        self._register(device, mel=mel, dct=dct, acorr=acorr,
                       window=operators.hamming(self.frame_len))
        self.n_fft = mf.fft_size
        self.signal_route = (dtype == torch.float32 and not self.mm_bf16
                             and self.n_fft & (self.n_fft - 1) == 0
                             and self.n_fft < gpu_frontend.BIG_N
                             and self._lpcc_in_kernel())
        self.register_buffer("C", None)
        self.register_buffer("S", None)
        dense = (self.n_fft & (self.n_fft - 1)
                 and not gpu_frontend.chirp_size(self.n_fft, self.frame_len))
        if (torch.device(device).type == "cpu" or dtype == torch.float64
                or self.mm_bf16 or dense):
            C, S = operators.dft_power_projection(self.frame_len, self.n_fft)
            self._register(device, **{k: np.pad(x, ((0, 0), (0, pad)))
                                      for k, x in (("C", C), ("S", S))})
        self.pre_emph = mf.pre_emph
        self.preemph_first = mf.preemph_first

    @property
    def fft(self) -> gpu_frontend.FftRoute:
        """The operators of the kernel from the signals: n_fft = fft_size,
        mel and acorr rows past fft/2 unread."""
        return gpu_frontend.FftRoute(self.n_fft, self.window, self.pre_emph,
                                     self.preemph_first, self.mel,
                                     self.acorr)

    def _signal_kernel(self, signals, lengths, cmvn: bool):
        """(mfcc_from_signals' [B, T, n_ceps + w] features, [B, T] mask)
        for [B, Lp] signals (the signal route)."""
        with span("srt.frontend.glue"):
            signals, T, mask = self._frames(signals, lengths)
            n_valid = self.valid_frames(lengths.to(signals.device), T)
        with span("srt.frontend.kernel"):
            return gpu_frontend.mfcc_from_signals(
                signals, n_valid, self.fft, self.dct, self.floor,
                self.frame_shift, cmvn, self.n_lpcc), mask

    def _frame_kernel(self, signals, lengths):
        """([B, T, n_ceps] cepstra before CMVN, [B, T, order+1] raw
        autocorrelation, [B, T] mask) for [B, Lp] signals: K5 at float32,
        its plain version at float64, the bf16 product at mm="bf16"."""
        with span("srt.frontend.glue"):
            signals, T, mask = self._frames(signals, lengths)
            B = signals.shape[0]
            wp = framing.window_preemph(
                framing.frame_signal(signals, self.frame_len,
                                     self.frame_shift),
                self.frame_len, self.pre_emph, self.preemph_first)
            wp = wp.reshape(B * T, self.frame_len)
        with span("srt.frontend.kernel"):
            if self._count_f64():
                ceps, r = gpu_frontend.mfcc_from_frames_reference(
                    wp, self.C, self.S, self.mel, self.dct, self.floor,
                    self.acorr)
            elif self.mm_bf16:
                ceps, r = gpu_frontend.mfcc_from_frames_bf16(
                    wp, self.C, self.S, self.mel, self.dct, self.floor,
                    self.acorr)
            else:
                ceps, r = gpu_frontend.mfcc_from_frames(
                    wp, self.C, self.S, self.mel, self.dct, self.floor,
                    self.acorr, self.n_fft)
        return ceps.view(B, T, -1), r.view(B, T, -1), mask

    def forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """[B, Lp] zero-padded signals, [B] lengths -> ([B, T', d] features,
        [B, T'] mask); zeros past each utterance's valid frames."""
        if self.signal_route:
            return self._deltas(*self._signal_kernel(signals, lengths,
                                                     self.cmvn))
        return self.finish(*self._frame_kernel(signals, lengths))

    def pre_cmvn(self, signals: torch.Tensor, lengths: torch.Tensor):
        """([B, T, n_ceps] cepstra before CMVN, [B, T, w] LPC columns,
        [B, T] mask): forward's kernel and LPC columns, with no CMVN and no
        deltas; zeros past each utterance's valid frames."""
        if self.signal_route:
            out, mask = self._signal_kernel(signals, lengths, False)
            nc = self.dct.shape[1]
            return out[..., :nc], out[..., nc:], mask
        ceps, r, mask = self._frame_kernel(signals, lengths)
        return (_zero_past(ceps, mask), _zero_past(self._lpc_part(r), mask),
                mask)


def frontend_mode() -> str:
    """SRTPU_FRONTEND: "packed" (the default) or "full", as in the JAX
    package (features/extract.py:56-66)."""
    mode = os.environ.get("SRTPU_FRONTEND", "packed")
    if mode not in ("packed", "full"):
        raise ValueError(f"SRTPU_FRONTEND={mode!r}: expected packed or full")
    return mode


def frontend(fs: int, cfg: FeatureConfig, device: torch.device | str,
             dtype: str = "float32", mm: str = "f32") -> _Frontend:
    """The frontend of (fs, cfg) on `device` at `dtype` with the DFT
    product's operands at `mm` under the current SRTPU_FRONTEND, built once
    per (fs, cfg, device, dtype, mm, mode)."""
    return _frontend(int(fs), cfg, torch.device(device), _torch_dtype(dtype),
                     frontend_mode(), mm)


def _torch_dtype(dtype: str) -> torch.dtype:
    if dtype not in ("float32", "float64"):
        raise ValueError(f"dtype {dtype!r}: float32 or float64")
    return getattr(torch, dtype)


@functools.lru_cache(maxsize=16)
def _frontend(fs: int, cfg: FeatureConfig, device: torch.device,
              dtype: torch.dtype, mode: str, mm: str = "f32") -> _Frontend:
    flen, _ = frame_geometry(fs, cfg.mfcc.win_length_ms,
                             cfg.mfcc.win_shift_ms)
    if mode == "packed" and cfg.mfcc.fft_size >= 2 * flen:
        return PackedFrontend(fs, cfg, device, dtype, mm)
    return FullFrontend(fs, cfg, device, dtype, mm)


def extract_batch(signals: torch.Tensor, lengths: torch.Tensor, fs: int,
                  cfg: FeatureConfig = FeatureConfig(),
                  dtype: str = "float32", mm: str = "f32"):
    """Features for a zero-padded batch: [B, L] -> ([B, T, d], [B, T] mask),
    at `dtype` (float64: the plain versions, features/extract.F64_CALLS),
    the DFT product's operands at `mm` ("f32" or "bf16")."""
    return frontend(fs, cfg, signals.device, dtype, mm)(signals, lengths)


def mix_feature(fs: int, signal, cfg: FeatureConfig = FeatureConfig(),
                dtype: str = "float32",
                device: torch.device | str = "cuda") -> np.ndarray:
    """One utterance's concat(MFCC, LPC) per frame, [T - n_deltas, d] numpy
    (src/feature/__init__.py:25-30). Int or float PCM; multi-channel input
    is averaged (MFCC.py:52-54). The signal is padded to LENGTH_BUCKET, in
    float32, or at float64 full-width as in the JAX package
    (features/extract.py:403-405), and runs through the frontend of (fs,
    cfg, dtype) on `device`."""
    dt = _torch_dtype(dtype)
    signal = np.asarray(signal, dtype=np.float64)
    if signal.ndim > 1:
        signal = signal.mean(axis=1)
    if signal_too_short(fs, cfg, len(signal)):
        raise ValueError("Signal too short!")  # MFCC.py:56
    mf = cfg.mfcc
    T = n_frames(len(signal), *frame_geometry(fs, mf.win_length_ms,
                                              mf.win_shift_ms))
    padded = np.zeros((1, -(-len(signal) // LENGTH_BUCKET) * LENGTH_BUCKET),
                      np.float64 if dt == torch.float64 else np.float32)
    padded[0, :len(signal)] = signal
    device = torch.device(device)
    feat, _ = extract_batch(torch.from_numpy(padded).to(device),
                            torch.tensor([len(signal)], device=device), fs,
                            cfg, dtype)
    return feat[0, :T - cfg.n_deltas].cpu().numpy()


def mfcc_extract(fs: int, signal, cfg: MfccConfig = MfccConfig(),
                 dtype: str = "float32",
                 device: torch.device | str = "cuda") -> np.ndarray:
    """MFCC only (src/feature/MFCC.py:extract)."""
    return mix_feature(fs, signal, FeatureConfig(mfcc=cfg, use_lpc=False),
                       dtype, device)


def lpc_extract(fs: int, signal, cfg: LpcConfig = LpcConfig(),
                dtype: str = "float32",
                device: torch.device | str = "cuda") -> np.ndarray:
    """LPC only (src/feature/LPC.py:extract)."""
    fcfg = FeatureConfig(
        mfcc=MfccConfig(win_length_ms=cfg.win_length_ms,
                        win_shift_ms=cfg.win_shift_ms, pre_emph=cfg.pre_emph),
        lpc=cfg, use_lpc=True)
    return mix_feature(fs, signal, fcfg, dtype, device)[:, fcfg.mfcc.n_ceps:]


def diff_feature(feat: np.ndarray, nd: int = 1) -> np.ndarray:
    """Delta / delta-delta features of one utterance [T, d] on the host,
    src/feature/utils.py:24-31: [T-1, 2d] for nd = 1, [T-2, 3d] for 2."""
    diff = feat[1:] - feat[:-1]
    feat = feat[1:]
    if nd == 1:
        return np.concatenate((feat, diff), axis=1)
    if nd == 2:
        d2 = diff[1:] - diff[:-1]
        return np.concatenate((feat[1:], diff[1:], d2), axis=1)
    raise ValueError(f"nd must be 1 or 2, got {nd}")
