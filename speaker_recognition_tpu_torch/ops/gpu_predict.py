"""The fused predict monolith: padded signals -> [B, S] bank scores in one
kernel, and its plain torch versions.

The counterpart of speaker_recognition_tpu/ops/pallas_predict.py. Its two
TPU kernels, `_run` (per-utterance scoring, optional bf16 DFT operands)
and `_run_wide` (transposed batched scoring), compute one function; here
both wrappers launch the same kernel, csrc/predict_fused.cuh. For utterance
b of [B, Lp] zero-padded signals, with frame_len = 2*fshift, T = (Lp -
frame_len)//fshift + 1 frames and nv = min(max(n_valid[b], 0), T) valid
frames:

    Y = the power spectrum of the windowed, pre-emphasized frame,
    ceps = log(max(Y . W, floor)) . dct
    masked CMVN of ceps over the nv frames when `cmvn` (identity at nv <= 1)
    lpc = Levinson(Y . A), non-finite -> 0, when A has columns
    ll = per-speaker logsumexp of [feat^2 | feat] . op + cw over K,
         floored: > -745 ? ll : log(1e-15)
    out[b, s] = sum_{t < nv} ll / max(nv, 1)   (0 when nv == 0)

D, W, dct and A are the operators of features/extract.PackedFrontend
(ops/frontend.packed_frontend_operators; A None or zero-width for MFCC
only), `bank` a models/gmm.GmmBank and `fft` the frontend's FFT route
(PackedFrontend.fft: the window, the pre-emphasis and the bin-domain
operators of an N-point FFT, N = ops/frontend.rfft_size(frame_len)).

Routes, chosen in the open:
  * CPU tensors: `fused_bank_predict_reference`, the dense operators D, W,
    A (uncounted);
  * CUDA, f32: the kernel on the FFT tile, which takes `fft`; its plain
    version is `fused_bank_predict_fft_reference` (the signal frontend's
    FFT route, then the bank's plain scoring), for the tests and
    chip_smoke.py. Past 512 mel + autocorrelation outputs the tile
    projects onto chunks of 512 in turn, the sums in device rows, as K1
    does (counted in CHUNKED_LAUNCHES as well); at an FFT of 32768 points
    or more the four-step FFT of csrc/rfft_big.cuh computes the features
    in chunks of frames and the kernel then runs its CMVN and scoring
    phases on them (csrc/predict_fused_big.cu, several launches a call,
    counted in BIG_LAUNCHES in place of LAUNCHES or WIDE_LAUNCHES);
  * CUDA, `mm_bf16`: the kernel on the dense tile with the samples and D
    rounded to bf16 (the product on the tensor cores, D and W | A packed
    once: gpu_frontend.dft_mma_operator, dense_wa_operator), counted in
    BF16_LAUNCHES; any number of mel + autocorrelation outputs (chunks of
    128 past 128, their sums in device rows) and any frame length (a tile
    of 128, 64 or 32 frames, the samples read from device memory past what
    a 32-frame tile holds).
Every shape the frontend kernels take, the f32 route takes; on the CPU a
frontend of N >= 32768 (which builds no dense operators) runs the FFT
route's plain version.
A CUDA tensor launches the kernel or raises; any other device raises.
Serving does not dispatch the monolith: api/fastpath.predict_scores runs
the frontend and the bank-scoring kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models.gmm import GmmBank
from ..models.gmm import batch_bank_avg_loglik
from .gpu_frontend import (BIG_N, FftRoute, _big_operator, _big_scratch,
                           _packed_operator, count_big_passes,
                           dense_wa_operator, dft_mma_operator,
                           packed_from_signals_fft_reference,
                           packed_from_signals_reference)

__all__ = ["BF16_LAUNCHES", "BIG_LAUNCHES", "CHUNKED_LAUNCHES", "LAUNCHES",
           "WIDE_LAUNCHES", "fused_bank_predict",
           "fused_bank_predict_fft_reference", "fused_bank_predict_reference",
           "fused_bank_predict_wide"]

# kernel launches since the last reset, through each wrapper and route; the
# CPU path does not count
LAUNCHES = 0        # fused_bank_predict, f32 (FFT tile)
WIDE_LAUNCHES = 0   # fused_bank_predict_wide (FFT tile)
BF16_LAUNCHES = 0   # fused_bank_predict(mm_bf16=True) (dense tile)
# f32 calls of either wrapper on the route of N >= 32768 (several launches
# each), and f32 tile launches of either with more than 512 outputs
BIG_LAUNCHES = 0
CHUNKED_LAUNCHES = 0


def _lpc_operator(A, D: torch.Tensor) -> torch.Tensor:
    """A, or a zero-width operator for MFCC only."""
    return D.new_zeros((D.shape[1], 0)) if A is None else A


def _check_geometry(D: torch.Tensor | None, fshift: int,
                    fft: FftRoute | None):
    """The JAX package's rule: frame_len == 2*frame_shift and fft_size >=
    2*frame_len, for which the packed operator D [frame_len, 2*frame_len]
    stands; an FFT route, where given, of frames that long. D is None for
    a frontend of N >= 32768, which builds no dense operators: then the
    FFT route alone carries the geometry."""
    if D is None:
        if fft is None:
            raise ValueError(
                "fused predict takes the packed operators D, W, A, or the "
                "FFT route (fft=) where a frontend of N >= 32768 builds no "
                "dense operators")
        flen = fft.window.shape[0]
        if flen != 2 * fshift or fft.n_fft < 2 * flen:
            raise ValueError(
                f"fused predict serves the packed geometry only: frame_len "
                f"== 2*frame_shift and n_fft >= 2*frame_len; got frame_len "
                f"{flen} at frame_shift {fshift}, n_fft {fft.n_fft}")
        return
    flen = D.shape[0]
    if flen != 2 * fshift or D.shape[1] != 2 * flen:
        raise ValueError(
            f"fused predict serves the packed geometry only: frame_len == "
            f"2*frame_shift and packed operators D [frame_len, 2*frame_len]; "
            f"got D {tuple(D.shape)} at frame_shift {fshift}. Other "
            "geometries, and fft_size < 2*frame_len (the full-spectrum route, "
            "features.extract.FullFrontend), go through "
            "api.fastpath.predict_scores")
    if fft is not None and (fft.window.shape[0] != flen
                            or fft.n_fft < 2 * flen):
        raise ValueError(f"the FFT route of {fft.window.shape[0]}-sample "
                         f"frames at n_fft {fft.n_fft} does not fit D "
                         f"{tuple(D.shape)}")


def _valid(n_valid, T: int):
    return n_valid.to(torch.int64).clamp(0, T)


def fused_bank_predict_reference(signals, n_valid, bank: GmmBank,
                                 fshift: int, D, W, dct_t, floor: float, A,
                                 cmvn: bool = True,
                                 mm_bf16: bool = False) -> torch.Tensor:
    """The plain torch monolith on the dense operators: the packed
    frontend's plain version, then the bank's; with `mm_bf16` the signals
    and D are rounded to bf16 first and the DFT product runs in f32 on the
    rounded values."""
    _check_geometry(D, fshift, None)
    A = _lpc_operator(A, D)
    T = (signals.shape[-1] - D.shape[0]) // fshift + 1
    nv = _valid(n_valid, T)
    if mm_bf16:
        signals = signals.to(torch.bfloat16).to(signals.dtype)
        D = D.to(torch.bfloat16).to(D.dtype)
    feat = packed_from_signals_reference(signals, nv, D, W, dct_t, A, floor,
                                         fshift, cmvn)
    mask = torch.arange(T, device=signals.device) < nv[:, None]
    return batch_bank_avg_loglik(bank, feat, mask)


def fused_bank_predict_fft_reference(signals, n_valid, bank: GmmBank,
                                     fshift: int, dct_t, floor: float,
                                     fft: FftRoute,
                                     cmvn: bool = True) -> torch.Tensor:
    """The plain torch monolith on the FFT route: what the f32 kernel
    computes (packed_from_signals_fft_reference, then the bank's plain
    scoring)."""
    flen = fft.window.shape[0]
    T = (signals.shape[-1] - flen) // fshift + 1
    nv = _valid(n_valid, T)
    feat = packed_from_signals_fft_reference(signals, nv, fft, dct_t, floor,
                                             fshift, cmvn)
    mask = torch.arange(T, device=signals.device) < nv[:, None]
    return batch_bank_avg_loglik(bank, feat, mask)


def fused_bank_predict(signals, n_valid, bank: GmmBank, fshift: int, D, W,
                       dct_t, floor: float, A, cmvn: bool = True,
                       mm_bf16: bool = False,
                       fft: FftRoute | None = None) -> torch.Tensor:
    """[B, Lp] f32 zero-padded signals, [B] int32 valid frame counts, a bank
    -> [B, S] f32 per-speaker average log-likelihoods (pallas_predict.
    fused_bank_predict); `mm_bf16` feeds the DFT product bf16 operands. On
    the card the f32 kernel takes `fft` (PackedFrontend.fft)."""
    if signals.device.type == "cpu":
        return _plain(signals, n_valid, bank, fshift, D, W, dct_t, floor, A,
                      cmvn, fft, mm_bf16)
    global LAUNCHES, BF16_LAUNCHES
    if mm_bf16:
        out = _launch_bf16(signals, n_valid, bank, fshift, D, W, dct_t,
                           floor, A, cmvn)
        BF16_LAUNCHES += 1
        return out
    out, big = _launch_fft(signals, n_valid, bank, fshift, D, dct_t, floor,
                           cmvn, fft)
    LAUNCHES += not big
    return out


def fused_bank_predict_wide(signals, n_valid, bank: GmmBank, fshift: int, D,
                            W, dct_t, floor: float, A, cmvn: bool = True,
                            fft: FftRoute | None = None) -> torch.Tensor:
    """The same function as `fused_bank_predict` in f32, through the same
    kernel (pallas_predict.fused_bank_predict_wide); its TPU layout has no
    counterpart on the card."""
    if signals.device.type == "cpu":
        return _plain(signals, n_valid, bank, fshift, D, W, dct_t, floor, A,
                      cmvn, fft)
    out, big = _launch_fft(signals, n_valid, bank, fshift, D, dct_t, floor,
                           cmvn, fft)
    global WIDE_LAUNCHES
    WIDE_LAUNCHES += not big
    return out


def _plain(signals, n_valid, bank: GmmBank, fshift: int, D, W, dct_t,
           floor: float, A, cmvn: bool, fft: FftRoute | None,
           mm_bf16: bool = False) -> torch.Tensor:
    """The CPU's route: the dense plain version, or the FFT route's where
    the frontend built no dense operators (N >= 32768)."""
    if D is None and not mm_bf16:
        _check_geometry(D, fshift, fft)
        return fused_bank_predict_fft_reference(signals, n_valid, bank,
                                                fshift, dct_t, floor, fft,
                                                cmvn)
    return fused_bank_predict_reference(signals, n_valid, bank, fshift, D, W,
                                        dct_t, floor, A, cmvn, mm_bf16)


def _check_common(signals, n_valid, bank: GmmBank, dct_t, d: int):
    """The checks both routes share: the device, the batch, the bank."""
    if signals.device.type != "cuda":
        raise ValueError(f"no fused predict for device {signals.device}")
    dev = signals.device
    _build.check_tensor(signals, "signals", torch.float32, 2, dev)
    _build.check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    _build.check_tensor(dct_t, "dct_t", torch.float32, 2, dev)
    _build.check_tensor(bank.op, "bank.op", torch.float32, 2, dev)
    _build.check_tensor(bank.cw, "bank.cw", torch.float32, 1, dev)
    if n_valid.shape[0] != signals.shape[0] or bank.dim != d:
        raise ValueError(
            f"inconsistent fused predict shapes: signals "
            f"{tuple(signals.shape)}, n_valid {tuple(n_valid.shape)}, "
            f"feature dim {d}, bank dim {bank.dim}")


def _run(lib, signals, n_valid, bank: GmmBank, flen: int, fshift: int,
         nfft: int, ncols: int, nmel: int, nac: int, dct_t, floor: float,
         cmvn: bool, bf16: bool, win=None, op=None, D=None, WA=None,
         pre_emph: float = 0.0, preemph_first: bool = False,
         wide_floats: int = 0):
    """Allocate the scratch and the output and launch the kernel once. The
    batch has no limit of its own: the grid is persistent."""
    B, Lp = signals.shape
    nceps = dct_t.shape[1]
    d = bank.dim
    S, K = bank.n_speakers, bank.n_mixtures
    dev = signals.device
    T = (Lp - flen) // fshift + 1
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    comp = bank.component_operator(lib.srt_fused_component_row(d))
    scratch = torch.empty(lib.srt_fused_scratch_floats(B, T, d, S),
                          dtype=torch.float32, device=dev)
    # the sums rows past 128 (bf16) or 512 (f32) outputs
    wsums = (torch.empty(wide_floats, dtype=torch.float32, device=dev)
             if wide_floats else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_fused_predict(
            signals.data_ptr(), n_valid.data_ptr(), ptr(win), ptr(op),
            ptr(D), ptr(WA), dct_t.data_ptr(), comp.data_ptr(),
            scratch.data_ptr(), ptr(wsums), out.data_ptr(), B, Lp, T, flen,
            fshift, nfft,
            ncols, nmel, nac, nceps, S, K, float(pre_emph),
            int(bool(preemph_first)), float(floor), int(bool(cmvn)),
            int(bool(bf16)), stream)
    _build.check(err, "fused predict kernel")
    return out


def _launch_fft(signals, n_valid, bank: GmmBank, fshift: int, D, dct_t,
                floor: float, cmvn: bool, fft: FftRoute | None):
    """Check the arguments and launch the f32 route: the FFT tile, or the
    four-step route at N >= 32768. Returns (out, whether the four-step
    route ran), and counts the chunked and four-step calls."""
    if fft is None and signals.device.type == "cuda":
        raise ValueError("the fused predict kernel runs the FFT route in f32: "
                         "pass fft= (features.extract.PackedFrontend.fft)")
    _check_geometry(D, fshift, fft)
    nmel, nceps = dct_t.shape
    nac = 0 if fft is None else fft.acorr.shape[1]
    _check_common(signals, n_valid, bank, dct_t, nceps + max(nac - 1, 0))
    dev = signals.device
    _build.check_tensor(fft.window, "window", torch.float32, 1, dev)
    for t, name in ((fft.mel, "mel"), (fft.acorr, "acorr")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    N, flen = fft.n_fft, fft.window.shape[0]
    if (fft.mel.shape[1] != nmel
            or min(fft.mel.shape[0], fft.acorr.shape[0]) < N // 2 + 1
            or signals.shape[1] < flen):
        raise ValueError(
            f"inconsistent fused predict shapes: signals "
            f"{tuple(signals.shape)}, window {flen}, n_fft {N}, mel "
            f"{tuple(fft.mel.shape)}, acorr {tuple(fft.acorr.shape)}, dct_t "
            f"{tuple(dct_t.shape)}")
    lib = _build.load()
    global BIG_LAUNCHES, CHUNKED_LAUNCHES
    if N >= BIG_N:
        out = _run_big(lib, signals, n_valid, bank, fshift, dct_t, floor,
                       cmvn, fft)
        BIG_LAUNCHES += 1
        count_big_passes(N)
        return out, True
    op = _packed_operator(lib, fft.mel, fft.acorr, N)
    T = (signals.shape[1] - flen) // fshift + 1
    out = _run(lib, signals, n_valid, bank, flen, fshift, N, 0, nmel, nac,
               dct_t, floor, cmvn, False, win=fft.window, op=op,
               pre_emph=fft.pre_emph, preemph_first=fft.preemph_first,
               wide_floats=lib.srt_fft_wide_floats(signals.shape[0] * T,
                                                   nmel + nac))
    CHUNKED_LAUNCHES += nmel + nac > 512
    return out, False


def _run_big(lib, signals, n_valid, bank: GmmBank, fshift: int, dct_t,
             floor: float, cmvn: bool, fft: FftRoute) -> torch.Tensor:
    """The f32 route at N >= 32768 (csrc/predict_fused_big.cu): the
    four-step FFT's passes and the frontend's features in chunks of frames
    (as K1's route there), then the kernel's CMVN and scoring phases."""
    B, Lp = signals.shape
    flen, N = fft.window.shape[0], fft.n_fft
    nmel, nceps = dct_t.shape
    nac = fft.acorr.shape[1]
    d = bank.dim
    S, K = bank.n_speakers, bank.n_mixtures
    dev = signals.device
    T = (Lp - flen) // fshift + 1
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    comp = bank.component_operator(lib.srt_fused_component_row(d))
    scratch = torch.empty(lib.srt_fused_scratch_floats(B, T, d, S),
                          dtype=torch.float32, device=dev)
    chunk, big = _big_scratch(lib, N, nmel + nac, B * T, dev)
    op = _big_operator(lib, fft.mel, fft.acorr, N)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_fused_predict_big(
            signals.data_ptr(), n_valid.data_ptr(), fft.window.data_ptr(),
            op.data_ptr(), dct_t.data_ptr(),
            comp.data_ptr(), scratch.data_ptr(), big.data_ptr(),
            out.data_ptr(), B, Lp, T, flen, fshift, N, nmel, nac, nceps, S,
            K, float(fft.pre_emph), int(bool(fft.preemph_first)),
            float(floor), int(bool(cmvn)), chunk, stream)
    _build.check(err, "fused predict kernel, four-step route")
    return out


def _launch_bf16(signals, n_valid, bank: GmmBank, fshift: int, D, W, dct_t,
                 floor: float, A, cmvn: bool):
    """Check the arguments and launch the bf16 route (the dense tile)."""
    _check_geometry(D, fshift, None)
    A = _lpc_operator(A, D)
    nmel, nceps = dct_t.shape
    nac = A.shape[1]
    _check_common(signals, n_valid, bank, dct_t, nceps + max(nac - 1, 0))
    dev = signals.device
    for t, name in ((D, "D"), (W, "W"), (A, "A")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    flen, ncols = D.shape
    if (W.shape != (ncols, nmel) or A.shape[0] != ncols
            or signals.shape[1] < flen):
        raise ValueError(
            f"inconsistent fused predict shapes: signals "
            f"{tuple(signals.shape)}, D {tuple(D.shape)}, W "
            f"{tuple(W.shape)}, dct_t {tuple(dct_t.shape)}, A "
            f"{tuple(A.shape)}")
    lib = _build.load()
    T = (signals.shape[1] - flen) // fshift + 1
    return _run(lib, signals, n_valid, bank, flen, fshift, 0, ncols, nmel,
                nac, dct_t, floor, cmvn, True, D=dft_mma_operator(D),
                WA=dense_wa_operator(W, A),
                wide_floats=lib.srt_fused_bf16_wide_floats(
                    signals.shape[0], T, nmel + nac))


def bf16_tile(flen: int, fshift: int, nout: int, d: int) -> dict:
    """The bf16 route's tile at a geometry (csrc/packed_tile.cuh pick) for
    feature dimension d: frames a tile, outputs a lane / 8 (OPL), whether
    the samples are read from device memory, output chunks of 8 * OPL, the
    tile's shared memory in bytes and the kernel's resident blocks an SM."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.load().srt_fused_bf16_tile(flen, fshift, nout, d,
                                                   out), "bf16 tile")
    return dict(zip(("ft", "opl", "gseg", "chunks", "smem", "blocks"), out))
