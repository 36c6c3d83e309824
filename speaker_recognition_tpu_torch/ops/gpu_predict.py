"""The fused predict monolith: padded signals -> [B, S] bank scores in one
kernel, and its plain torch version.

The counterpart of speaker_recognition_tpu/ops/pallas_predict.py. Its two
TPU kernels, `_run` (per-utterance scoring, optional bf16 DFT operands)
and `_run_wide` (transposed batched scoring), compute one function; here
both wrappers launch the same kernel, csrc/predict_fused.cu, and
`fused_bank_predict` passes it the bf16 flag. For utterance b of [B, Lp]
zero-padded signals, with frame_len = 2*fshift, T = (Lp - frame_len)//
fshift + 1 frames and nv = min(max(n_valid[b], 0), T) valid frames:

    X = frame . D, Y = X^2, ceps = log(max(Y . W, floor)) . dct
    masked CMVN of ceps over the nv frames when `cmvn` (identity at nv <= 1)
    lpc = Levinson(Y . A), non-finite -> 0, when A has columns
    ll = per-speaker logsumexp of [feat^2 | feat] . op + cw over K,
         floored: > -745 ? ll : log(1e-15)
    out[b, s] = sum_{t < nv} ll / max(nv, 1)   (0 when nv == 0)

D, W, dct and A are the operators of features/extract.PackedFrontend
(ops/frontend.packed_frontend_operators; A None or zero-width for MFCC
only) and `bank` a models/gmm.GmmBank. On a CUDA tensor each wrapper
launches the kernel or raises; on a CPU tensor it runs
`fused_bank_predict_reference`; any other device raises. Serving does not
dispatch the monolith: api/fastpath.predict_scores runs the frontend and
the bank-scoring kernels.
"""

from __future__ import annotations

import torch

from .. import _build
from ..models.gmm import GmmBank
from ..models.gmm import batch_bank_avg_loglik
from .gpu_frontend import packed_from_signals_reference

__all__ = ["LAUNCHES", "WIDE_LAUNCHES", "fused_bank_predict",
           "fused_bank_predict_reference", "fused_bank_predict_wide"]

# kernel launches since the last reset, through each wrapper; the CPU path
# does not count
LAUNCHES = 0        # fused_bank_predict
WIDE_LAUNCHES = 0   # fused_bank_predict_wide


def _lpc_operator(A, D: torch.Tensor) -> torch.Tensor:
    """A, or a zero-width operator for MFCC only."""
    return D.new_zeros((D.shape[1], 0)) if A is None else A


def _check_geometry(D: torch.Tensor, fshift: int):
    flen = D.shape[0]
    if flen != 2 * fshift or D.shape[1] != 2 * flen:
        raise ValueError(
            f"fused predict serves the packed geometry only: frame_len == "
            f"2*frame_shift and packed operators D [frame_len, 2*frame_len]; "
            f"got D {tuple(D.shape)} at frame_shift {fshift}. Other "
            "geometries, and fft_size < 2*frame_len (the full-spectrum route, "
            "features.extract.FullFrontend), go through "
            "api.fastpath.predict_scores")


def fused_bank_predict_reference(signals, n_valid, bank: GmmBank,
                                 fshift: int, D, W, dct_t, floor: float, A,
                                 cmvn: bool = True,
                                 mm_bf16: bool = False) -> torch.Tensor:
    """The plain torch monolith: the packed frontend's plain version, then
    the bank's; with `mm_bf16` the signals and D are rounded to bf16 first
    and the DFT product runs in f32 on the rounded values."""
    _check_geometry(D, fshift)
    A = _lpc_operator(A, D)
    T = (signals.shape[-1] - D.shape[0]) // fshift + 1
    nv = n_valid.to(torch.int64).clamp(0, T)
    if mm_bf16:
        signals = signals.to(torch.bfloat16).to(signals.dtype)
        D = D.to(torch.bfloat16).to(D.dtype)
    feat = packed_from_signals_reference(signals, nv, D, W, dct_t, A, floor,
                                         fshift, cmvn)
    mask = torch.arange(T, device=signals.device) < nv[:, None]
    return batch_bank_avg_loglik(bank, feat, mask)


def fused_bank_predict(signals, n_valid, bank: GmmBank, fshift: int, D, W,
                       dct_t, floor: float, A, cmvn: bool = True,
                       mm_bf16: bool = False) -> torch.Tensor:
    """[B, Lp] f32 zero-padded signals, [B] int32 valid frame counts, a bank
    -> [B, S] f32 per-speaker average log-likelihoods (pallas_predict.
    fused_bank_predict); `mm_bf16` feeds the DFT product bf16 operands."""
    if signals.device.type == "cpu":
        return fused_bank_predict_reference(signals, n_valid, bank, fshift,
                                            D, W, dct_t, floor, A, cmvn,
                                            mm_bf16)
    out = _launch(signals, n_valid, bank, fshift, D, W, dct_t, floor, A,
                  cmvn, mm_bf16)
    global LAUNCHES
    LAUNCHES += 1
    return out


def fused_bank_predict_wide(signals, n_valid, bank: GmmBank, fshift: int, D,
                            W, dct_t, floor: float, A,
                            cmvn: bool = True) -> torch.Tensor:
    """The same function as `fused_bank_predict` in f32, through the same
    kernel (pallas_predict.fused_bank_predict_wide); its TPU layout has no
    counterpart on the card."""
    if signals.device.type == "cpu":
        return fused_bank_predict_reference(signals, n_valid, bank, fshift,
                                            D, W, dct_t, floor, A, cmvn)
    out = _launch(signals, n_valid, bank, fshift, D, W, dct_t, floor, A,
                  cmvn, False)
    global WIDE_LAUNCHES
    WIDE_LAUNCHES += 1
    return out


def _launch(signals, n_valid, bank: GmmBank, fshift: int, D, W, dct_t,
            floor: float, A, cmvn: bool, bf16: bool) -> torch.Tensor:
    """Check the arguments and launch csrc/predict_fused.cu once. The
    batch has no limit of its own: the grid is persistent."""
    _check_geometry(D, fshift)
    if signals.device.type != "cuda":
        raise ValueError(f"no fused predict for device {signals.device}")
    dev = signals.device
    A = _lpc_operator(A, D)
    _build.check_tensor(signals, "signals", torch.float32, 2, dev)
    _build.check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    for t, name in ((D, "D"), (W, "W"), (dct_t, "dct_t"), (A, "A"),
                    (bank.op, "bank.op")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    _build.check_tensor(bank.cw, "bank.cw", torch.float32, 1, dev)
    B, Lp = signals.shape
    flen, ncols = D.shape
    nmel, nceps = dct_t.shape
    nac = A.shape[1]
    order = max(nac - 1, 0)
    d = nceps + order
    S, K = bank.n_speakers, bank.n_mixtures
    if (n_valid.shape[0] != B or W.shape != (ncols, nmel)
            or A.shape[0] != ncols or bank.dim != d or Lp < flen):
        raise ValueError(
            f"inconsistent fused predict shapes: signals "
            f"{tuple(signals.shape)}, n_valid {tuple(n_valid.shape)}, D "
            f"{tuple(D.shape)}, W {tuple(W.shape)}, dct_t "
            f"{tuple(dct_t.shape)}, A {tuple(A.shape)}, bank dim {bank.dim}")
    lib = _build.load()
    if lib.srt_fused_smem_bytes(flen, fshift, nmel, nac, d, S, K) < 0:
        raise ValueError(
            f"fused predict kernel limits: {nmel} mel + {nac} "
            "autocorrelation outputs <= 128, and one speaker's "
            f"{K} components of dim {d} with a 128-frame tile within a "
            "block's shared memory; the LPC order, n_ceps and the batch have "
            "no limit")
    T = (Lp - flen) // fshift + 1
    scratch = torch.empty(lib.srt_fused_scratch_floats(B, T, d, S),
                          dtype=torch.float32, device=dev)
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_fused_predict(
            signals.data_ptr(), n_valid.data_ptr(), D.data_ptr(),
            W.data_ptr(), A.data_ptr(), dct_t.data_ptr(), bank.op.data_ptr(),
            bank.cw.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, Lp, T,
            flen, fshift, ncols, nmel, nac, nceps, S, K, float(floor),
            int(bool(cmvn)), int(bool(bf16)), stream)
    _build.check(err, "fused predict kernel")
    return out
