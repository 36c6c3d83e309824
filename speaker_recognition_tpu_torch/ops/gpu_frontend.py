"""The frontend kernels and their plain torch versions.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its
`*_reference` on a CPU tensor; any other device raises.

`packed_from_signals` (K1, csrc/frontend.cu) computes, for [B, Lp]
zero-padded signals and [B] valid frame counts, the [B, T, n_ceps + order]
feature concat(MFCC, LPC) with T = (Lp - frame_len)//fshift + 1, masked
CMVN over the valid frames when `cmvn` is set, and zeros at every frame at
or past n_valid. With `n_lpcc > 0` the LPC cepstra follow the Levinson
([B, T, n_ceps + n_lpcc - 1]: `lpc_columns`); on the card below BIG_N
one kernel from the signals computes that mode (csrc/
frontend_lpcc_signals.cu, on the tile of csrc/signal_tile.cuh with the
power unfloored: the projection on the tensor cores in three TF32 terms,
the LPC cepstra in registers; counted in LPCC_SIGNAL_LAUNCHES), so that
the LPC mode's instances stay as they were; from BIG_N on the four-step
route's raw rows, then csrc/frontend.cu's lpcc_kernel. With
`fuse_lpc=False` it skips the Levinson and returns the MFCC [B, T, n_ceps]
and the raw autocorrelation [B, T, order+1] (the JAX kernel's
fuse_lpc=False; features/extract.PackedFrontend takes it for the LPC
cepstra of the bf16 kernel, which has no LPC-cepstra mode). Its plain
version, the CPU path, runs the dense packed operators of
ops/frontend.packed_frontend_operators: D [frame_len, ncols] (window,
pre-emphasis, half-spectrum DFT), W [ncols, n_mel], dct
[n_mel, n_ceps] and A [ncols, order+1] (Wiener-Khinchin autocorrelation;
zero columns for an MFCC-only config). The kernel computes the same
function on an FFT: it takes an `FftRoute` (the window, the pre-emphasis
and the bin-domain operators of ops/frontend.fft_packed_operators);
`packed_from_signals_fft_reference` is that route in plain torch.

`mfcc_from_signals` (K5 from the signals, csrc/frontend_full_signals.cu
on the tile of csrc/signal_tile.cuh) computes the full-spectrum frontend's
features from [B, Lp] signals as K1 computes the packed frontend's:
framing, window and pre-emphasis per sample (samples past n_fft folded),
the n_fft-point power floored per bin, mel and autocorrelation (on the
tensor cores, in three TF32 terms, from the operator `signal_operator`
packs), log, DCT, masked CMVN, then LPC, the LPC cepstra or nothing, zeros
at and past n_valid ([B, T, n_ceps + w]); counted in FULL_SIGNAL_LAUNCHES.
It serves features/extract.FullFrontend at float32 with f32 operands and a
power-of-two fft_size below BIG_N; its plain version is
`mfcc_from_signals_reference` (framing, `mfcc_from_frames_fft_reference`,
the same tail).

The frame-level kernels take [n, frame_len] frames and return pre-CMVN
cepstra [n, n_ceps] and the RAW autocorrelation [n, order+1] (zero-width
without LPC), which the LPC cepstra need:
  `packed_from_frames`  (K4) raw frames; the floor applies to mel only. The
                        CPU path multiplies by the packed operators D, W, A
                        (`packed_from_frames_reference`); on the card the
                        FFT kernel of csrc/frontend_frames_fft.cu computes
                        the same function from an `FftRoute`, as the signal
                        frontend does (plain torch:
                        `packed_from_frames_fft_reference`);
  `mfcc_from_frames`    (K5) windowed, pre-emphasized frames, the cos/sin
                        operators C, S [frame_len, nb] (nb >= fft/2+1
                        bins; the CPU path), mel, acorr; the floor applies
                        to each power bin, then to mel. On the card an
                        n_fft that is a power of two takes the FFT kernel
                        (csrc/frontend_fft.cu; plain torch:
                        `mfcc_from_frames_fft_reference`), any other the
                        chirp-z route where its convolution's FFT fits
                        (`chirp_size`: csrc/frontend_chirp.cu up to M =
                        8192, csrc/frontend_chirp_cluster.cu to 2^23;
                        plain torch: `mfcc_from_frames_chirp_reference`),
                        past that the dense template of
                        csrc/frontend_frames.cu (`mfcc_from_frames_dense`).

The bf16 operand mode of K1 and K4 (`mm_bf16`, the JAX kernels' argument,
pallas_frontend.py:397, :441) rounds the frames and D to bf16 (nearest
even) and multiplies in f32: the TPU kernel's dense product, not the FFT,
since D is the operand it rounds. On the card `packed_from_signals` and
`packed_from_frames` take the dense operators D, W, A then and launch
csrc/frontend_bf16.cu (BF16_LAUNCHES, FRAMES_BF16_LAUNCHES), whose tile
runs the product on the tensor cores from D packed once in the order of
its fragments (`dft_mma_operator`) and projects onto W | A packed in the
order of its stage 2 (`dense_wa_operator`), both rebuilt after their
inputs are written to; their plain versions round the same operands. The
full route's bf16 mode (`mfcc_from_frames_bf16`) is the JAX extractor's
XLA-side product (features/extract.py:315-325; its K5 has no bf16 mode):
plain torch on bf16-rounded frames and C, S, on either device, counted in
FULL_BF16_CALLS, a route chosen in the open on which K5 does not launch.

Three routes of K5 at an n_fft that is not a power of two, and two of
the FFT kernels, are chosen on the shape in the open, each with its own
counter, and compute the same function:
  * an n_fft that is not a power of two runs the chirp-z route
    (FULL_CHIRP_LAUNCHES) where the least power of two M >= min(frame_len,
    n_fft) + n_fft/2 (at least 1024) is at most CHIRP_MAX_M = 2^23: the
    tile kernel of csrc/frontend_chirp.cu up to M = 8192 (CHIRP_TILE_M),
    csrc/frontend_chirp_cluster.cu past it, on the cluster FFT up to
    CHIRP_CLUSTER_M = 131072 and on the device-memory passes of
    csrc/rfft_passes.cuh past that (counted in BIG_PASSES_LAUNCHES as
    well); the dense template (FULL_DENSE_LAUNCHES) past CHIRP_MAX_M;
  * an FFT of 32768 points or more (fft_size >= 32768 on the full route,
    frames longer than 8192 samples on the packed route) runs the
    four-step route of csrc/rfft_big.cuh in chunks of frames
    (BIG_LAUNCHES, FRAMES_BIG_LAUNCHES, FULL_BIG_LAUNCHES) in place of the
    FFT tile: up to CLUSTER_MAX_N = 262144 points a frame's spectrum on
    one block or a thread-block cluster (csrc/rfft_cluster.cuh), past it
    the column and row passes of csrc/rfft_passes.cuh over a device scratch
    (counted in BIG_PASSES_LAUNCHES as well, by these wrappers and
    gpu_predict's); its fused projection pass splits the bins into
    ranges where the frames are few (srt_big_ranges: csrc/rfft_big.cuh
    rfft_big::ranges, from the chunk's frame and bin counts);
  * past 512 mel + autocorrelation outputs the FFT tile projects onto
    chunks of 512 outputs in turn, the sums in device rows
    (CHUNKED_LAUNCHES, counted beside the kernel's own counter).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..models.gmm import round_bf16, round_tf32
from . import framing, levinson

# kernel launches since the last reset, one count per kernel; the CPU path
# does not count
LAUNCHES = 0             # csrc/frontend.cu, packed_from_signals
FRAMES_LAUNCHES = 0      # csrc/frontend_frames_fft.cu, packed_from_frames
FULL_LAUNCHES = 0        # csrc/frontend_fft.cu, mfcc_from_frames
FULL_DENSE_LAUNCHES = 0  # csrc/frontend_frames.cu, mfcc_from_frames_dense
FULL_CHIRP_LAUNCHES = 0  # csrc/frontend_chirp.cu, mfcc_from_frames
FULL_SIGNAL_LAUNCHES = 0  # csrc/frontend_full_signals.cu, mfcc_from_signals
# csrc/frontend_lpcc_signals.cu, packed_from_signals with n_lpcc > 0 below
# BIG_N
LPCC_SIGNAL_LAUNCHES = 0
# the route of N >= 32768 (csrc/rfft_big.cuh), one count per wrapper
BIG_LAUNCHES = 0         # packed_from_signals
FRAMES_BIG_LAUNCHES = 0  # packed_from_frames
FULL_BIG_LAUNCHES = 0    # mfcc_from_frames
# FFT-tile launches of any of the four with more than 512 outputs
CHUNKED_LAUNCHES = 0
# launches of the four-step route past the cluster's reach (the
# device-memory passes), from any wrapper, gpu_predict's included
BIG_PASSES_LAUNCHES = 0
# the bf16 operand mode (csrc/frontend_bf16.cu), one count per wrapper,
# and the full route's bf16 product (plain torch, either device)
BF16_LAUNCHES = 0        # packed_from_signals
FRAMES_BF16_LAUNCHES = 0  # packed_from_frames
FULL_BF16_CALLS = 0       # mfcc_from_frames_bf16

# the bf16 tile's packing of D (csrc/packed_tile.cuh): the depth of
# mma.sync m16n8k16 (D's rows a k-step) and the columns of a chunk
MMA_DEPTH = 16
MMA_COLUMNS = 64

# FFT sizes from here on take the four-step route of csrc/rfft_big.cuh, on
# a cluster (csrc/rfft_cluster.cuh) up to CLUSTER_MAX_N
BIG_N = 32768
CLUSTER_MAX_N = 262144
# the chirp-z route's convolution lengths: the tile kernel (csrc/
# frontend_chirp.cu) up to CHIRP_TILE_M, csrc/frontend_chirp_cluster.cu past
# it, on the cluster up to CHIRP_CLUSTER_M and on the passes up to
# CHIRP_MAX_M
CHIRP_MIN_M, CHIRP_TILE_M, CHIRP_CLUSTER_M = 1024, 8192, 131072
CHIRP_MAX_M = 1 << 23
# complex values a block of the cluster FFT holds
CLUSTER_BLOCK = 16384
# device scratch the four-step route takes at most for a chunk of frames:
# its fused power + projection pass runs a block per 8 frames of a chunk,
# and a chunk of 1 GiB (8,174 frames' power rows at 65536 points; the
# passes keep matrices for a group of frames only) gives it blocks for
# every SM
BIG_SCRATCH_BYTES = 1 << 30
# autocorrelation lags (LPC order + 1) the kernels' LPC-cepstra tail takes:
# a frame's coefficients sit in a local array of the tile's operator width,
# which is at least this past 512 outputs (csrc/packed_tile.cuh
# tile_features)
LPCC_MAX_LAGS = 512


def masked_cmvn(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean/variance normalization over the valid frames
    (src/feature/MFCC.py:74-77, population std); the identity for an
    utterance with <= 1 valid frame."""
    m = mask[..., None].to(feat.dtype)
    count = m.sum(dim=-2, keepdim=True)
    safe = torch.clamp_min(count, 1.0)
    mu = (feat * m).sum(dim=-2, keepdim=True) / safe
    var = ((feat - mu) ** 2 * m).sum(dim=-2, keepdim=True) / safe
    normed = (feat - mu) / torch.sqrt(var)
    return torch.where(count > 1, normed, feat)


class FftRoute(NamedTuple):
    """What the signal frontend's FFT route takes besides the signals:
    frames of len(window) samples, windowed and pre-emphasized in the order
    of ops/frontend.windowed_preemph_operator, their n_fft-point power
    spectrum (bins 0..n_fft/2), then mel = power @ mel and the raw
    autocorrelation power @ acorr (ops/frontend.fft_packed_operators)."""

    n_fft: int
    window: torch.Tensor  # [frame_len]
    pre_emph: float
    preemph_first: bool
    mel: torch.Tensor     # [n_fft/2 + 1, n_mel]
    acorr: torch.Tensor   # [n_fft/2 + 1, order + 1], zero-width without LPC


def _fold(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """[..., flen] frames with samples t >= n_fft folded onto t mod n_fft
    (what C and S of a DFT shorter than the frame do)."""
    flen = x.shape[-1]
    if flen <= n_fft:
        return x
    return torch.nn.functional.pad(x, (0, -flen % n_fft)).unflatten(
        -1, (-1, n_fft)).sum(dim=-2)


def _power(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """|rfft(x, n_fft)|^2 of [..., flen] frames, folded (_fold)."""
    X = torch.fft.rfft(_fold(x, n_fft), n=n_fft)
    return X.real * X.real + X.imag * X.imag


def lpc_columns(r: torch.Tensor, n_lpcc: int = 0) -> torch.Tensor:
    """[..., order+1] raw autocorrelation -> the LPC columns: LPC (non-finite
    coefficients zeroed), or with n_lpcc > 0 Levinson -> the LPC cepstra
    -> non-finite to 0 (speaker_recognition_tpu/features/extract.py:339-344:
    the recursion runs on the unzeroed coefficients, so an all-zero frame
    gives 0 cepstra); zero-width without LPC. For the cepstra a frame whose
    lag 0 lies below the dtype's least normal number is taken as r = 0: an
    all-floor frame of the full-spectrum route (lag 0 = floor / frame_len,
    subnormal in f32), which the JAX package's f32 route, flushing
    subnormals, sees as 0 (its recursion on zeroed coefficients would give
    -1 / (n + 1) instead of 0)."""
    if not r.shape[-1]:
        return r
    if n_lpcc > 0:
        tiny = torch.finfo(r.dtype).tiny
        r = torch.where(r[..., :1] < tiny, torch.zeros_like(r), r)
        a, _ = levinson.levinson(r)
        return torch.nan_to_num(levinson.lpcc_from_lpc(a, n_lpcc), nan=0.0,
                                posinf=0.0, neginf=0.0)
    return levinson.lpc_from_autocorr(r)


def _signal_features(ceps, r, mask, cmvn: bool, fuse_lpc: bool,
                     n_lpcc: int = 0):
    """The tail the plain signal frontends share: masked CMVN of the
    cepstra, then concat(MFCC, lpc_columns), or (MFCC, raw autocorrelation)
    without fuse_lpc; zeros past the valid frames."""
    if cmvn:
        ceps = masked_cmvn(ceps, mask)
    m = mask[..., None]
    if not fuse_lpc:
        return (torch.where(m, ceps, torch.zeros_like(ceps)),
                torch.where(m, r, torch.zeros_like(r)))
    feat = torch.cat([ceps, lpc_columns(r, n_lpcc)], dim=-1)
    return torch.where(m, feat, torch.zeros_like(feat))


def packed_from_signals_fft_reference(signals, n_valid, fft: FftRoute, dct,
                                      floor: float, fshift: int, cmvn: bool,
                                      fuse_lpc: bool = True,
                                      n_lpcc: int = 0):
    """The signal frontend's FFT route in plain torch: what K1 computes."""
    flen = fft.window.shape[0]
    frames = framing.frame_signal(signals, flen, fshift)
    T = frames.shape[-2]
    mask = torch.arange(T, device=signals.device) < n_valid[:, None]
    Y = _power(framing.window_preemph(frames, flen, fft.pre_emph,
                                      fft.preemph_first), fft.n_fft)
    ceps = torch.log(torch.clamp_min(Y @ fft.mel, floor)) @ dct
    return _signal_features(ceps, Y @ fft.acorr, mask, cmvn, fuse_lpc,
                            n_lpcc)


def mfcc_from_frames_fft_reference(wp, mel, dct, floor: float, acorr,
                                   n_fft: int):
    """The full-spectrum frontend on an FFT in plain torch: what K5's FFT
    kernel computes (mel and acorr rows past n_fft/2 are not read)."""
    nb = n_fft // 2 + 1
    power = torch.clamp_min(_power(wp, n_fft), floor)
    return (torch.log(torch.clamp_min(power @ mel[:nb], floor)) @ dct,
            power @ acorr[:nb])


def mfcc_from_signals_reference(signals, n_valid, fft: FftRoute, dct,
                                floor: float, fshift: int, cmvn: bool,
                                n_lpcc: int = 0):
    """The full-spectrum frontend from the signals in plain torch: what
    mfcc_from_signals' kernel computes. Frames (framing.frame_signal),
    window and pre-emphasis (framing.window_preemph), the FFT route's
    spectrum with K5's per-bin floor (mfcc_from_frames_fft_reference, frames
    longer than n_fft folded), masked CMVN, lpc_columns; zeros past
    n_valid."""
    flen = fft.window.shape[0]
    frames = framing.frame_signal(signals, flen, fshift)
    T = frames.shape[-2]
    mask = torch.arange(T, device=signals.device) < n_valid[:, None]
    wp = framing.window_preemph(frames, flen, fft.pre_emph,
                                fft.preemph_first)
    ceps, r = mfcc_from_frames_fft_reference(wp, fft.mel, dct, floor,
                                             fft.acorr, fft.n_fft)
    return _signal_features(ceps, r, mask, cmvn, True, n_lpcc)


def mfcc_from_signals(signals, n_valid, fft: FftRoute, dct, floor: float,
                      fshift: int, cmvn: bool, n_lpcc: int = 0):
    """[B, Lp] signals, [B] int32 n_valid -> [B, T, n_ceps + w], w the LPC
    order, n_lpcc - 1 LPC cepstra (n_lpcc > 0) or 0 without LPC (a
    zero-width fft.acorr); masked CMVN of the cepstra when `cmvn`, zeros at
    and past n_valid. fft.n_fft is the fft_size, a power of two in [64,
    BIG_N / 2], of any frame length (a longer frame folds). On the CPU the
    plain version; on the card csrc/frontend_full_signals.cu."""
    if signals.device.type == "cpu":
        return mfcc_from_signals_reference(signals, n_valid, fft, dct,
                                           floor, fshift, cmvn, n_lpcc)
    if signals.device.type != "cuda":
        raise ValueError(f"no frontend for device {signals.device}")
    dev = signals.device
    _build.check_tensor(signals, "signals", torch.float32, 2, dev)
    _build.check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    for t, name in ((fft.window, "window"), (fft.mel, "mel"),
                    (fft.acorr, "acorr"), (dct, "dct")):
        _build.check_tensor(t, name, torch.float32, 1 if t is fft.window
                            else 2, dev)
    B, Lp = signals.shape
    flen, N = fft.window.shape[0], fft.n_fft
    nmel, nceps = dct.shape
    nac = fft.acorr.shape[1]
    if (n_valid.shape[0] != B or fft.mel.shape[1] != nmel
            or min(fft.mel.shape[0], fft.acorr.shape[0]) < N // 2 + 1
            or fshift < 1 or Lp < flen):
        raise ValueError(
            f"inconsistent frontend shapes: signals {tuple(signals.shape)}, "
            f"n_valid {tuple(n_valid.shape)}, window {flen}, n_fft {N}, mel "
            f"{tuple(fft.mel.shape)}, acorr {tuple(fft.acorr.shape)}, dct "
            f"{tuple(dct.shape)}, fshift {fshift}")
    _check_lpcc(n_lpcc, nac)
    T = (Lp - flen) // fshift + 1
    w = (n_lpcc - 1 if n_lpcc > 0 else nac - 1) if nac else 0
    feat = torch.empty((B, T, nceps + w), dtype=torch.float32, device=dev)
    if B == 0:
        return feat
    lib = _build.load()
    op = signal_operator(lib, fft.mel, fft.acorr, N)
    wsums = _wide_rows(lib, B * T, nmel + nac, dev)
    with torch.cuda.device(dev):
        err = lib.srt_full_signals_frontend(
            signals.data_ptr(), n_valid.data_ptr(), fft.window.data_ptr(),
            op.data_ptr(), dct.data_ptr(), feat.data_ptr(), _ptr(wsums), B,
            Lp, T, flen, fshift, N, nmel, nac, nceps, float(fft.pre_emph),
            int(bool(fft.preemph_first)), float(floor), int(bool(cmvn)),
            n_lpcc, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "full-spectrum frontend kernel from the signals")
    global FULL_SIGNAL_LAUNCHES, CHUNKED_LAUNCHES
    FULL_SIGNAL_LAUNCHES += 1
    CHUNKED_LAUNCHES += nmel + nac > 512
    return feat


def _check_lpcc(n_lpcc: int, nac: int):
    """Raise unless the kernels' LPC-cepstra tail takes n_lpcc cepstra of
    an autocorrelation of nac lags (LPCC_MAX_LAGS)."""
    if n_lpcc > 0 and not 0 < nac <= LPCC_MAX_LAGS:
        raise ValueError(f"the LPC cepstra take 1 to {LPCC_MAX_LAGS} "
                         f"autocorrelation lags in the kernels, got {nac}")


def chirp_size(n_fft: int, frame_len: int) -> int:
    """M of the chirp-z route for an n_fft-point DFT of frames of frame_len
    samples: the least power of two, at least CHIRP_MIN_M, that holds the
    linear convolution of L = min(frame_len, n_fft) and L + n_fft/2 terms;
    0 where the route does not serve (n_fft a power of two, or M past
    CHIRP_MAX_M). csrc/rfft_cluster.cuh srt_cluster::chirp_m in Python."""
    if n_fft < 2 or frame_len < 1 or n_fft & (n_fft - 1) == 0:
        return 0
    need = min(frame_len, n_fft) + n_fft // 2
    m = CHIRP_MIN_M
    while m < need and m <= CHIRP_MAX_M:
        m *= 2
    return m if m <= CHIRP_MAX_M else 0


@functools.lru_cache(maxsize=16)
def _chirp_tables(n_fft: int, frame_len: int, device: torch.device):
    L = min(frame_len, n_fft)
    nb, M = n_fft // 2 + 1, chirp_size(n_fft, frame_len)
    if M == 0:
        raise ValueError(f"no chirp-z route at n_fft {n_fft}, frame_len "
                         f"{frame_len}: its convolution passes "
                         f"{CHIRP_MAX_M} points or n_fft is a power of two")
    # c_j = exp(-pi i j^2 / n_fft), the angle from j^2 mod 2 n_fft in
    # integers, so that it is exact before float64's pi
    j = np.arange(max(L, nb), dtype=np.int64)
    c = np.exp(-1j * np.pi * ((j * j) % (2 * n_fft)) / n_fft)
    b = np.zeros(M, np.complex128)
    b[:nb] = np.conj(c[:nb])
    b[M - L + 1:] = np.conj(c[1:L])[::-1]  # b_m, m in (-L, 0), wrapped
    bh = np.fft.fft(b) / M
    pairs = lambda z: torch.from_numpy(  # noqa: E731
        np.stack([z.real, z.imag], axis=-1).astype(np.float32)).to(device)
    return pairs(c[:L]), pairs(bh)


def chirp_tables(n_fft: int, frame_len: int, device="cpu"):
    """(c [L, 2], Bh [M, 2]) float32 (real, imaginary) pairs: the chirp c_j
    = exp(-pi i j^2 / n_fft) for j < L = min(frame_len, n_fft), and the
    FFT over M = chirp_size(n_fft, frame_len) points of b, b_m =
    conj(c_m) for m in (-L, n_fft/2] wrapped mod M, divided by M: the
    tables of the chirp-z route (csrc/frontend_chirp.cu), float64 on the
    host, then f32; built once per (n_fft, frame_len, device)."""
    return _chirp_tables(int(n_fft), int(frame_len), torch.device(device))


@functools.lru_cache(maxsize=16)
def _chirp_cluster_bh(n_fft: int, frame_len: int, device: torch.device):
    bh = chirp_tables(n_fft, frame_len, device)[1]
    M = bh.shape[0]
    if M <= CHIRP_CLUSTER_M:
        C = M // CLUSTER_BLOCK
        return bh.view(CLUSTER_BLOCK, C, 2).transpose(0, 1).contiguous()
    m1, m2 = passes_shape(M)
    return bh.view(m2, m1, 2).transpose(0, 1).contiguous()


def passes_shape(T: int) -> tuple[int, int]:
    """(T1, T2): the device-memory passes' matrix of a T-point transform
    (csrc/rfft_passes.cuh), T1 = 2^(lg T - lg T // 2) >= T2 = 2^(lg T //
    2)."""
    lg = T.bit_length() - 1
    return 1 << (lg - lg // 2), 1 << (lg // 2)


def chirp_cluster_bh(n_fft: int, frame_len: int, device="cpu"):
    """Bh of chirp_tables in the order of csrc/frontend_chirp_cluster.cu,
    for M > CHIRP_TILE_M: up to CHIRP_CLUSTER_M the cluster's decimated
    order ([M / CLUSTER_BLOCK][CLUSTER_BLOCK, 2]: Bh[C m1 + m2] at [m2][m1],
    the slot of A[C m1 + m2] after the forward FFT), past it the passes'
    [M1][M2, 2] (Bh[k1 + M1 k2] at [k1][k2], the place of A[k1 + M1 k2]
    after the row pass); built once per (n_fft, frame_len, device)."""
    return _chirp_cluster_bh(int(n_fft), int(frame_len),
                             torch.device(device))


def _chirp_power(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """|DFT_n_fft(x)|^2 of [..., flen] frames (bins 0..n_fft/2) as the
    chirp-z route computes it: samples t >= n_fft fold onto t mod n_fft,
    a_n = x_n c_n, y = FFT_M(conj(FFT_M(a) Bh)), power |y_k|^2 (|c_k| = 1)."""
    c, bh = chirp_tables(n_fft, x.shape[-1], x.device)
    a = _fold(x, n_fft) * torch.view_as_complex(c)
    A = torch.fft.fft(a, n=bh.shape[0])
    y = torch.fft.fft(torch.conj(A * torch.view_as_complex(bh)))
    y = y[..., :n_fft // 2 + 1]
    return y.real * y.real + y.imag * y.imag


def mfcc_from_frames_chirp_reference(wp, mel, dct, floor: float, acorr,
                                     n_fft: int):
    """The full-spectrum frontend on the chirp-z route in plain torch: what
    K5's chirp-z kernel computes from the same tables (mel and acorr rows
    past n_fft/2 are not read)."""
    nb = n_fft // 2 + 1
    power = torch.clamp_min(_chirp_power(wp, n_fft), floor)
    return (torch.log(torch.clamp_min(power @ mel[:nb], floor)) @ dct,
            power @ acorr[:nb])


def _dft(frames, D, mm_bf16: bool):
    """frames . D, with both operands rounded to bf16 under mm_bf16."""
    return round_bf16(frames) @ round_bf16(D) if mm_bf16 else frames @ D


def packed_from_signals_reference(signals, n_valid, D, W, dct, A,
                                  floor: float, fshift: int, cmvn: bool,
                                  fuse_lpc: bool = True,
                                  mm_bf16: bool = False, n_lpcc: int = 0):
    """The plain torch frontend: explicit frames and matmuls."""
    frames = framing.frame_signal(signals, D.shape[0], fshift)
    T = frames.shape[-2]
    mask = torch.arange(T, device=signals.device) < n_valid[:, None]
    X = _dft(frames, D, mm_bf16)
    Y = X * X
    ceps = torch.log(torch.clamp_min(Y @ W, floor)) @ dct
    return _signal_features(ceps, Y @ A, mask, cmvn, fuse_lpc, n_lpcc)


def packed_from_signals(signals, n_valid, D, W, dct, A, floor: float,
                        fshift: int, cmvn: bool,
                        fft: FftRoute | None = None, fuse_lpc: bool = True,
                        mm_bf16: bool = False, n_lpcc: int = 0):
    """[B, Lp] signals, [B] int32 n_valid -> [B, T, n_ceps + order], with
    n_lpcc > 0 [B, T, n_ceps + n_lpcc - 1] (the LPC cepstra), or without
    fuse_lpc ([B, T, n_ceps], [B, T, order+1] raw autocorrelation; on the
    card two views of one buffer). On the CPU the plain version with D, W,
    A (the FFT route's where D is None: a frontend of N >= 32768 builds no
    dense operators); on the card the FFT kernel, which takes `fft`
    instead: with n_lpcc > 0 below BIG_N csrc/frontend_lpcc_signals.cu
    (LPCC_SIGNAL_LAUNCHES), otherwise csrc/frontend.cu (LAUNCHES, or the
    four-step route's BIG_LAUNCHES from BIG_N on). mm_bf16: the dense
    product with bf16 operands (D, W, A on either device; csrc/
    frontend_bf16.cu on the card, which has no LPC cepstra)."""
    if mm_bf16 and D is None:
        raise ValueError("mm_bf16 rounds the dense DFT operand: pass D, W, "
                         "A (PackedFrontend builds them at mm='bf16')")
    if n_lpcc > 0 and (mm_bf16 or not fuse_lpc):
        raise ValueError("the LPC cepstra follow the Levinson: fuse_lpc, and "
                         "not mm_bf16 (its kernel returns the raw "
                         "autocorrelation for them)")
    if signals.device.type == "cpu":
        if D is None:
            return packed_from_signals_fft_reference(
                signals, n_valid, fft, dct, floor, fshift, cmvn, fuse_lpc,
                n_lpcc)
        return packed_from_signals_reference(signals, n_valid, D, W, dct, A,
                                             floor, fshift, cmvn, fuse_lpc,
                                             mm_bf16, n_lpcc)
    if signals.device.type != "cuda":
        raise ValueError(f"no frontend for device {signals.device}")
    if mm_bf16:
        return _signals_bf16(signals, n_valid, D, W, dct, A, floor, fshift,
                             cmvn, fuse_lpc)
    if fft is None:
        raise ValueError("the signal frontend kernel runs the FFT route: "
                         "pass fft= (features.extract.PackedFrontend.fft)")
    dev = signals.device
    _build.check_tensor(signals, "signals", torch.float32, 2, dev)
    _build.check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    for t, name in ((fft.window, "window"), (fft.mel, "mel"),
                    (fft.acorr, "acorr"), (dct, "dct")):
        _build.check_tensor(t, name, torch.float32, 1 if t is fft.window
                            else 2, dev)
    B, Lp = signals.shape
    flen, N = fft.window.shape[0], fft.n_fft
    nmel, nceps = dct.shape
    nac = fft.acorr.shape[1]
    order = max(nac - 1, 0)
    if (n_valid.shape[0] != B or fft.mel.shape[1] != nmel
            or min(fft.mel.shape[0], fft.acorr.shape[0]) < N // 2 + 1
            or fshift < 1 or Lp < flen or 2 * flen > N):
        raise ValueError(
            f"inconsistent frontend shapes: signals {tuple(signals.shape)}, "
            f"n_valid {tuple(n_valid.shape)}, window {flen}, n_fft {N}, mel "
            f"{tuple(fft.mel.shape)}, acorr {tuple(fft.acorr.shape)}, dct "
            f"{tuple(dct.shape)}, fshift {fshift}")
    _check_lpcc(n_lpcc, nac)
    lib = _build.load()
    T = (Lp - flen) // fshift + 1
    w = nac if not fuse_lpc else n_lpcc - 1 if n_lpcc > 0 else order
    feat = torch.empty((B, T, nceps + w), dtype=torch.float32, device=dev)
    lpcc_tile = n_lpcc > 0 and N < BIG_N
    if lpcc_tile and B == 0:
        return feat
    global LAUNCHES, BIG_LAUNCHES, CHUNKED_LAUNCHES, LPCC_SIGNAL_LAUNCHES
    args = (signals.data_ptr(), n_valid.data_ptr(), fft.window.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if N >= BIG_N:
            chunk, scratch = _big_scratch(lib, N, nmel + nac, B * T, dev)
            op = _big_operator(lib, fft.mel, fft.acorr, N)
            # the LPC cepstra follow the raw pass's rows (csrc/frontend.cu
            # lpcc_kernel)
            raw = (torch.empty((B, T, nceps + nac), dtype=torch.float32,
                               device=dev) if n_lpcc > 0 else None)
            err = lib.srt_big_packed_frontend(
                *args, op.data_ptr(), dct.data_ptr(), feat.data_ptr(),
                scratch.data_ptr(), B, Lp, T, flen, fshift, N, nmel, nac,
                nceps, float(fft.pre_emph), int(bool(fft.preemph_first)),
                float(floor), int(bool(cmvn)), int(bool(fuse_lpc)), n_lpcc,
                _ptr(raw), chunk, stream)
        elif lpcc_tile:
            op = signal_operator(lib, fft.mel, fft.acorr, N)
            wsums = _wide_rows(lib, B * T, nmel + nac, dev)
            err = lib.srt_lpcc_signals_frontend(
                *args, op.data_ptr(), dct.data_ptr(), feat.data_ptr(),
                _ptr(wsums), B, Lp, T, flen, fshift, N, nmel, nac, nceps,
                float(fft.pre_emph), int(bool(fft.preemph_first)),
                float(floor), int(bool(cmvn)), n_lpcc, stream)
        else:
            op = _packed_operator(lib, fft.mel, fft.acorr, N)
            wsums = _wide_rows(lib, B * T, nmel + nac, dev)
            err = lib.srt_packed_frontend(
                *args, op.data_ptr(), dct.data_ptr(), feat.data_ptr(),
                _ptr(wsums), B, Lp, T, flen, fshift, N, nmel, nac, nceps,
                float(fft.pre_emph), int(bool(fft.preemph_first)),
                float(floor), int(bool(cmvn)), int(bool(fuse_lpc)), stream)
    _build.check(err, "packed frontend kernel")
    if N >= BIG_N:
        BIG_LAUNCHES += 1
        count_big_passes(N)
    else:
        if lpcc_tile:
            LPCC_SIGNAL_LAUNCHES += 1
        else:
            LAUNCHES += 1
        CHUNKED_LAUNCHES += nmel + nac > 512
    if fuse_lpc:
        return feat
    return feat[..., :nceps], feat[..., nceps:]


def _dense_shapes(name: str, D, W, dct, A, dev):
    """Check the dense operators for a bf16 kernel; (flen, ncols, nmel,
    nceps, nac)."""
    for t, what in ((D, "D"), (W, "W"), (dct, "dct"), (A, "A")):
        _build.check_tensor(t, what, torch.float32, 2, dev)
    flen, ncols = D.shape
    nmel, nceps = dct.shape
    if W.shape != (ncols, nmel) or A.shape[0] != ncols:
        raise ValueError(
            f"inconsistent {name} operators: D {tuple(D.shape)}, W "
            f"{tuple(W.shape)}, dct {tuple(dct.shape)}, A {tuple(A.shape)}")
    return flen, ncols, nmel, nceps, A.shape[1]


def dft_mma_operator(D: torch.Tensor) -> torch.Tensor:
    """D [flen, ncols] as the bf16 tile's B operand (csrc/packed_tile.cuh),
    flat bf16: D rounded to bf16 (nearest even), its rows padded with zeros
    to a multiple of MMA_DEPTH, its columns to a multiple of MMA_COLUMNS,
    in the order the kernel streams and reads it: per chunk of 64 columns,
    per k-step of 16 rows, per pair of n8 tiles (16 columns), per lane
    (g, t) = (lane // 4, lane % 4) the 8 values of its two B fragments of
    mma.sync m16n8k16: rows 2t, 2t+1, 2t+8, 2t+9 of column 8 nt + g for nt
    = 0, 1, each 32-bit word holding the lower row in its low half. Built
    once per D and again after D is written to."""
    return _cached((D,), _pack_dft_mma)


def _pack_dft_mma(D: torch.Tensor) -> torch.Tensor:
    flen, ncols = D.shape
    kp = -(-flen // MMA_DEPTH) * MMA_DEPTH
    cp = -(-ncols // MMA_COLUMNS) * MMA_COLUMNS
    full = D.new_zeros((kp, cp), dtype=torch.bfloat16)
    full[:flen, :ncols] = D
    # row 16 ks + 8 kb + 2 t + h, column 64 c + 16 p + 8 nt + g
    v = full.view(kp // 16, 2, 4, 2, cp // 64, 4, 2, 8)
    return v.permute(4, 0, 5, 7, 2, 6, 1, 3).reshape(-1)


def dense_wa_operator(W: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """[W | A] ([ncols, nmel], [ncols, nac]) as the bf16 tile's stage 2
    reads it (csrc/packed_tile.cuh), flat f32: a lane takes outputs og + 8 j
    for j < opl, opl 9 up to 72 outputs and 16 past them, in output chunks
    of 128 past 128; per output chunk, per column chunk of MMA_COLUMNS
    (zero columns past ncols), per column, per og, the lane's opl weights
    (zeros past nmel + nac) padded with zeros to 12 (opl 9) or 20 (opl 16),
    so that its 16-byte loads of the 8 groups fall in distinct banks. Built
    once per (W, A) and again after either is written to."""
    return _cached((W, A), _pack_dense_wa)


def _pack_dense_wa(W: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    ncols, nmel = W.shape
    nout = nmel + A.shape[1]
    opl = 9 if nout <= 72 else 16
    nop, ogs = 8 * opl, 12 if opl == 9 else 20
    nch = 1 if nout <= 128 else -(-nout // 128)
    ncc = -(-ncols // MMA_COLUMNS)
    full = W.new_zeros((ncc * MMA_COLUMNS, nch * nop))
    full[:ncols, :nmel] = W
    full[:ncols, nmel:nout] = A
    # output oc nop + 8 j + og of column c MMA_COLUMNS + cc
    v = full.view(ncc, MMA_COLUMNS, nch, opl, 8).permute(2, 0, 1, 4, 3)
    return torch.nn.functional.pad(v, (0, ogs - opl)).reshape(-1)


# the kernels' packed operators: (builder, ids of its tensors, its other
# arguments) -> (the tensors, their versions, the operator); an entry holds
# its tensors, so their ids stay theirs while it lives
_OPERATORS: dict = {}


def _cached(ts: tuple, build, *args):
    """build(*ts, *args), kept while no tensor of ts is written to."""
    key = (build, *(id(t) for t in ts), *args)
    hit = _OPERATORS.get(key)
    versions = tuple(t._version for t in ts)
    if hit is not None and hit[1] == versions:
        return hit[2]
    op = build(*ts, *args)
    if len(_OPERATORS) >= 16:
        _OPERATORS.clear()
    _OPERATORS[key] = (ts, versions, op)
    return op


def _bf16_rows(lib, nframes: int, nout: int, dev) -> torch.Tensor | None:
    """The device rows the bf16 tile keeps its sums in past 128 outputs,
    or None up to 128."""
    n = lib.srt_frontend_bf16_wide_floats(nframes, nout)
    return torch.empty(n, dtype=torch.float32, device=dev) if n else None


def _signals_bf16(signals, n_valid, D, W, dct, A, floor, fshift, cmvn,
                  fuse_lpc):
    """Check and launch K1's bf16 kernel (csrc/frontend_bf16.cu)."""
    dev = signals.device
    _build.check_tensor(signals, "signals", torch.float32, 2, dev)
    _build.check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    flen, ncols, nmel, nceps, nac = _dense_shapes("frontend", D, W, dct, A,
                                                  dev)
    B, Lp = signals.shape
    if n_valid.shape[0] != B or fshift < 1 or Lp < flen:
        raise ValueError(
            f"inconsistent frontend shapes: signals {tuple(signals.shape)}, "
            f"n_valid {tuple(n_valid.shape)}, D {tuple(D.shape)}, fshift "
            f"{fshift}")
    T = (Lp - flen) // fshift + 1
    order = max(nac - 1, 0)
    feat = torch.empty((B, T, nceps + (order if fuse_lpc else nac)),
                       dtype=torch.float32, device=dev)
    if B:
        lib = _build.load()
        wsums = _bf16_rows(lib, B * T, nmel + nac, dev)
        Dp, WAp = dft_mma_operator(D), dense_wa_operator(W, A)
        with torch.cuda.device(dev):
            err = lib.srt_frontend_bf16(
                signals.data_ptr(), n_valid.data_ptr(), Dp.data_ptr(),
                WAp.data_ptr(), dct.data_ptr(), feat.data_ptr(),
                _ptr(wsums), B, Lp, T, flen, fshift, ncols, nmel, nac, nceps,
                float(floor), int(bool(cmvn)), int(bool(fuse_lpc)),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "packed frontend bf16 kernel")
        global BF16_LAUNCHES
        BF16_LAUNCHES += 1
    if fuse_lpc:
        return feat
    return feat[..., :nceps], feat[..., nceps:]


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _wide_rows(lib, nframes: int, nout: int, dev) -> torch.Tensor | None:
    """The device rows the FFT tile keeps its sums in past 512 outputs, or
    None up to 512."""
    n = lib.srt_fft_wide_floats(nframes, nout)
    return torch.empty(n, dtype=torch.float32, device=dev) if n else None


def count_big_passes(n_fft: int):
    """Count a launch of the four-step route at n_fft in BIG_PASSES_LAUNCHES
    where it runs the device-memory passes (past CLUSTER_MAX_N)."""
    global BIG_PASSES_LAUNCHES
    BIG_PASSES_LAUNCHES += n_fft > CLUSTER_MAX_N


def _chunk(floats, nframes: int) -> int:
    """The most frames c <= min(nframes, 65535) (at least one) whose
    scratch, floats(c) floats, BIG_SCRATCH_BYTES hold."""
    lo, hi = 1, max(1, min(65535, nframes))
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if 4 * floats(mid) <= BIG_SCRATCH_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


def big_chunk(lib, n_fft: int, nout: int, nframes: int) -> int:
    """Frames a chunk of the route of N >= 32768: as many as
    BIG_SCRATCH_BYTES hold (at least one, at most the grid's 65535)."""
    if lib.srt_big_scratch_floats(n_fft, nout, 1) < 0:
        raise ValueError(f"no four-step FFT at n_fft {n_fft}: it takes a "
                         "power of two in [32768, 2^24]")
    return _chunk(lambda c: lib.srt_big_scratch_floats(n_fft, nout, c),
                  nframes)


def chirp_chunk(lib, n_fft: int, frame_len: int, nout: int,
                nframes: int) -> int:
    """Frames a chunk of the chirp-z route past M = CHIRP_TILE_M, as
    big_chunk."""
    return _chunk(lambda c: lib.srt_chirp_scratch_floats(
        n_fft, frame_len, nout, c), nframes)


def _big_scratch(lib, n_fft: int, nout: int, nframes: int, dev):
    """(frames a chunk, the scratch) of the route of N >= 32768
    (big_chunk)."""
    chunk = big_chunk(lib, n_fft, nout, nframes)
    return chunk, torch.empty(lib.srt_big_scratch_floats(n_fft, nout, chunk),
                              dtype=torch.float32, device=dev)


def _packed_operator(lib, mel, acorr, n_fft: int) -> torch.Tensor:
    """[mel | acorr | 0] rows 0..n_fft/2 in the FFT tile's layout (csrc/
    frontend_fft.cu srt_fft_operator_shape; past 512 outputs one such
    operator per chunk of 512 columns, stacked), built once per (mel,
    acorr, n_fft) and rebuilt after either is written to."""
    return _cached((mel, acorr), _fft_operator, n_fft, lib)


def signal_operator(lib, mel, acorr, n_fft: int) -> torch.Tensor:
    """[mel | acorr | 0] rows 0..n_fft/2 packed for csrc/signal_tile.cuh's
    tensor-core projection (csrc/frontend_full_signals.cu
    srt_full_signals_operator_shape; K5's mel and autocorrelation, or K1's
    bin-domain M and R for csrc/frontend_lpcc_signals.cu), built once per
    (mel, acorr, n_fft) and rebuilt after either is written to
    (_pack_signal_operator)."""
    return _cached((mel, acorr), _pack_signal_operator, n_fft, lib)


def _pack_signal_operator(mel, acorr, n_fft: int, lib) -> torch.Tensor:
    """The operator as the projection reads it, one float32 tensor on
    mel's device. A block is bins 8 ks .. 8 ks + 7 by an n-tile's 8
    columns of one output chunk of 8 * opl columns, B of mma.sync m16n8k8:
    lane 4 g + t holds (hi(B[t][g]), hi(B[t + 4][g]), lo(B[t][g]), lo(B[t
    + 4][g])), hi = round_tf32(b), lo = round_tf32(b - hi); blocks that
    are all zero are left out. The autocorrelation starts at column ac0,
    the first column of an n-tile past the mel columns where one output
    chunk holds it, else nmel. Each (chunk, column group)'s k-steps are
    cut into ksplit shares of about even block counts, one a warp; the
    blocks run by chunk, group, share, n-tile, k-step. The header (int32):
    ac0; runs [chunks * groups * ksplit][n-tiles a group + 1], the first
    block of each n-tile's run in its share and the end; tags [blocks],
    each block's k-step; padded to 4; then the blocks, [32][4] floats
    each."""
    nmel, nac = mel.shape[1], acorr.shape[1]
    shape = [ctypes.c_int() for _ in range(4)]
    if lib.srt_full_signals_operator_shape(
            n_fft, nmel + nac, *(ctypes.byref(v) for v in shape)) < 0:
        raise ValueError(f"no signal tile at n_fft {n_fft}: it takes a power "
                         f"of two in [64, {BIG_N // 2}]")
    nt, G, C, KS = (v.value for v in shape)
    npw, nop = nt // G, 8 * nt
    nb = n_fft // 2 + 1
    ks = -(-nb // 8)
    dev = mel.device
    # the autocorrelation from an n-tile's first column where it fits, so
    # that its dense columns and the mel bands share no n-tile
    ac0 = -(-nmel // 8) * 8
    if C > 1 or ac0 + nac > nop:
        ac0 = nmel
    full = torch.zeros(8 * ks, C * nop, dtype=torch.float32, device=dev)
    full[:nb, :nmel] = mel[:nb]
    full[:nb, ac0:ac0 + nac] = acorr[:nb]
    # [chunk * group, k-step, n-tile, kk (bin in the k-step), nn (column)]
    blk = full.view(ks, 8, C * G, npw, 8).permute(2, 0, 3, 1, 4)
    live = blk.ne(0).flatten(-2).any(-1)  # [chunk * group, k-step, n-tile]
    # the shares: share s of a list starts at the first k-step holding
    # block s * n / KS of it (n its blocks), rounded up; the last ends at ks
    cum = torch.cat([live.new_zeros(C * G, 1, dtype=torch.long),
                     live.sum(-1).cumsum(1)], 1)
    target = (torch.arange(KS + 1, device=dev) * cum[:, -1:] + KS - 1) // KS
    cuts = torch.searchsorted(cum.contiguous(), target.contiguous())
    share = (torch.arange(ks, device=dev)[None, :, None]
             >= cuts[:, None, 1:-1]).sum(-1)  # [list, k-step]
    # each live block's run (list, share, n-tile) and its order in the list
    run = ((torch.arange(C * G, device=dev)[:, None, None] * KS
            + share[..., None]) * npw + torch.arange(npw, device=dev))
    order = (run * ks + torch.arange(ks, device=dev)[None, :, None])[live]
    order = order.argsort()
    # lane 4 g + t: (B[t][g], B[t + 4][g])
    frag = torch.stack([blk[..., :4, :], blk[..., 4:, :]], -1)
    frag = frag.transpose(-3, -2).reshape(*live.shape, 32, 2)[live][order]
    hi = round_tf32(frag)
    frag = torch.cat([hi, round_tf32(frag - hi)], -1)
    tags = live.nonzero()[order][:, 1]
    starts = torch.zeros(C * G * KS * npw + 1, dtype=torch.long, device=dev)
    starts[1:] = torch.bincount(run[live], minlength=C * G * KS * npw).cumsum(0)
    runs = torch.cat([starts[:-1].view(-1, npw), starts[npw::npw, None]], 1)
    head = torch.cat([runs.new_full((1,), ac0), runs.flatten(), tags])
    head = head.to(torch.int32)
    head = torch.nn.functional.pad(head, (0, -head.numel() % 4))
    return torch.cat([head.view(torch.float32), frag.reshape(-1)])


def _big_operator(lib, mel, acorr, n_fft: int) -> torch.Tensor:
    """The same layout for the four-step route's fused pass (csrc/
    frontend_big.cu srt_big_operator_shape: rows to its own chunk of
    bins), cached alike."""
    return _cached((mel, acorr), _fft_operator, n_fft, lib,
                   "srt_big_operator_shape")


def _chirp_operator(lib, mel, acorr, n_fft: int,
                    frame_len: int) -> torch.Tensor:
    """The same layout for the chirp-z kernel (csrc/frontend_chirp.cu
    srt_chirp_operator_shape), cached alike."""
    return _cached((mel, acorr), _fft_operator, n_fft, lib,
                   "srt_chirp_operator_shape", frame_len)


def _fft_operator(mel, acorr, n_fft: int, lib,
                  shape: str = "srt_fft_operator_shape",
                  frame_len: int | None = None) -> torch.Tensor:
    nmel, nac = mel.shape[1], acorr.shape[1]
    rows, cols, chunks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lead = (n_fft,) if frame_len is None else (n_fft, frame_len)
    if getattr(lib, shape)(*lead, nmel + nac, ctypes.byref(rows),
                           ctypes.byref(cols), ctypes.byref(chunks)) < 0:
        raise ValueError(
            {"srt_fft_operator_shape": f"no FFT tile at n_fft {n_fft}: it "
             f"takes a power of two in [64, {BIG_N // 2}]",
             "srt_big_operator_shape": f"no four-step FFT at n_fft {n_fft}: "
             "it takes a power of two in [32768, 2^24]",
             "srt_chirp_operator_shape": f"no chirp-z route at n_fft "
             f"{n_fft}, frame_len {frame_len}"}[shape])
    nb = n_fft // 2 + 1
    full = torch.cat([mel[:nb], acorr[:nb]], dim=1)
    c, R = cols.value, rows.value // chunks.value
    op = mel.new_zeros((rows.value, c))
    for k in range(chunks.value):
        part = full[:, k * c:(k + 1) * c]
        op[k * R:k * R + nb, :part.shape[1]] = part
    return op


def packed_from_frames_reference(frames, D, W, dct, floor: float, A,
                                 mm_bf16: bool = False):
    """The plain torch frame-level packed frontend."""
    Y = _dft(frames, D, mm_bf16) ** 2
    return torch.log(torch.clamp_min(Y @ W, floor)) @ dct, Y @ A


def bf16_cepstra_limits(frames, D, W, dct, floor: float, mask, cmvn: bool,
                        ulps: float, atol: float) -> torch.Tensor:
    """[B, T, n_ceps] limits on how far two f32 computations of the dense
    product's cepstra on bf16-rounded operands (mm_bf16's kernels and their
    plain version) may lie apart, for [B, T, flen] frames and [B, T] mask.

    The mel sums M = X^2 . W of the two are held within `ulps` units of
    2^-24 sum |X^2| |W|, the rounding of f32 sums of the same products in
    another order, however far M cancels (W interpolates the power on
    2*flen points and has negative weights: at 128 filters a narrow
    filter's sum cancels to 1e-7 of its magnitudes). That is carried to
    first order through the log, the DCT and, with cmvn, the masked CMVN
    (its mean and its deviation) and is never under `atol`: a cepstrum whose
    mel sums cancel little keeps `atol` as its limit. Float64, from X of the
    same rounded operands."""
    dd = torch.float64
    Y = (round_bf16(frames).to(dd) @ round_bf16(D).to(dd)) ** 2
    M = Y @ W.to(dd)
    kappa = (Y @ W.to(dd).abs() / M.abs().clamp_min(floor)) @ dct.to(
        dd).abs()
    lim = ulps * 2.0 ** -24 * kappa
    if cmvn:
        m = mask[..., None].to(dd)
        count = m.sum(dim=-2, keepdim=True)
        n = count.clamp_min(1.0)
        c = torch.log(torch.clamp_min(M, floor)) @ dct.to(dd)
        mu = (c * m).sum(dim=-2, keepdim=True) / n
        sd = torch.sqrt(((c - mu) ** 2 * m).sum(dim=-2, keepdim=True) / n)
        mean = (lim * m).sum(dim=-2, keepdim=True) / n
        rms = torch.sqrt((lim ** 2 * m).sum(dim=-2, keepdim=True) / n)
        normed = (lim + mean + (c - mu).abs() / sd * rms) / sd
        lim = torch.where(count > 1, normed, lim)
    return lim.clamp_min(atol)


def packed_from_frames_fft_reference(frames, fft: FftRoute, dct,
                                     floor: float):
    """The frame-level packed frontend on an FFT in plain torch: what K4's
    kernel computes (window and pre-emphasis per sample, the n_fft-point
    power, the bin-domain operators)."""
    flen = frames.shape[-1]
    Y = _power(framing.window_preemph(frames, flen, fft.pre_emph,
                                      fft.preemph_first), fft.n_fft)
    return (torch.log(torch.clamp_min(Y @ fft.mel, floor)) @ dct,
            Y @ fft.acorr)


def mfcc_from_frames_reference(wp, C, S, mel, dct, floor: float, acorr):
    """The plain torch full-spectrum frontend."""
    power = torch.clamp_min((wp @ C) ** 2 + (wp @ S) ** 2, floor)
    return torch.log(torch.clamp_min(power @ mel, floor)) @ dct, power @ acorr


def mfcc_from_frames_bf16(wp, C, S, mel, dct, floor: float, acorr):
    """The full-spectrum frontend with the DFT's operands (the frames, C
    and S) rounded to bf16 and f32 sums: the JAX extractor's bf16 product
    outside any kernel (features/extract.py:315-325). Plain torch on
    either device (TF32 stays off), counted in FULL_BF16_CALLS."""
    global FULL_BF16_CALLS
    FULL_BF16_CALLS += 1
    return mfcc_from_frames_reference(round_bf16(wp), round_bf16(C),
                                      round_bf16(S), mel, dct, floor, acorr)


def packed_from_frames(frames, D, W, dct, floor: float, A,
                       fft: FftRoute | None = None, mm_bf16: bool = False):
    """[n, flen] raw frames -> ([n, n_ceps] pre-CMVN cepstra, [n, nac] raw
    autocorrelation). On the CPU the plain version with D, W, A (the FFT
    route's where D is None); on the card the FFT kernel, which takes `fft`
    instead (PackedFrontend.fft). mm_bf16: the dense product with bf16
    operands (D, W, A on either device; csrc/frontend_bf16.cu on the card,
    the two results views of one buffer)."""
    if mm_bf16 and D is None:
        raise ValueError("mm_bf16 rounds the dense DFT operand: pass D, W, "
                         "A (PackedFrontend builds them at mm='bf16')")
    if frames.device.type == "cpu":
        if D is None:
            return packed_from_frames_fft_reference(frames, fft, dct, floor)
        return packed_from_frames_reference(frames, D, W, dct, floor, A,
                                            mm_bf16)
    if frames.device.type != "cuda":
        raise ValueError(f"no frontend for device {frames.device}")
    if mm_bf16:
        return _frames_bf16(frames, D, W, dct, floor, A)
    if fft is None:
        raise ValueError("the frame-level packed kernel runs the FFT route: "
                         "pass fft= (features.extract.PackedFrontend.fft)")
    dev = frames.device
    _build.check_tensor(frames, "frames", torch.float32, 2, dev)
    _build.check_tensor(fft.window, "window", torch.float32, 1, dev)
    for t, name in ((fft.mel, "mel"), (fft.acorr, "acorr"), (dct, "dct")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    n, flen = frames.shape
    N = fft.n_fft
    nmel, nceps = dct.shape
    nac = fft.acorr.shape[1]
    if (fft.window.shape[0] != flen or fft.mel.shape[1] != nmel
            or min(fft.mel.shape[0], fft.acorr.shape[0]) < N // 2 + 1
            or 2 * flen > N):
        raise ValueError(
            f"inconsistent frontend shapes: frames {tuple(frames.shape)}, "
            f"window {fft.window.shape[0]}, n_fft {N}, mel "
            f"{tuple(fft.mel.shape)}, acorr {tuple(fft.acorr.shape)}, dct "
            f"{tuple(dct.shape)}")
    lib = _build.load()
    ceps = torch.empty((n, nceps), dtype=torch.float32, device=dev)
    r = torch.empty((n, nac), dtype=torch.float32, device=dev)
    if n == 0:
        return ceps, r
    global FRAMES_LAUNCHES, FRAMES_BIG_LAUNCHES, CHUNKED_LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if N >= BIG_N:
            chunk, scratch = _big_scratch(lib, N, nmel + nac, n, dev)
            op = _big_operator(lib, fft.mel, fft.acorr, N)
            err = lib.srt_big_packed_frames(
                frames.data_ptr(), fft.window.data_ptr(), op.data_ptr(),
                dct.data_ptr(), ceps.data_ptr(), r.data_ptr(),
                scratch.data_ptr(), n, flen, N, nmel, nac, nceps,
                float(fft.pre_emph), int(bool(fft.preemph_first)),
                float(floor), chunk, stream)
        else:
            op = _packed_operator(lib, fft.mel, fft.acorr, N)
            wsums = _wide_rows(lib, n, nmel + nac, dev)
            err = lib.srt_fft_packed_frames(
                frames.data_ptr(), fft.window.data_ptr(), op.data_ptr(),
                dct.data_ptr(), ceps.data_ptr(), r.data_ptr(), _ptr(wsums),
                n, flen, N, nmel, nac, nceps, float(fft.pre_emph),
                int(bool(fft.preemph_first)), float(floor), stream)
    _build.check(err, "frame-level packed FFT frontend kernel")
    if N >= BIG_N:
        FRAMES_BIG_LAUNCHES += 1
        count_big_passes(N)
    else:
        FRAMES_LAUNCHES += 1
        CHUNKED_LAUNCHES += nmel + nac > 512
    return ceps, r


def _frames_bf16(frames, D, W, dct, floor, A):
    """Check and launch K4's bf16 kernel (csrc/frontend_bf16.cu)."""
    dev = frames.device
    _build.check_tensor(frames, "frames", torch.float32, 2, dev)
    flen, ncols, nmel, nceps, nac = _dense_shapes("frame-level", D, W, dct,
                                                  A, dev)
    n = frames.shape[0]
    if frames.shape[1] != flen:
        raise ValueError(f"frames {tuple(frames.shape)} do not fit D "
                         f"{tuple(D.shape)}")
    out = torch.empty((n, nceps + nac), dtype=torch.float32, device=dev)
    if n:
        lib = _build.load()
        wsums = _bf16_rows(lib, n, nmel + nac, dev)
        Dp, WAp = dft_mma_operator(D), dense_wa_operator(W, A)
        with torch.cuda.device(dev):
            err = lib.srt_frames_bf16(
                frames.data_ptr(), Dp.data_ptr(), WAp.data_ptr(),
                dct.data_ptr(), out.data_ptr(), _ptr(wsums), n, flen, ncols,
                nmel, nac, nceps, float(floor),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "frame-level packed bf16 kernel")
        global FRAMES_BF16_LAUNCHES
        FRAMES_BF16_LAUNCHES += 1
    return out[:, :nceps], out[:, nceps:]


def mfcc_from_frames(wp, C, S, mel, dct, floor: float, acorr,
                     n_fft: int | None = None):
    """[n, flen] windowed, pre-emphasized frames -> ([n, n_ceps] pre-CMVN
    cepstra, [n, nac] raw autocorrelation). On the card `n_fft` picks the
    kernel: the FFT kernel for a power of two, the chirp-z kernel where
    `chirp_size(n_fft, flen)` is not 0 (C and S unused by both, and may be
    None), the dense template (`mfcc_from_frames_dense`) past it."""
    if wp.device.type == "cpu":
        return mfcc_from_frames_reference(wp, C, S, mel, dct, floor, acorr)
    if wp.device.type != "cuda":
        raise ValueError(f"no frontend for device {wp.device}")
    if n_fft is None:
        raise ValueError("the full-spectrum kernels need n_fft")
    if n_fft & (n_fft - 1) == 0:
        return _fft_frames_kernel(wp, mel, dct, floor, acorr, n_fft)
    if chirp_size(n_fft, wp.shape[-1]):
        return _chirp_frames_kernel(wp, mel, dct, floor, acorr, n_fft)
    return mfcc_from_frames_dense(wp, C, S, mel, dct, floor, acorr)


def mfcc_from_frames_dense(wp, C, S, mel, dct, floor: float, acorr):
    """The full-spectrum frontend as dense DFT products (csrc/
    frontend_frames.cu): what mfcc_from_frames takes at an n_fft that is
    not a power of two. Any number of mel + autocorrelation outputs."""
    if wp.device.type == "cpu":
        return mfcc_from_frames_reference(wp, C, S, mel, dct, floor, acorr)
    if wp.device.type != "cuda":
        raise ValueError(f"no frontend for device {wp.device}")
    dev = wp.device
    _build.check_tensor(wp, "frames", torch.float32, 2, dev)
    for t, name in ((C, "C"), (S, "S"), (mel, "mel"), (dct, "dct"),
                    (acorr, "acorr")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    n, flen = wp.shape
    ncols = C.shape[1]
    nmel, nceps = dct.shape
    nac = acorr.shape[1]
    if (C.shape != (flen, ncols) or S.shape != (flen, ncols)
            or mel.shape != (ncols, nmel) or acorr.shape[0] != ncols):
        raise ValueError(
            f"inconsistent frontend shapes: frames {tuple(wp.shape)}, C/S "
            f"{tuple(C.shape)}, mel {tuple(mel.shape)}, dct "
            f"{tuple(dct.shape)}, acorr {tuple(acorr.shape)}")
    lib = _build.load()
    ceps = torch.empty((n, nceps), dtype=torch.float32, device=dev)
    r = torch.empty((n, nac), dtype=torch.float32, device=dev)
    if n == 0:
        return ceps, r
    # past 192 outputs the kernel keeps its sums in global rows
    scratch = torch.empty(lib.srt_frames_scratch_floats(n, nmel + nac),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_frames_frontend(
            wp.data_ptr(), C.data_ptr(), S.data_ptr(), mel.data_ptr(),
            acorr.data_ptr(), dct.data_ptr(), ceps.data_ptr(), r.data_ptr(),
            scratch.data_ptr(), n, flen, ncols, nmel, nac, nceps,
            float(floor), stream)
    _build.check(err, "dense full-spectrum frontend kernel")
    global FULL_DENSE_LAUNCHES
    FULL_DENSE_LAUNCHES += 1
    return ceps, r


def _fft_frames_kernel(wp, mel, dct, floor, ac, n_fft: int):
    """Check and launch csrc/frontend_fft.cu's kernel."""
    n, flen, nmel, nceps, nac = _full_shapes(wp, mel, dct, ac, n_fft)
    dev = wp.device
    lib = _build.load()
    ceps = torch.empty((n, nceps), dtype=torch.float32, device=dev)
    r = torch.empty((n, nac), dtype=torch.float32, device=dev)
    if n == 0:
        return ceps, r
    global FULL_LAUNCHES, FULL_BIG_LAUNCHES, CHUNKED_LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n_fft >= BIG_N:
            chunk, scratch = _big_scratch(lib, n_fft, nmel + nac, n, dev)
            op = _big_operator(lib, mel, ac, n_fft)
            err = lib.srt_big_fft_frames(
                wp.data_ptr(), op.data_ptr(), dct.data_ptr(),
                ceps.data_ptr(), r.data_ptr(), scratch.data_ptr(), n, flen,
                n_fft, nmel, nac, nceps, float(floor), chunk, stream)
        else:
            op = _packed_operator(lib, mel, ac, n_fft)
            wsums = _wide_rows(lib, n, nmel + nac, dev)
            err = lib.srt_fft_frames_frontend(
                wp.data_ptr(), op.data_ptr(), dct.data_ptr(), ceps.data_ptr(),
                r.data_ptr(), _ptr(wsums), n, flen, n_fft, nmel, nac, nceps,
                float(floor), stream)
    _build.check(err, "full-spectrum FFT frontend kernel")
    if n_fft >= BIG_N:
        FULL_BIG_LAUNCHES += 1
        count_big_passes(n_fft)
    else:
        FULL_LAUNCHES += 1
        CHUNKED_LAUNCHES += nmel + nac > 512
    return ceps, r


def _full_shapes(wp, mel, dct, ac, n_fft: int):
    """Check the frames and bin-domain operators of a K5 kernel on the
    card; (n, flen, nmel, nceps, nac)."""
    dev = wp.device
    _build.check_tensor(wp, "frames", torch.float32, 2, dev)
    for t, name in ((mel, "mel"), (dct, "dct"), (ac, "acorr")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    n, flen = wp.shape
    nmel, nceps = dct.shape
    if (mel.shape[1] != nmel
            or min(mel.shape[0], ac.shape[0]) < n_fft // 2 + 1):
        raise ValueError(
            f"inconsistent frontend shapes: frames {tuple(wp.shape)}, n_fft "
            f"{n_fft}, mel {tuple(mel.shape)}, dct {tuple(dct.shape)}, "
            f"acorr {tuple(ac.shape)}")
    return n, flen, nmel, nceps, ac.shape[1]


def _chirp_frames_kernel(wp, mel, dct, floor, ac, n_fft: int):
    """Check and launch the chirp-z route's kernel: csrc/frontend_chirp.cu
    up to M = CHIRP_TILE_M, csrc/frontend_chirp_cluster.cu past it (on the
    device-memory passes past CHIRP_CLUSTER_M, also counted in
    BIG_PASSES_LAUNCHES)."""
    n, flen, nmel, nceps, nac = _full_shapes(wp, mel, dct, ac, n_fft)
    dev = wp.device
    lib = _build.load()
    ceps = torch.empty((n, nceps), dtype=torch.float32, device=dev)
    r = torch.empty((n, nac), dtype=torch.float32, device=dev)
    if n == 0:
        return ceps, r
    cz, bh = chirp_tables(n_fft, flen, dev)
    op = _chirp_operator(lib, mel, ac, n_fft, flen)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bh.shape[0] > CHIRP_TILE_M:
            chunk = chirp_chunk(lib, n_fft, flen, nmel + nac, n)
            scratch = torch.empty(lib.srt_chirp_scratch_floats(
                n_fft, flen, nmel + nac, chunk), dtype=torch.float32,
                device=dev)
            err = lib.srt_chirp_cluster_frontend(
                wp.data_ptr(), cz.data_ptr(),
                chirp_cluster_bh(n_fft, flen, dev).data_ptr(), op.data_ptr(),
                dct.data_ptr(), ceps.data_ptr(), r.data_ptr(),
                scratch.data_ptr(), n, flen, n_fft, nmel, nac, nceps,
                float(floor), chunk, stream)
        else:
            wsums = _wide_rows(lib, n, nmel + nac, dev)
            err = lib.srt_chirp_frames_frontend(
                wp.data_ptr(), cz.data_ptr(), bh.data_ptr(), op.data_ptr(),
                dct.data_ptr(), ceps.data_ptr(), r.data_ptr(), _ptr(wsums),
                n, flen, n_fft, nmel, nac, nceps, float(floor), stream)
    _build.check(err, "full-spectrum chirp-z frontend kernel")
    global FULL_CHIRP_LAUNCHES, CHUNKED_LAUNCHES, BIG_PASSES_LAUNCHES
    FULL_CHIRP_LAUNCHES += 1
    CHUNKED_LAUNCHES += nmel + nac > 512 and bh.shape[0] <= CHIRP_TILE_M
    BIG_PASSES_LAUNCHES += bh.shape[0] > CHIRP_CLUSTER_M
    return ceps, r
