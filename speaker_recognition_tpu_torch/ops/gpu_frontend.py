"""The frontend kernels and their plain torch versions.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its
`*_reference` on a CPU tensor; any other device raises.

`packed_from_signals` (csrc/frontend.cu) computes, for [B, Lp] zero-padded
signals and [B] valid frame counts,
the [B, T, n_ceps + order] feature concat(MFCC, LPC) with
T = (Lp - frame_len)//fshift + 1, masked CMVN over the valid frames when
`cmvn` is set, and zeros at every frame at or past n_valid. The operators
come from ops/frontend.packed_frontend_operators:
D [frame_len, ncols] (window, pre-emphasis, half-spectrum DFT), W
[ncols, n_mel], dct [n_mel, n_ceps] and A [ncols, order+1] (Wiener-Khinchin
autocorrelation; zero columns for an MFCC-only config).

The frame-level kernels of csrc/frontend_frames.cu take [n, frame_len]
frames and return pre-CMVN cepstra [n, n_ceps] and the RAW
autocorrelation [n, order+1] (zero-width without LPC), which the LPC
cepstra need:
  `packed_from_frames`  raw frames, the packed operators D, W, A;
                        the floor applies to mel only;
  `mfcc_from_frames`    windowed, pre-emphasized frames, the cos/sin
                        operators C, S [frame_len, nb] (nb >= fft/2+1
                        bins), mel, acorr; the floor applies to each
                        power bin, then to mel.
"""

from __future__ import annotations

import torch

from .. import _build
from . import framing, levinson

# kernel launches since the last reset, one count per kernel; the CPU path
# does not count
LAUNCHES = 0          # csrc/frontend.cu, packed_from_signals
FRAMES_LAUNCHES = 0   # csrc/frontend_frames.cu, packed_from_frames
FULL_LAUNCHES = 0     # csrc/frontend_frames.cu, mfcc_from_frames

_MAX_ORDER = 32      # csrc/frontend.cu MAX_ORDER
_MAX_CEPS = 32       # one warp of columns in the CMVN kernel
_MAX_GRID_Y = 65535


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


def packed_from_signals_reference(signals, n_valid, D, W, dct, A,
                                  floor: float, fshift: int,
                                  cmvn: bool) -> torch.Tensor:
    """The plain torch frontend: explicit frames and matmuls."""
    frames = framing.frame_signal(signals, D.shape[0], fshift)
    T = frames.shape[-2]
    mask = torch.arange(T, device=signals.device) < n_valid[:, None]
    X = frames @ D
    Y = X * X
    ceps = torch.log(torch.clamp_min(Y @ W, floor)) @ dct
    if cmvn:
        ceps = masked_cmvn(ceps, mask)
    parts = [ceps]
    if A.shape[1]:
        parts.append(levinson.lpc_from_autocorr(Y @ A))
    feat = torch.cat(parts, dim=-1)
    return torch.where(mask[..., None], feat, torch.zeros_like(feat))


def packed_from_signals(signals, n_valid, D, W, dct, A, floor: float,
                        fshift: int, cmvn: bool) -> torch.Tensor:
    """[B, Lp] signals, [B] int32 n_valid -> [B, T, n_ceps + order]."""
    if signals.device.type == "cpu":
        return packed_from_signals_reference(signals, n_valid, D, W, dct, A,
                                             floor, fshift, cmvn)
    if signals.device.type != "cuda":
        raise ValueError(f"no frontend for device {signals.device}")
    dev = signals.device
    _build.check_tensor(signals, "signals", torch.float32, 2, dev)
    _build.check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    for t, name in ((D, "D"), (W, "W"), (dct, "dct"), (A, "A")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    B, Lp = signals.shape
    flen, ncols = D.shape
    nmel, nceps = dct.shape
    nac = A.shape[1]
    order = max(nac - 1, 0)
    if (n_valid.shape[0] != B or W.shape != (ncols, nmel)
            or A.shape[0] != ncols or fshift < 1 or Lp < flen):
        raise ValueError(
            f"inconsistent frontend shapes: signals {tuple(signals.shape)}, "
            f"n_valid {tuple(n_valid.shape)}, D {tuple(D.shape)}, W "
            f"{tuple(W.shape)}, dct {tuple(dct.shape)}, A {tuple(A.shape)}, "
            f"fshift {fshift}")
    if order > _MAX_ORDER or nceps > _MAX_CEPS or B > _MAX_GRID_Y:
        raise ValueError(f"frontend kernel limits: order {order} <= "
                         f"{_MAX_ORDER}, n_ceps {nceps} <= {_MAX_CEPS}, "
                         f"batch {B} <= {_MAX_GRID_Y}")
    lib = _build.load()
    if lib.srt_frontend_smem_bytes(flen, fshift, nmel, nac) < 0:
        raise ValueError(
            f"no frontend tiling fits a block's shared memory at frame_len "
            f"{flen}, frame_shift {fshift}, {nmel} mel + {nac} "
            f"autocorrelation outputs (at most 128)")
    T = (Lp - flen) // fshift + 1
    feat = torch.empty((B, T, nceps + order), dtype=torch.float32, device=dev)
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_packed_frontend(
            signals.data_ptr(), n_valid.data_ptr(), D.data_ptr(),
            W.data_ptr(), A.data_ptr(), dct.data_ptr(), feat.data_ptr(),
            B, Lp, T, flen, fshift, ncols, nmel, nac, nceps, float(floor),
            int(bool(cmvn)), stream)
    _build.check(err, "packed frontend kernel")
    LAUNCHES += 1
    return feat


def packed_from_frames_reference(frames, D, W, dct, floor: float, A):
    """The plain torch frame-level packed frontend."""
    Y = (frames @ D) ** 2
    return torch.log(torch.clamp_min(Y @ W, floor)) @ dct, Y @ A


def mfcc_from_frames_reference(wp, C, S, mel, dct, floor: float, acorr):
    """The plain torch full-spectrum frontend."""
    power = torch.clamp_min((wp @ C) ** 2 + (wp @ S) ** 2, floor)
    return torch.log(torch.clamp_min(power @ mel, floor)) @ dct, power @ acorr


def packed_from_frames(frames, D, W, dct, floor: float, A):
    """[n, flen] raw frames -> ([n, n_ceps] pre-CMVN cepstra, [n, nac] raw
    autocorrelation)."""
    if frames.device.type == "cpu":
        return packed_from_frames_reference(frames, D, W, dct, floor, A)
    return _frames_kernel(False, frames, (D,), W, dct, floor, A)


def mfcc_from_frames(wp, C, S, mel, dct, floor: float, acorr):
    """[n, flen] windowed, pre-emphasized frames -> ([n, n_ceps] pre-CMVN
    cepstra, [n, nac] raw autocorrelation)."""
    if wp.device.type == "cpu":
        return mfcc_from_frames_reference(wp, C, S, mel, dct, floor, acorr)
    return _frames_kernel(True, wp, (C, S), mel, dct, floor, acorr)


def _frames_kernel(full: bool, frames, dft, mel, dct, floor, ac):
    """Check and launch one of the csrc/frontend_frames.cu kernels: `dft` is
    (D,) for the packed kernel, (C, S) for the full-spectrum one."""
    if frames.device.type != "cuda":
        raise ValueError(f"no frontend for device {frames.device}")
    dev = frames.device
    _build.check_tensor(frames, "frames", torch.float32, 2, dev)
    names = ("C", "S") if full else ("D",)
    for t, name in zip((*dft, mel, dct, ac), (*names, "mel", "dct", "acorr")):
        _build.check_tensor(t, name, torch.float32, 2, dev)
    n, flen = frames.shape
    ncols = dft[0].shape[1]
    nmel, nceps = dct.shape
    nac = ac.shape[1]
    if (any(t.shape != (flen, ncols) for t in dft)
            or mel.shape != (ncols, nmel) or ac.shape[0] != ncols):
        raise ValueError(
            f"inconsistent frontend shapes: frames {tuple(frames.shape)}, "
            f"{'/'.join(names)} {tuple(dft[0].shape)}, mel "
            f"{tuple(mel.shape)}, dct {tuple(dct.shape)}, acorr "
            f"{tuple(ac.shape)}")
    lib = _build.load()
    if lib.srt_frames_smem_bytes(nmel + nac, int(full)) < 0:
        raise ValueError(f"{nmel} mel + {nac} autocorrelation outputs: the "
                         "frame-level kernels take at most 128")
    ceps = torch.empty((n, nceps), dtype=torch.float32, device=dev)
    r = torch.empty((n, nac), dtype=torch.float32, device=dev)
    if n == 0:
        return ceps, r
    C, S = dft if full else (dft[0], dft[0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_frames_frontend(
            frames.data_ptr(), C.data_ptr(), S.data_ptr(), mel.data_ptr(),
            ac.data_ptr(), dct.data_ptr(), ceps.data_ptr(), r.data_ptr(), n,
            flen, ncols, nmel, nac, nceps, float(floor), int(full), stream)
    _build.check(err, ("full-spectrum" if full else "frame-level packed")
                 + " frontend kernel")
    global FRAMES_LAUNCHES, FULL_LAUNCHES
    if full:
        FULL_LAUNCHES += 1
    else:
        FRAMES_LAUNCHES += 1
    return ceps, r
