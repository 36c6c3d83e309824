"""The plain reference of batch identification: padded signals -> [B, S]
per-speaker average GMM log-likelihoods.

It follows the reference implementation's description
(ppwwyyxx/speaker-recognition: src/feature/MFCC.py, LPC.py, __init__.py;
the GMM's density, src/gmm/gmm.cc, and its scoring, src/testbench/
gmmset.py:96-100), frame by frame in plain torch at float32, with no kernel
and nothing taken from the program under test:

  frames of win_length_ms every win_shift_ms; Hamming window, then
  pre-emphasis (x[t] - a x[t-1] of the windowed frame); the fft_size-point
  power spectrum (torch.fft.rfft), floored; the mel filterbank; log; the
  DCT's cepstra 1..n_ceps; CMVN over the valid frames (population std);
  LPC by Levinson-Durbin on the frame's biased autocorrelation, taken in
  the time domain (or the LPC cepstra); deltas; then each speaker's GMM:
  log(sum_k w_k N(x; mu_k, sigma_k)) per frame, the reference's underflow
  floor, averaged over the valid frames.

Products that the card could run on its TF32 tensor cores (the mel
projection, the DCT and the density's [x^2 | x] products) go through
`_mm`. The reference runs them in float32 with torch's TF32 switches off;
`tf32=True` is the control of the benchmark's comparison, the same
arithmetic with TF32 products: each product's operands rounded to TF32's
10-bit mantissa (what the tensor cores do with them; a product of two
such values is exact in float32), the sums in float32. The rounding is
explicit, on the card as on the CPU: left to choose, cuBLAS takes TF32
kernels for some shapes and not for others.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import operators

# the reference's 1e-100 power floor lies below float32's range; 1e-35 is
# the least floor float32 holds without flushing to zero
F32_FLOOR = 1e-35
# log-space form of the reference's linear 1e-15 floor, which engages only
# where sum_k w_k N(x) underflows double precision (gmm.cc:482-492)
UNDERFLOW_LOG = -745.0
MIN_PROB_LOG = math.log(1e-15)
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@contextlib.contextmanager
def no_tf32():
    """Torch's TF32 switches for CUDA matmuls and convolutions off inside
    the block, and restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def masked_cmvn(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean and population-std normalization of [b, T, n] over each row's
    valid frames; a row with one valid frame or none is left as it is."""
    m = mask[..., None].to(x.dtype)
    count = m.sum(dim=1, keepdim=True)
    safe = count.clamp_min(1.0)
    mu = (x * m).sum(dim=1, keepdim=True) / safe
    var = ((x - mu) ** 2 * m).sum(dim=1, keepdim=True) / safe
    return torch.where(count > 1, (x - mu) / torch.sqrt(var), x)


def levinson(r: torch.Tensor) -> torch.Tensor:
    """Levinson-Durbin on [..., p+1] autocorrelations -> [..., p+1]
    predictor coefficients with a_0 = 1 (talkbox's lpc)."""
    p = r.shape[-1] - 1
    a = [torch.ones_like(r[..., 0])]
    e = r[..., 0]
    for i in range(1, p + 1):
        acc = r[..., i]
        for j in range(1, i):
            acc = acc + a[j] * r[..., i - j]
        k = -acc / e
        a = [a[0]] + [a[j] + k * a[i - j] for j in range(1, i)] + [k]
        e = e * (1.0 - k * k)
    return torch.stack(a, dim=-1)


def lpc_cepstra(a: torch.Tensor, n_lpcc: int) -> torch.Tensor:
    """LPC cepstra of [..., p+1] coefficients (src/feature/LPC.py:27-38):
    c_0 = a_0, c_n = (a_n if n < p) + sum_{l < min(n, p)} a_l c_{n-l-1}
    (n - l)/(n + 1); returns -c_1..c_{n_lpcc-1}."""
    p = a.shape[-1] - 1
    c = [a[..., 0]]
    for n in range(1, n_lpcc):
        term = sum(a[..., l] * c[n - l - 1] * ((n - l) / (n + 1))
                   for l in range(min(n, p)))
        c.append(a[..., n] + term if n < p else term)
    return -torch.stack(c[1:], dim=-1)


def lpc_columns(x: torch.Tensor, order: int, n_lpcc: int) -> torch.Tensor:
    """The LPC columns of windowed, pre-emphasized frames [..., flen]: the
    biased autocorrelation r_j = sum_t x_t x_{t+j} / flen, Levinson, then
    a_1..a_p with non-finite values zeroed (LPC.py:56), or the LPC cepstra
    with non-finite values zeroed (a silent frame's: 0)."""
    flen = x.shape[-1]
    r = torch.stack([(x[..., :flen - j] * x[..., j:]).sum(-1)
                     for j in range(order + 1)], dim=-1) / flen
    if n_lpcc > 0:
        r = torch.where(r[..., :1] < torch.finfo(r.dtype).tiny,
                        torch.zeros_like(r), r)
        return torch.nan_to_num(lpc_cepstra(levinson(r), n_lpcc), nan=0.0,
                                posinf=0.0, neginf=0.0)
    a = levinson(r)[..., 1:]
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def deltas(feat: torch.Tensor, mask: torch.Tensor, nd: int):
    """The reference's diff_feature rows (src/feature/utils.py:24-31): nd
    frames consumed from the front, columns [x, dx(, ddx)]."""
    if nd == 0:
        return feat, mask
    d1 = feat[:, 1:] - feat[:, :-1]
    if nd == 1:
        return torch.cat([feat[:, 1:], d1], dim=-1), mask[:, 1:]
    if nd == 2:
        d2 = d1[:, 1:] - d1[:, :-1]
        return (torch.cat([feat[:, 2:], d1[:, 1:], d2], dim=-1),
                mask[:, 2:])
    raise ValueError(f"n_deltas {nd}: 0, 1 or 2")


class Frontend:
    """The frontend of one sample rate and feature configuration (a
    configuration file's `features` group) on one device, float32."""

    def __init__(self, fs: int, features: dict, device):
        mf, lp = features["mfcc"], features["lpc"]
        self.flen, self.fshift = operators.frame_geometry(
            fs, mf["win_length_ms"], mf["win_shift_ms"])
        self.use_lpc = features.get("use_lpc", True)
        if self.use_lpc and (
                operators.frame_geometry(fs, lp["win_length_ms"],
                                         lp["win_shift_ms"])
                != (self.flen, self.fshift)
                or lp["pre_emph"] != mf["pre_emph"]):
            raise ValueError("MFCC and LPC share frames and pre-emphasis "
                             "(src/feature/__init__.py:25-30)")
        self.n_fft = mf["fft_size"]
        if self.flen > self.n_fft:
            raise ValueError(f"frames of {self.flen} samples exceed the "
                             f"{self.n_fft}-point FFT")
        self.pre_emph = mf["pre_emph"]
        self.preemph_first = mf.get("preemph_first", False)
        self.floor = max(mf.get("power_floor", 1e-100), F32_FLOOR)
        self.cmvn = mf.get("cmvn", True)
        self.order, self.n_lpcc = lp["n_lpc"], lp.get("n_lpcc", 0)
        self.n_deltas = features.get("n_deltas", 0)
        f32 = dict(dtype=torch.float32, device=device)
        self.window = torch.as_tensor(operators.hamming(self.flen), **f32)
        self.mel_t = torch.as_tensor(operators.mel_bank(fs, mf).T, **f32)
        self.dct_t = torch.as_tensor(
            operators.dct_matrix(mf["n_filters"])[1:mf["n_ceps"] + 1].T,
            **f32)

    def n_frames(self, lengths: torch.Tensor) -> torch.Tensor:
        """Frames wholly inside each signal."""
        n = torch.div(lengths - self.flen, self.fshift,
                      rounding_mode="floor") + 1
        return torch.where(lengths >= self.flen, n, torch.zeros_like(n))

    def __call__(self, signals: torch.Tensor, lengths: torch.Tensor,
                 tf32: bool = False):
        """[b, L] zero-padded signals, [b] lengths -> ([b, T', d] features,
        [b, T'] valid-frame mask), zeros past each row's valid frames."""
        frames = signals.to(torch.float32).unfold(-1, self.flen, self.fshift)
        T, a = frames.shape[1], self.pre_emph
        if self.preemph_first:
            x = torch.cat([frames[..., :1] * (1.0 - a),
                           frames[..., 1:] - a * frames[..., :-1]],
                          dim=-1) * self.window
        else:
            y = frames * self.window
            x = torch.cat([y[..., :1], y[..., 1:] - a * y[..., :-1]], dim=-1)
        spec = torch.fft.rfft(x, n=self.n_fft)
        power = (spec.real ** 2 + spec.imag ** 2).clamp_min(self.floor)
        del spec
        mel = _mm(power, self.mel_t, tf32).clamp_min(self.floor)
        del power
        ceps = _mm(torch.log(mel), self.dct_t, tf32)
        mask = (torch.arange(T, device=signals.device) * self.fshift
                + self.flen <= lengths[:, None])
        if self.cmvn:
            ceps = masked_cmvn(ceps, mask)
        cols = [ceps]
        if self.use_lpc:
            cols.append(lpc_columns(x, self.order, self.n_lpcc))
        feat, mask = deltas(torch.cat(cols, dim=-1), mask, self.n_deltas)
        return torch.where(mask[..., None], feat, torch.zeros_like(feat)), mask


class Bank:
    """A bank of S diagonal GMMs of K components from its raw parameters
    (weights [S, K], means and sigmas [S, K, d]), float32 on one device:
    log N(x; mu, sigma) + log w = x^2 . A + x . B + c with A = -1/(2
    sigma^2), B = mu/sigma^2, c = -sum mu^2/(2 sigma^2) - sum log sigma -
    d log sqrt(2 pi) + log w."""

    def __init__(self, weights, means, sigmas, device):
        f32 = dict(dtype=torch.float32, device=device)
        w, mu, sig = (torch.as_tensor(np.asarray(v), **f32)
                      for v in (weights, means, sigmas))
        self.S, self.K, self.d = mu.shape
        inv = 1.0 / (sig * sig)
        self.A = (-0.5 * inv).reshape(self.S * self.K, self.d).T.contiguous()
        self.B = (mu * inv).reshape(self.S * self.K, self.d).T.contiguous()
        self.c = (-0.5 * (mu * mu * inv).sum(-1) - torch.log(sig).sum(-1)
                  - self.d * LOG_SQRT_2PI + torch.log(w)).reshape(-1)

    def __call__(self, feat: torch.Tensor, mask: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
        """[b, T, d] features, [b, T] mask -> [b, S] per-frame average
        log-likelihoods over the valid frames (0 without one)."""
        b, T, d = feat.shape
        X = feat.reshape(b * T, d)
        logp = _mm(X * X, self.A, tf32) + _mm(X, self.B, tf32) + self.c
        lse = torch.logsumexp(logp.view(b * T, self.S, self.K), dim=-1)
        lse = torch.where(lse > UNDERFLOW_LOG, lse,
                          torch.full_like(lse, MIN_PROB_LOG))
        m = mask.to(torch.float32)
        sums = (lse.view(b, T, self.S) * m[..., None]).sum(dim=1)
        return sums / m.sum(dim=1).clamp_min(1.0)[:, None]


def scores(signals: torch.Tensor, lengths: torch.Tensor, frontend: Frontend,
           bank: Bank, tf32: bool = False, block: int = 32) -> torch.Tensor:
    """[B, L] zero-padded signals and [B] lengths -> [B, S] float32 scores,
    `block` rows at a time, each block's signals cut to its longest row's
    frames. TF32 products only with `tf32`."""
    out = []
    lengths = lengths.to(torch.int64)
    with no_tf32(), torch.no_grad():
        for i in range(0, signals.shape[0], block):
            lens = lengths[i:i + block]
            T = int(frontend.n_frames(lens).max())
            if T <= frontend.n_deltas:
                out.append(torch.zeros((lens.shape[0], bank.S),
                                       dtype=torch.float32,
                                       device=signals.device))
                continue
            need = (T - 1) * frontend.fshift + frontend.flen
            feat, mask = frontend(signals[i:i + block, :need], lens, tf32)
            out.append(bank(feat, mask, tf32))
    return torch.cat(out)
