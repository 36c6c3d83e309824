"""Levinson-Durbin recursion for LPC (src/feature/LPC.py:40-57) and the LPC
cepstra (LPC.py:27-38), batched over frames in plain torch: the reference
for the recursion fused into the frontend kernel (csrc/frontend.cu), and
the LPCC route behind the frame-level kernels (csrc/frontend_frames.cu).
The recursions are sequential in the order and vectorized over frames."""

from __future__ import annotations

import numpy as np
import torch


def autocorr_operator(frame_len: int, fft_size: int, order: int):
    """Wiener-Khinchin projection, power spectrum -> biased autocorrelation:
    R [fft_size//2+1, order+1] float64 with r = power @ R,
    r_j = (p_0 + p_{N/2} cos(pi j) + 2 sum_k p_k cos(2 pi j k / N))
    / (N * frame_len), as speaker_recognition_tpu/ops/levinson.py:34-53.
    Exact for lags below fft_size - frame_len + 1 (circular aliasing
    starts there), so for every LPC order at fft_size > frame_len."""
    nb = fft_size // 2 + 1
    k = np.arange(nb, dtype=np.float64)[:, None]
    j = np.arange(order + 1, dtype=np.float64)[None, :]
    R = 2.0 * np.cos(2.0 * np.pi * k * j / fft_size)
    R[0] /= 2.0
    if fft_size % 2 == 0:
        R[-1] /= 2.0
    return R / (fft_size * frame_len)


def levinson(r: torch.Tensor):
    """Solve the Toeplitz normal equations of r [..., p+1].

    Returns (a [..., p+1] with a[..., 0] = 1, e [...] the final prediction
    error). An all-zero frame (r[0] == 0) gives NaN coefficients, as
    talkbox does; the caller zeroes them (LPC.py:56)."""
    p = r.shape[-1] - 1
    a = torch.zeros_like(r)
    a[..., 0] = 1.0
    e = r[..., 0]
    for i in range(1, p + 1):
        # acc = r[i] + sum_{j=1..i-1} a[j] r[i-j]
        acc = r[..., i] + (a[..., 1:i] * r[..., 1:i].flip(-1)).sum(-1)
        k = -acc / e
        a = torch.cat([a[..., :1],
                       a[..., 1:i] + k[..., None] * a[..., 1:i].flip(-1),
                       k[..., None], a[..., i + 1:]], dim=-1)
        e = e * (1.0 - k * k)
    return a, e


def lpcc_from_lpc(a: torch.Tensor, n_lpcc: int) -> torch.Tensor:
    """LPC cepstra from a = [1, a_1..a_p] [..., p+1] -> [..., n_lpcc-1].

    The reference's lpc_to_cc recursion: c[0] = a[0],
    c[n] = (a[n] if n < p else 0) + sum_{l<min(n,p)} a[l] c[n-l-1] (n-l)/(n+1),
    returning -c[1:]."""
    p = a.shape[-1] - 1
    c = [a[..., 0]]
    for n in range(1, n_lpcc):
        m = min(n, p)
        w = torch.tensor([(n - l) / (n + 1) for l in range(m)],
                         dtype=a.dtype, device=a.device)
        prev = torch.stack([c[n - l - 1] for l in range(m)], dim=-1)
        term = (a[..., :m] * prev * w).sum(-1)
        c.append(a[..., n] + term if n < p else term)
    return -torch.stack(c[1:], dim=-1)


def lpc_from_autocorr(r: torch.Tensor) -> torch.Tensor:
    """LPC a[1..p] from the autocorrelation [..., p+1] -> [..., p]."""
    return levinson_unrolled(r, r.shape[-1] - 1)


def levinson_unrolled(r: torch.Tensor, order: int) -> torch.Tensor:
    """Levinson-Durbin with the order-p recursion unrolled in Python.

    r: [..., order+1] -> LPC a[1..p]: [..., order], talkbox semantics.
    Non-finite coefficients (an all-zero frame: e underflows to 0 -> 0/0)
    are zeroed like LPC.py:56."""
    rc = [r[..., j] for j in range(order + 1)]
    e = rc[0]
    a: list = []
    for i in range(1, order + 1):
        acc = rc[i]
        for j in range(1, i):
            acc = acc + a[j - 1] * rc[i - j]
        k = -acc / e
        a = [a[j - 1] + k * a[i - j - 1] for j in range(1, i)] + [k]
        e = e * (1.0 - k * k)
    lpc = torch.stack(a, dim=-1)
    return torch.where(torch.isfinite(lpc), lpc, torch.zeros_like(lpc))
