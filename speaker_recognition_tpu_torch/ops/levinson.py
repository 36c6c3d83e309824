"""Levinson-Durbin recursion for LPC (src/feature/LPC.py:40-57), batched
over frames in plain torch: the reference for the recursion fused into the
frontend kernel (csrc/frontend.cu)."""

from __future__ import annotations

import torch


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
