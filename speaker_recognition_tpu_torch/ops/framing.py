"""Signal framing (src/feature/MFCC.py:57-60) as a strided view, and the
window + pre-emphasis of the full-spectrum frontend (MFCC.py:61-64)."""

from __future__ import annotations

import torch

from . import frontend as operators


def frame_signal(signal: torch.Tensor, frame_len: int,
                 frame_shift: int) -> torch.Tensor:
    """[..., L] -> [..., T, frame_len], T = (L - frame_len)//frame_shift + 1.

    Frame f covers samples [f*shift, f*shift + frame_len); the result is a
    view of `signal`, no copy."""
    L = signal.shape[-1]
    if L < frame_len:
        raise ValueError(f"signal too short to frame: {L} < {frame_len}")
    return signal.unfold(-1, frame_len, frame_shift)


def window_preemph(frames: torch.Tensor, frame_len: int, pre_emph: float,
                   preemph_first: bool = False) -> torch.Tensor:
    """Window then pre-emphasize a batch of frames [..., frame_len].

    The reference windows first, then pre-emphasizes the windowed frame
    (MFCC.py:61-64); numpy's in-place `frame[1:] -= frame[:-1]*c` reads the
    original values, so this is a non-recursive first difference.
    `preemph_first=True` is the bob.ap.Ceps order: pre-emphasize the raw
    frame (first sample scaled by 1 - a), then window."""
    w = torch.as_tensor(operators.hamming(frame_len), dtype=frames.dtype,
                        device=frames.device)
    if preemph_first:
        pf = torch.cat([frames[..., :1] * (1.0 - pre_emph),
                        frames[..., 1:] - pre_emph * frames[..., :-1]],
                       dim=-1)
        return pf * w
    wf = frames * w
    return torch.cat([wf[..., :1], wf[..., 1:] - pre_emph * wf[..., :-1]],
                     dim=-1)


def frame_validity_mask(lengths: torch.Tensor, n_frames: int,
                        frame_len: int, frame_shift: int) -> torch.Tensor:
    """[...] lengths -> [..., n_frames] bool; frame f is valid iff its whole
    window lies inside the unpadded signal."""
    ends = (torch.arange(n_frames, device=lengths.device) * frame_shift
            + frame_len)
    return lengths[..., None] >= ends
