"""Signal framing (src/feature/MFCC.py:57-60) as a strided view."""

from __future__ import annotations

import torch


def frame_signal(signal: torch.Tensor, frame_len: int,
                 frame_shift: int) -> torch.Tensor:
    """[..., L] -> [..., T, frame_len], T = (L - frame_len)//frame_shift + 1.

    Frame f covers samples [f*shift, f*shift + frame_len); the result is a
    view of `signal`, no copy."""
    L = signal.shape[-1]
    if L < frame_len:
        raise ValueError(f"signal too short to frame: {L} < {frame_len}")
    return signal.unfold(-1, frame_len, frame_shift)


def frame_validity_mask(lengths: torch.Tensor, n_frames: int,
                        frame_len: int, frame_shift: int) -> torch.Tensor:
    """[...] lengths -> [..., n_frames] bool; frame f is valid iff its whole
    window lies inside the unpadded signal."""
    ends = (torch.arange(n_frames, device=lengths.device) * frame_shift
            + frame_len)
    return lengths[..., None] >= ends
