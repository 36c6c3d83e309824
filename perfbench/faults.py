"""Faults planted in the timed path, underneath the harness: each replaces
ops/gpu_gmm.batch_scores, which fastpath.predict_scores calls, by a broken
version for the length of a `with planted(name):` block. The checks' test
(perfbench/tests) and the limits' readings (calibrate.py --faults) run a
whole cell with one planted and see `correct` come out false.

  half_frames  each utterance's mean taken over the first half of its
               valid frames, the rest left out;
  half_batch   the second half of the batch left out, its rows given the
               mean of the first half's;
  answer       one answer altered where it is produced: the first
               utterance's scores shifted by one speaker;
  stale        each call returns the previous call's scores.

A one-card inference cell has no state that a step could leave unchanged
and no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib


def _faults(orig):
    prev = {}

    def half_frames(bank, feats, mask):
        n = mask.sum(dim=1, keepdim=True)
        keep = mask & (mask.cumsum(dim=1) <= (n + 1) // 2)
        return orig(bank, feats, keep.contiguous())

    def half_batch(bank, feats, mask):
        out = orig(bank, feats, mask)
        h = out.shape[0] // 2
        out[h:] = out[:max(h, 1)].mean(dim=0)
        return out

    def answer(bank, feats, mask):
        out = orig(bank, feats, mask)
        out[0] = out[0].roll(1)
        return out

    def stale(bank, feats, mask):
        out = orig(bank, feats, mask)
        last = prev.get("scores")
        prev["scores"] = out
        return last if last is not None and last.shape == out.shape else out

    return {"half_frames": half_frames, "half_batch": half_batch,
            "answer": answer, "stale": stale}


NAMES = ("half_frames", "half_batch", "answer", "stale")


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in the program's scoring call inside the block."""
    from speaker_recognition_tpu_torch.ops import gpu_gmm
    orig = gpu_gmm.batch_scores
    gpu_gmm.batch_scores = _faults(orig)[name]
    try:
        yield
    finally:
        gpu_gmm.batch_scores = orig
