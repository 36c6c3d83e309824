"""The one traffic generator: a mix file's parameters and a seed -> a pool of
padded signal batches on the device.

A mix file (perfbench/mixes/<name>.json) gives

  batch      utterances a batch;
  in_flight  batches enqueued before the oldest one's labels are awaited
             (a closed loop);
  pool       batches made, at least 3, cycled through by the window;
  amplitude  the standard deviation of the Gaussian samples, at the scale
             of 16-bit PCM (each sample is rounded and clipped to int16);
  lengths    each utterance's length in seconds:
             {"kind": "fixed", "seconds": s}, or
             {"kind": "mix", "seconds": [s1, s2, ...], "shares": [w1,
              w2, ...]}: a batch holds each length s_i in the share
             w_i / sum(w) of its utterances (largest remainders rounded
             up, so that the counts sum to `batch`).

Every seed gives every batch the same set of lengths (so the same work);
the seed draws their order in each batch and the samples. A batch is padded
as the program's own caller pads it (ModelInterface.scores_batch): to its
longest utterance, rounded up to `LENGTH_BUCKET` samples, zeros past each
utterance's length.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the program's padding unit (speaker_recognition_tpu_torch.features.
# extract.LENGTH_BUCKET), so that a batch has the shape its caller gives it
LENGTH_BUCKET = 4096
INT16 = (-32768.0, 32767.0)


@dataclasses.dataclass
class Batch:
    signals: torch.Tensor   # [B, Lp] float32 on the device
    lengths: torch.Tensor   # [B] int32 on the device
    lengths_np: np.ndarray  # [B] int64 on the host
    audio_s: float          # valid audio seconds


def seconds(mix: dict) -> np.ndarray:
    """The lengths of one batch in seconds, in a fixed order."""
    spec, n = mix["lengths"], int(mix["batch"])
    if spec["kind"] == "fixed":
        return np.full(n, float(spec["seconds"]))
    if spec["kind"] == "mix":
        secs = [float(x) for x in spec["seconds"]]
        shares = np.asarray(spec["shares"], dtype=np.float64)
        if len(secs) != len(shares) or not secs or (shares < 0).any():
            raise ValueError("a mix needs one share >= 0 for each length")
        exact = n * shares / shares.sum()
        count = np.floor(exact).astype(np.int64)
        extra = np.argsort(count - exact, kind="stable")[:n - count.sum()]
        count[extra] += 1
        return np.repeat(secs, count)
    raise ValueError(f"unknown length kind {spec['kind']!r}")


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed drawn from (seed, tags): any whole seed, however large."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 128 - 1), *tags])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def make_pool(mix: dict, fs: int, seed: int, device) -> list[Batch]:
    """The mix's pool of batches for `seed`, made on `device`."""
    base = np.round(seconds(mix) * fs).astype(np.int64)
    lp = int(-(-base.max() // LENGTH_BUCKET) * LENGTH_BUCKET)
    pool = []
    for i in range(int(mix["pool"])):
        rng = np.random.default_rng(sub_seed(seed, 1, i))
        lengths = rng.permutation(base)
        gen = torch.Generator(device=device)
        gen.manual_seed(sub_seed(seed, 2, i))
        sig = torch.randn((len(lengths), lp), generator=gen, device=device,
                          dtype=torch.float32)
        sig.mul_(float(mix["amplitude"])).round_().clamp_(*INT16)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=device)
        sig.masked_fill_(torch.arange(lp, device=device)[None, :]
                         >= lens[:, None], 0.0)
        pool.append(Batch(sig, lens, lengths, float(lengths.sum()) / fs))
    return pool
