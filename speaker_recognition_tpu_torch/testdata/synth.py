"""The synthetic 3-speaker corpus behind synth3_session.npz (numpy only).

Same recipe as tests/test_endtoend.py: each speaker is a stack of three
harmonics with a slow vibrato, amplitude modulation and white noise.
`synth3_expected.json` names the seeds, durations and true labels of the
test utterances and the scores the JAX package gave them on the CPU.
"""

from __future__ import annotations

import json
import os

import numpy as np

FS = 8000
SPEAKER_FREQS = {
    "alice": [150, 450, 1300],
    "bob": [110, 700, 2100],
    "carol": [220, 900, 3000],
}
HERE = os.path.dirname(os.path.abspath(__file__))
SESSION = os.path.join(HERE, "synth3_session.npz")
EXPECTED = os.path.join(HERE, "synth3_expected.json")


def synth_utterance(label: str, seconds: float, seed: int) -> np.ndarray:
    """Speaker-distinctive int16 signal: harmonics + AM + noise."""
    rng = np.random.RandomState(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    sig = sum(np.sin(2 * np.pi * f * (1 + 0.01 * np.sin(2 * np.pi * 1.7 * t))
                     * t + rng.rand() * 6.28) / (i + 1)
              for i, f in enumerate(SPEAKER_FREQS[label]))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2)
    sig += 0.05 * rng.randn(n)
    return (sig * 6000).astype(np.int16)


def expected() -> dict:
    with open(EXPECTED) as f:
        return json.load(f)


def fixture_utterances(exp: dict | None = None) -> list[np.ndarray]:
    """The fixture's test utterances, in the order of expected()."""
    exp = exp or expected()
    return [synth_utterance(u["label"], u["seconds"], u["seed"])
            for u in exp["utterances"]]
