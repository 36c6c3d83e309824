"""The synthetic 3-speaker corpus behind the fixture sessions (numpy only).

Same recipe as tests/test_endtoend.py: each speaker is a stack of three
harmonics with a slow vibrato, amplitude modulation and white noise, at
any sample rate (8 kHz by default). `synth3_session.npz` was enrolled by
the JAX package at 8 kHz, `synth48_session.npz` at 48 kHz (its
full-spectrum frontend); each `*_expected.json` names the sample rate and
the seeds, durations and true labels of the test utterances, and the
scores the JAX package gave them on the CPU.
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
# (seconds, seed base) of each speaker's training and test utterances;
# speaker i's utterance uses seed base + i
TRAIN = [(6.0, 100), (6.0, 110)]
TEST = [(3.0, 200), (2.0, 210), (4.5, 220)]
HERE = os.path.dirname(os.path.abspath(__file__))
SESSION = os.path.join(HERE, "synth3_session.npz")
EXPECTED = os.path.join(HERE, "synth3_expected.json")
FS48 = 48000
TEST48 = [(1.0, 200), (1.0, 210), (1.0, 220)]
SESSION48 = os.path.join(HERE, "synth48_session.npz")
EXPECTED48 = os.path.join(HERE, "synth48_expected.json")


def synth_utterance(label: str, seconds: float, seed: int,
                    fs: int = FS) -> np.ndarray:
    """Speaker-distinctive int16 signal at `fs`: harmonics + AM + noise."""
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    sig = sum(np.sin(2 * np.pi * f * (1 + 0.01 * np.sin(2 * np.pi * 1.7 * t))
                     * t + rng.rand() * 6.28) / (i + 1)
              for i, f in enumerate(SPEAKER_FREQS[label]))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2)
    sig += 0.05 * rng.randn(n)
    return (sig * 6000).astype(np.int16)


def expected(path: str = EXPECTED) -> dict:
    with open(path) as f:
        return json.load(f)


def fixture_utterances(exp: dict | None = None) -> list[np.ndarray]:
    """A fixture's test utterances, in the order of its expected()."""
    exp = exp or expected()
    return [synth_utterance(u["label"], u["seconds"], u["seed"], exp["fs"])
            for u in exp["utterances"]]


def write_training_wavs(root: str, fs: int = FS) -> list[str]:
    """Write each speaker's TRAIN utterances at `fs` as
    <root>/<label>/train<j>.wav; returns the speaker directories in
    SPEAKER_FREQS order."""
    import scipy.io.wavfile as wavfile

    dirs = []
    for i, label in enumerate(SPEAKER_FREQS):
        d = os.path.join(root, label)
        os.makedirs(d, exist_ok=True)
        for j, (sec, base) in enumerate(TRAIN):
            wavfile.write(os.path.join(d, f"train{j}.wav"), fs,
                          synth_utterance(label, sec, base + i, fs))
        dirs.append(d)
    return dirs
