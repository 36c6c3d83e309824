"""The synthetic 3-speaker corpus behind the fixture sessions (numpy only).

Same recipe as tests/test_endtoend.py: each speaker is a stack of three
harmonics with a slow vibrato, amplitude modulation and white noise, at
any sample rate (8 kHz by default). `synth3_session.npz` was enrolled by
the JAX package at 8 kHz, `synth48_session.npz` at 48 kHz (its
full-spectrum frontend); each `*_expected.json` names the sample rate and
the seeds, durations and true labels of the test utterances, and the
scores the JAX package gave them on the CPU.

The live path (noise -> filter -> k-means-seeded enrollment -> streaming
decisions) has its own fixture: room noise (white, NOISE_SIGMA), noisy
enrollment clips, and a conversation stream of speaker turns between
stretches of noise. `synth3_conv_session.npz` is the JAX package's session
calibrated on noise_clip() and enrolled from the VAD-filtered noisy clips
with k-means|| seeding; `synth3_conv_expected.json` holds the timeline its
ConversationSession gave for conversation_stream(), its labels of the
held-out clips and the margins by which every tick's LTSD scores cleared
both thresholds and its winning score cleared the second.
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
# the live-path fixture
NOISE_SIGMA = 100.0
NOISE_SECONDS, NOISE_SEED = 2.0, 500
# 12 s of enrollment a speaker, as CONV_CLIPS clips of ENROLL_CONV[0] s:
# clip j of speaker i has seed ENROLL_CONV[1] + 10 j + i (features are
# normalized per clip, and 3 s clips match the 1.5 s windows better than
# one 12 s clip)
CONV_CLIPS = 4
ENROLL_CONV = (3.0, 300)    # (seconds, seed base) of each enrollment clip
HELDOUT_CONV = (3.0, 400)   # ... of each held-out clip
# turns of CONV_TURN s after CONV_LEAD s of noise, then CONV_TAIL s of
# noise: turn boundaries 0.25 s past a multiple of the 0.4 s tick, so no
# 1.5 s window holds two speakers near half and half
CONV_LEAD, CONV_TURN, CONV_TAIL = 1.05, 2.0, 1.2
CONV_TURNS = ("alice", "bob", "carol", "alice")
CONV_SEED = 600
CONV_SESSION = os.path.join(HERE, "synth3_conv_session.npz")
CONV_EXPECTED = os.path.join(HERE, "synth3_conv_expected.json")


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


def _noise(n: int, seed: int) -> np.ndarray:
    """n samples of white room noise, float64 at int16 scale."""
    return np.random.RandomState(seed).randn(n) * NOISE_SIGMA


def _int16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def noise_clip(fs: int = FS) -> np.ndarray:
    """The operator's recording of the room: int16."""
    return _int16(_noise(int(fs * NOISE_SECONDS), NOISE_SEED))


def noisy_utterance(label: str, seconds: float, seed: int,
                    fs: int = FS) -> np.ndarray:
    """synth_utterance in room noise: int16."""
    sig = synth_utterance(label, seconds, seed, fs).astype(np.float64)
    return _int16(sig + _noise(len(sig), seed + 7919))


def conversation_stream(fs: int = FS) -> np.ndarray:
    """CONV_TURNS of CONV_TURN s each between CONV_LEAD and CONV_TAIL s of
    silence, all in room noise: int16."""
    parts = [np.zeros(int(fs * CONV_LEAD))]
    parts += [synth_utterance(label, CONV_TURN, CONV_SEED + i, fs)
              for i, label in enumerate(CONV_TURNS)]
    parts.append(np.zeros(int(fs * CONV_TAIL)))
    x = np.concatenate(parts).astype(np.float64)
    return _int16(x + _noise(len(x), CONV_SEED + 99))


def enrollment_clips(fs: int = FS) -> list[tuple[str, np.ndarray]]:
    """(label, noisy clip) of every enrollment clip of the live path."""
    sec, base = ENROLL_CONV
    return [(label, noisy_utterance(label, sec, base + 10 * j + i, fs))
            for j in range(CONV_CLIPS)
            for i, label in enumerate(SPEAKER_FREQS)]
