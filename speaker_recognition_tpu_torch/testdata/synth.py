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


# -- a many-speaker corpus with low-rank identity structure -------------------
#
# After experiments/make_synth_corpus.py --identity-rank 8 --identity-rho
# 0.75 (its UBM-phone voices), self-contained: the phone inventory is drawn
# here (PHONES all-pole phones of four formants each) instead of being
# selected from the reference's UBM file. A voice is a global vocal-tract
# warp, an F0, breathiness and per-phone pole perturbations; a fraction
# IDENTITY_RHO of each phone's perturbation variance comes from a rank
# IDENTITY_RANK subspace shared by every voice of the family (unit-row
# loadings, so the marginal variance is the i.i.d. draw's): the structure
# JFA's eigenvoices model. Each session drifts the warp and the F0 a little,
# and apply_channel puts it through its own linear channel (a copy of
# experiments/jfa_channel.py:apply_channel).

PHONES, PHONE_SEED = 24, 0
IDENTITY_RANK, IDENTITY_RHO, IDENTITY_SEED = 8, 0.75, 777


def phone_inventory(n: int = PHONES, seed: int = PHONE_SEED, fs: int = FS):
    """(weights [n], pole angles [n, 4], pole radii [n, 4]): four formants
    a phone, spread over 250 Hz .. 0.45 fs, bandwidths 60 .. 260 Hz."""
    rng = np.random.RandomState(seed)
    w = rng.dirichlet(np.ones(n) * 2.0)
    f = np.sort(250 + rng.rand(n, 4) * (0.45 * fs - 250), axis=1)
    bw = 60 + rng.rand(n, 4) * 200
    return w, 2 * np.pi * f / fs, np.exp(-np.pi * bw / fs)


def identity_loadings(n: int = PHONES, rank: int = IDENTITY_RANK,
                      seed: int = IDENTITY_SEED):
    """Cross-phone loadings (angle, radius) [n, rank] with unit rows
    (make_synth_corpus.make_identity_loadings)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        L = rng.randn(n, rank)
        out.append(L / np.linalg.norm(L, axis=1, keepdims=True))
    return tuple(out)


def make_voice(rng, phones, identity, speaker_spread: float = 0.03,
               phone_jitter: float = 0.065) -> dict:
    """A voice (make_synth_corpus.make_ubm_speaker): identity = (L_angle,
    L_radius, rho) draws the per-phone perturbations low-rank-correlated."""
    w = phones[0]
    n = len(w)
    f0 = 95 + rng.rand() * 130
    angle_scale = 1.0 + speaker_spread * rng.randn()
    L_a, L_r, rho = identity
    r = L_a.shape[1]
    pa = np.sqrt(rho) * (L_a @ rng.randn(r)) + np.sqrt(1 - rho) * rng.randn(n)
    pr = np.sqrt(rho) * (L_r @ rng.randn(r)) + np.sqrt(1 - rho) * rng.randn(n)
    return {"f0": f0, "angle_scale": angle_scale,
            "phone_angle": 1.0 + phone_jitter * pa,
            "phone_radius": 1.0 + 0.5 * phone_jitter * pr,
            "breath": 0.08 + rng.rand() * 0.12,
            "vibrato": 2 + rng.rand() * 4,
            "phone_w": np.maximum(w * (1 + 0.3 * rng.randn(n)), 1e-4)}


def voices(n: int, seed: int, fs: int = FS) -> list[dict]:
    """n voices of the identity family (rank IDENTITY_RANK, rho
    IDENTITY_RHO), cast from `seed`; every cast shares the phones and the
    loadings, as background and target speakers share anatomy."""
    phones = phone_inventory(fs=fs)
    L_a, L_r = identity_loadings()
    rng = np.random.RandomState(seed)
    return [make_voice(rng, phones, (L_a, L_r, IDENTITY_RHO))
            for _ in range(n)]


def _phone_filter(angles, radii, angle_scale, radius_pow):
    """The all-pole denominator of one warped phone (poles kept inside
    0.97 and below Nyquist)."""
    th = np.clip(angles * angle_scale, 0.02, np.pi - 0.02)
    r = np.minimum(radii ** radius_pow, 0.97)
    poles = np.concatenate([r * np.exp(1j * th), r * np.exp(-1j * th)])
    return np.real(np.poly(poles))


def voice_utterance(voice: dict, seconds: float, seed: int,
                    fs: int = FS, session_spread: float = 0.015,
                    unvoiced_frac: float = 0.25) -> np.ndarray:
    """One session of a voice (make_synth_corpus.synth_ubm, simplified):
    runs of phones, each a pulse train at the voice's F0 (with vibrato,
    jitter, shimmer and breath) or noise through the phone's warped
    all-pole filter, then de-emphasis; int16 at a 12000 peak."""
    import scipy.signal as sig

    w, ang, rad = phone_inventory(fs=fs)
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    out = np.zeros(n)
    pw = voice["phone_w"] / voice["phone_w"].sum()
    warp = voice["angle_scale"] * (1 + session_spread * rng.randn())
    f0_base = voice["f0"] * (1 + session_spread * rng.randn())
    filt = [_phone_filter(ang[k], rad[k], warp * voice["phone_angle"][k],
                          voice["phone_radius"][k]) for k in range(len(w))]
    pos = 0
    while pos < n:
        k = rng.choice(len(pw), p=pw)
        dur = min(int(fs * (0.06 + 0.14 * rng.rand())), n - pos)
        t = np.arange(dur) / fs
        if rng.rand() > unvoiced_frac:
            f0 = f0_base * (1 + 0.03 * np.sin(
                2 * np.pi * voice["vibrato"] * (t + pos / fs))
                + 0.15 * np.repeat(rng.randn(dur // 64 + 1), 64)[:dur])
            phase = np.cumsum(np.maximum(f0, 40.0)) / fs + rng.rand()
            pulses = (np.diff(np.floor(phase), prepend=np.floor(phase[0]))
                      > 0).astype(np.float64)
            npulse = int(pulses.sum())
            pulses[pulses > 0] = np.abs(1.0 + 0.25 * rng.randn(npulse))
            exc = pulses * np.sqrt(fs / f0_base) + voice["breath"] * \
                rng.randn(dur)
        else:
            exc = rng.randn(dur)
        env = np.minimum(1.0, np.minimum(np.arange(dur), dur - np.arange(dur))
                         / (0.02 * fs))
        exc = exc * (0.5 + 0.5 * rng.rand()) * np.clip(env, 0.05, 1.0)
        out[pos:pos + dur] = sig.lfilter([1.0], filt[k], exc)
        pos += dur
    out = sig.lfilter([1.0], [1.0, -0.95], out)
    return (out / (np.abs(out).max() + 1e-9) * 12000).astype(np.int16)


def apply_channel(signal, fs: int, rng, strength_db: float) -> np.ndarray:
    """One session's linear channel (experiments/jfa_channel.py:
    apply_channel): a first-order spectral tilt and two RBJ peaking EQs
    with gains in +-strength_db; strength 0 is the identity."""
    import scipy.signal as sig

    if strength_db <= 0:
        return signal
    out = np.asarray(signal, np.float64)
    c = (rng.rand() * 2 - 1) * min(0.4 * strength_db / 6.0, 0.8)
    out = sig.lfilter([1.0, -c], [1.0], out)
    for _ in range(2):
        f0 = 300.0 + rng.rand() * 3200.0
        q = 1.0 + rng.rand() * 2.0
        gain = (rng.rand() * 2 - 1) * strength_db
        A = 10.0 ** (gain / 40.0)
        w0 = 2 * np.pi * f0 / fs
        alpha = np.sin(w0) / (2 * q)
        b = [1 + alpha * A, -2 * np.cos(w0), 1 - alpha * A]
        a = [1 + alpha / A, -2 * np.cos(w0), 1 - alpha / A]
        out = sig.lfilter(b, a, out)
    return out
