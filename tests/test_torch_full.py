"""speaker_recognition_tpu_torch's full-spectrum and LPCC routes against the
JAX package: extract_batch against the JAX XLA extractor at 44.1 and 48 kHz,
fft_size < 2*frame_len, SRTPU_FRONTEND=full, bob's config and LPC cepstra;
the float64 oracle; the frontend factory's cache; the session API, the
open set and the CLI at 44.1/48 kHz; and the JAX-enrolled 48 kHz fixture."""

import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import oracles  # noqa: E402
import scipy.io.wavfile as wavfile  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.api.interface import ModelInterface as JModel  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu_torch import cli  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.api.interface import ModelInterface  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.tools import ubm as tubm  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Scores against the JAX package's on the CPU: the 48 kHz fixture agrees
# to ~2e-6 relative; 1e-3 is the on-card bound of chip_smoke.py.
SCORE_RTOL = 1e-3


def _signals(lengths, L, seed, scale=3000.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


def small_config(**features):
    return tcfg.PipelineConfig(
        features=tcfg.FeatureConfig(**features),
        gmm=tcfg.GmmConfig(n_mixtures=4, n_iterations=50))


CASES = {  # id: (fs, SRTPU_FRONTEND, FeatureConfig of a config module)
    "48k": (48000, "packed", lambda c: c.FeatureConfig()),
    "44k": (44100, "packed", lambda c: c.FeatureConfig()),
    "8k_fft256": (8000, "packed", lambda c: c.FeatureConfig(
        mfcc=c.MfccConfig(fft_size=256))),
    "8k_env_full": (8000, "full", lambda c: c.FeatureConfig()),
    "bob_48k": (48000, "packed", lambda c: c.FeatureConfig(
        mfcc=c.bob_mfcc_config())),
    "lpcc_packed_8k": (8000, "packed", lambda c: c.FeatureConfig(
        lpc=c.LpcConfig(n_lpcc=16))),
    "lpcc_full_48k": (48000, "packed", lambda c: c.FeatureConfig(
        lpc=c.LpcConfig(n_lpcc=16))),
    "deltas_full_44k": (44100, "packed", lambda c: c.FeatureConfig(
        n_deltas=2)),
    "mfcc_only_48k": (48000, "packed", lambda c: c.FeatureConfig(
        use_lpc=False, n_deltas=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_extract_batch_matches_jax(case, monkeypatch):
    """The port's extract_batch vs the JAX XLA extractor (f32), ragged
    lengths with an empty utterance, under the same SRTPU_FRONTEND."""
    fs, mode, cfg_of = CASES[case]
    monkeypatch.setenv("SRTPU_FRONTEND", mode)
    L = 8192 if fs == 8000 else 45056  # at most 1 s
    sig, lens = _signals([L, int(0.6 * L), L // 5, 0], L, seed=5)
    want, wmask = jext._feature_fn(fs, cfg_of(jcfg), L, "float32", "off",
                                   "f32", mode, "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, cfg_of(tcfg))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert np.isfinite(got.numpy()).all()
    # as tests/test_torch_frontend.py: two f32 frontends of different
    # summation order; the LPC cepstra of white noise reach O(1e3), and
    # agree to ~5e-5 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)


def test_routes_follow_the_jax_rule(monkeypatch):
    """Packed iff SRTPU_FRONTEND is packed and fft_size >= 2*frame_len
    (speaker_recognition_tpu/features/extract.py:211)."""
    cfg = tcfg.FeatureConfig()
    assert isinstance(text.frontend(32000, cfg, "cpu"), text.PackedFrontend)
    for fs in (44100, 48000):
        fe = text.frontend(fs, cfg, "cpu")
        assert isinstance(fe, text.FullFrontend)
        # 1025 bins, padded to 1028 with zero mel rows
        assert fe.C.shape == (fe.frame_len, 1028)
        assert (fe.mel[1025:] == 0).all() and (fe.acorr[1025:] == 0).all()
    assert (text.frontend(44100, cfg, "cpu").frame_len,
            text.frontend(44100, cfg, "cpu").frame_shift) == (1411, 705)
    with pytest.raises(ValueError, match="fft_size"):
        text.PackedFrontend(48000, cfg)
    monkeypatch.setenv("SRTPU_FRONTEND", "spectral")
    with pytest.raises(ValueError, match="SRTPU_FRONTEND"):
        text.frontend(8000, cfg, "cpu")


def test_frontend_cache_follows_the_mode(monkeypatch):
    """The factory is cached on (fs, cfg, device, mode): switching
    SRTPU_FRONTEND after a packed call gives the full route's features."""
    L = 8192
    sig, lens = _signals([L, 6000], L, seed=9)
    args = (torch.from_numpy(sig), torch.from_numpy(lens), 8000)
    monkeypatch.setenv("SRTPU_FRONTEND", "packed")
    packed, _ = text.extract_batch(*args)
    monkeypatch.setenv("SRTPU_FRONTEND", "full")
    full, _ = text.extract_batch(*args)
    assert isinstance(text.frontend(8000, tcfg.FeatureConfig(), "cpu"),
                      text.FullFrontend)
    want, _ = jext._feature_fn(8000, jcfg.FeatureConfig(), L, "float32",
                               "off", "f32", "full", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)
    # the two routes agree to f32 rounding, but not bit for bit
    assert not torch.equal(packed, full)
    monkeypatch.setenv("SRTPU_FRONTEND", "packed")
    assert isinstance(text.frontend(8000, tcfg.FeatureConfig(), "cpu"),
                      text.PackedFrontend)


@pytest.mark.parametrize("fs,cfg", [
    (8000, tcfg.FeatureConfig(lpc=tcfg.LpcConfig(n_lpcc=16))),
    (48000, tcfg.FeatureConfig()),
], ids=["frames_8k_lpcc", "full_48k"])
def test_frame_kernels_get_contiguous_frames(fs, cfg, monkeypatch):
    """A kernel reads frames through a raw pointer: both routes hand it a
    contiguous [n, flen] tensor, also for one utterance, where reshaping
    the framed signal is a strided view (mix_feature's case)."""
    seen = []

    def spy(ref):
        def call(frames, *args):
            seen.append(frames.is_contiguous())
            return ref(frames, *args)
        return call

    from speaker_recognition_tpu_torch.ops import gpu_frontend
    monkeypatch.setattr(gpu_frontend, "packed_from_frames",
                        spy(gpu_frontend.packed_from_frames_reference))
    monkeypatch.setattr(gpu_frontend, "mfcc_from_frames",
                        spy(gpu_frontend.mfcc_from_frames_reference))
    text.mix_feature(fs, synth.synth_utterance("bob", 0.5, 1, fs), cfg)
    assert seen == [True]


def test_48k_mfcc_matches_float64_oracle():
    """CMVN'd MFCC at 48 kHz (flen 1536, 2048-point FFT) against the
    frame-loop float64 oracle of MFCC.py; f32 features of O(1), the bound
    of tests/test_features.py's f32 check."""
    sig = synth.synth_utterance("alice", 0.9, seed=3, fs=48000)
    got = text.mfcc_extract(48000, sig)
    want = oracles.oracle_mfcc(48000, sig)
    assert got.shape == want.shape == ((len(sig) - 1536) // 768 + 1, 13)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_jax_enrolled_48k_session_serves(tmp_path):
    """The JAX-enrolled 48 kHz fixture serves in the port: the JAX
    package's scores and labels, in scores_batch and through the CLI."""
    exp = synth.expected(synth.EXPECTED48)
    utts = synth.fixture_utterances(exp)
    truth = [u["label"] for u in exp["utterances"]]
    m = ModelInterface.load(synth.SESSION48, device="cpu")
    assert m.gmmset.y == exp["speakers"]
    scores, valid = m.scores_batch(exp["fs"], utts)
    assert valid.all()
    np.testing.assert_allclose(scores, np.asarray(exp["scores"]),
                               rtol=SCORE_RTOL)
    assert m.predict_batch(exp["fs"], utts) == truth
    assert m.predict(exp["fs"], utts[1]) == truth[1]
    for i, (label, sig) in enumerate(zip(truth, utts)):
        wavfile.write(str(tmp_path / f"{i:02d}_{label}.wav"), exp["fs"], sig)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["-t", "predict", "-i", f"{tmp_path}/*.wav", "-m",
                  synth.SESSION48, "--device", "cpu"])
    assert [ln.rpartition(" -> ")[2]
            for ln in buf.getvalue().strip().splitlines()] == truth


def test_interface_at_44k_with_deltas():
    """scores_batch validity where frames are not 2*fshift long and deltas
    consume nd*fshift samples; predict, warmup and the too-short rule at
    44.1 kHz."""
    fs = 44100
    m = ModelInterface(small_config(n_deltas=1), device="cpu")
    for i, label in enumerate(synth.SPEAKER_FREQS):
        m.enroll(label, fs, synth.synth_utterance(label, 1.0, 40 + i, fs))
    m.train()
    flen, fshift = 1411, 705
    tests = [synth.synth_utterance(label, 0.8, 50 + i, fs)
             for i, label in enumerate(synth.SPEAKER_FREQS)]
    edge = [tests[0][:flen + fshift - 1], tests[0][:flen + fshift]]
    scores, valid = m.scores_batch(fs, tests + edge)
    assert valid.tolist() == [True, True, True, False, True]
    assert (scores[3] == 0).all() and np.isfinite(scores).all()
    assert m.predict_batch(fs, tests) == list(synth.SPEAKER_FREQS)
    m.warmup(fs)
    assert m.predict(fs, tests[2]) == "carol"
    assert m.predict(fs, tests[2][:5 * flen]) is None


def test_open_set_at_48k(tmp_path, monkeypatch):
    """UBM, MAP enrollment, calibration and open-set decisions at 48 kHz;
    the dumped session decides alike in the JAX package. The longest inputs
    of this file (3 s to enroll, 2 s for the UBM): at 1 s the impostor's
    margin sits within 1e-6 of the calibrated threshold."""
    fs = 48000
    pool = [text.mix_feature(fs, synth.synth_utterance(label, 2.0, 500 + i,
                                                       fs))
            for i, label in enumerate(synth.SPEAKER_FREQS)]
    ubm = tubm.train_ubm(pool, n_mixtures=4, n_iterations=50)
    ubm_file = str(tmp_path / "ubm.gmm")
    with open(ubm_file, "w") as f:
        serialization.dump_reference_gmm(ubm, f)
    monkeypatch.setattr(ModelInterface, "UBM_MODEL_FILE", ubm_file)
    m = ModelInterface(small_config(), device="cpu")
    for i, label in enumerate(["alice", "bob"]):
        m.enroll(label, fs, synth.synth_utterance(label, 3.0, 600 + i, fs))
    m.train()
    genuine = [synth.synth_utterance(label, 1.0, 950 + j, fs)
               for j, label in enumerate(["alice", "bob", "alice", "bob"])]
    imposter = [synth.synth_utterance("carol", 1.0, 960 + j, fs)
                for j in range(4)]
    op = m.calibrate_rejection(fs, genuine, imposter)
    assert op["eer"] == 0.0
    held = [synth.synth_utterance(label, 1.0, 970 + i, fs)
            for i, label in enumerate(["alice", "bob", "carol"])]
    decisions = [m.predict_with_rejection(fs, s) for s in held]
    assert decisions == ["alice", "bob", None]
    path = str(tmp_path / "port48.out")
    m.dump(path)
    jm = JModel.load(path)
    assert dataclasses.asdict(jm.config) == dataclasses.asdict(m.config)
    assert [jm.predict_with_rejection(fs, s) for s in held] == decisions


def test_cli_enroll_predict_48k_imports_no_jax(tmp_path):
    """cli -t enroll then -t predict --device cpu on 48 kHz wavs, in a
    process that never imports jax."""
    code = f"""
import io, os, sys
from contextlib import redirect_stdout
sys.path.insert(0, {REPO!r})
import scipy.io.wavfile as wavfile
import torch
torch.set_num_threads(2)
from speaker_recognition_tpu_torch import cli
from speaker_recognition_tpu_torch.api import interface
from speaker_recognition_tpu_torch.config import GmmConfig, PipelineConfig
from speaker_recognition_tpu_torch.testdata.synth import (SPEAKER_FREQS,
                                                          synth_utterance)
root = {str(tmp_path)!r}
os.makedirs(os.path.join(root, "test"))
for i, label in enumerate(SPEAKER_FREQS):
    os.makedirs(os.path.join(root, label))
    for j in range(2):
        wavfile.write(os.path.join(root, label, f"{{j}}.wav"), 48000,
                      synth_utterance(label, 1.0, 800 + 10 * j + i, 48000))
    wavfile.write(os.path.join(root, "test", f"t_{{label}}.wav"), 48000,
                  synth_utterance(label, 0.8, 900 + i, 48000))
interface.PipelineConfig = lambda: PipelineConfig(
    gmm=GmmConfig(n_mixtures=4, n_iterations=50))
model = os.path.join(root, "model.out")
dirs = " ".join(os.path.join(root, label) for label in SPEAKER_FREQS)
with redirect_stdout(io.StringIO()):
    cli.main(["-t", "enroll", "-i", dirs, "-m", model, "--device", "cpu"])
buf = io.StringIO()
with redirect_stdout(buf):
    cli.main(["-t", "predict", "-i", os.path.join(root, "test", "*.wav"),
              "-m", model, "--device", "cpu"])
assert "jax" not in sys.modules, sorted(k for k in sys.modules if "jax" in k)
print(buf.getvalue().strip())
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        f, _, label = line.partition(" -> ")
        assert label == os.path.basename(f)[2:-4], line
