"""speaker_recognition_tpu_torch.vad against speaker_recognition_tpu.vad on
the same seeded numpy inputs: energy silence removal bitwise, the LTSD
detector and the spectral gate within float32 tolerances, the intervals
and filtered samples identical on signals whose scores clear both
thresholds by an asserted margin."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu import vad as jvad  # noqa: E402
from speaker_recognition_tpu.vad import energy as jenergy  # noqa: E402
from speaker_recognition_tpu.vad import ltsd as jltsd  # noqa: E402
from speaker_recognition_tpu.vad import noisered as jnr  # noqa: E402
from speaker_recognition_tpu_torch import vad as tvad  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.vad import energy as tenergy  # noqa: E402
from speaker_recognition_tpu_torch.vad import ltsd as tltsd  # noqa: E402
from speaker_recognition_tpu_torch.vad import noisered as tnr  # noqa: E402

FS = synth.FS
WS = int(tltsd.MAGIC_WINDOW_FACTOR * FS)   # 371: an rfft of odd length
# f32 spectra in two FFT libraries: ~4e-7 relative on the profile, ~1e-5
# dB on a score (measured); the intervals need the scores to clear each
# threshold by far more than that (MARGIN, asserted on every signal)
PROFILE_RTOL, SCORE_ATOL, MARGIN = 1e-5, 1e-4, 1e-2
# the spectral gate: f32 STFT, gain and inverse STFT, ~5e-7 of the peak
GATE_RTOL = 1e-5


def _signals():
    """(name, float64 signal): noise alone, a tone burst in noise, and the
    first 5 s of the live-path fixture's conversation stream."""
    rng = np.random.RandomState(3)
    burst = rng.randn(3 * FS) * synth.NOISE_SIGMA
    t = np.arange(FS) / FS
    burst[FS:2 * FS] += 3000 * np.sin(2 * np.pi * 300 * t)
    return [("noise", rng.randn(2 * FS) * synth.NOISE_SIGMA),
            ("burst", burst),
            ("stream", synth.conversation_stream()[:5 * FS].astype(
                np.float64))]


@pytest.mark.parametrize("dtype", ["int16", "uint8", "float64"])
def test_remove_silence_bitwise(dtype):
    """The port's copy of the energy silence remover equals the JAX
    package's, including the unsigned centering asymmetry
    (silence.py:20,48)."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(800) * 5, rng.randn(1600) * 3000,
                        rng.randn(1200) * 5, rng.randn(900) * 2000])
    if dtype == "uint8":
        sig = np.clip(x / 40 + 128, 0, 255).astype(np.uint8)
    elif dtype == "int16":
        sig = x.astype(np.int16)
    else:
        sig = x
    for perc in (0.15, 0.01):
        want = jenergy.remove_silence(FS, sig, perc=perc)
        got = tenergy.remove_silence(FS, sig, perc=perc)
        assert got.dtype == want.dtype
        assert 0 < len(got) < len(sig)
        np.testing.assert_array_equal(got, want)


def test_noise_profile_and_scores_match_jax():
    noise = synth.noise_clip()
    want = jltsd.noise_profile(noise, WS)
    got = tltsd.noise_profile(noise, WS, device="cpu", dtype=torch.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=PROFILE_RTOL)
    for name, sig in _signals():
        s_want = jltsd.ltsd_scores(sig, want, WS)
        s_got = tltsd.ltsd_scores(sig, want, WS, device="cpu",
                                  dtype=torch.float32)
        assert s_got.shape == s_want.shape, name
        np.testing.assert_allclose(s_got, s_want, rtol=0, atol=SCORE_ATOL,
                                   err_msg=name)
        # edge frames (no full +-order context) score 0
        assert (s_got[:5] == 0).all() and (s_got[-5:] == 0).all()


def test_ltsd_filter_intervals_identical():
    """Calibration, intervals and filtered samples equal the JAX
    package's on signals whose scores clear lambda0 and lambda1 by
    MARGIN dB; segment_intervals equals the JAX package's on the same
    scores."""
    noise = synth.noise_clip()
    jv = jltsd.LtsdVad()
    tv = tltsd.LtsdVad(device="cpu")
    jv.init_params_by_noise(FS, noise)
    tv.init_params_by_noise(FS, noise)
    assert tv.window_size == jv.window_size == WS
    assert tv.lambda0 == pytest.approx(jv.lambda0, abs=SCORE_ATOL)
    assert tv.lambda1 == pytest.approx(jv.lambda1, abs=2 * SCORE_ATOL)
    for name, sig in _signals():
        scores = tv.scores(sig)
        margin = min(np.abs(scores - tv.lambda0).min(),
                     np.abs(scores - tv.lambda1).min())
        assert margin > MARGIN, (name, margin)
        assert (tltsd.segment_intervals(scores, tv.lambda0, tv.lambda1)
                == jltsd.segment_intervals(scores, tv.lambda0, tv.lambda1))
        got, got_iv = tv.filter(sig)
        want, want_iv = jv.filter(sig)
        assert got_iv == want_iv, name
        np.testing.assert_array_equal(got, want)
        if name == "noise":
            assert got_iv == []
        else:
            assert got_iv, name


def test_ltsd_frames_past_an_odd_window():
    """With an odd window and a signal a whole number of hops long, the
    last frame reads one sample past the signal: the JAX package's framing
    indexes out of bounds there; the port reads a zero, i.e. it scores the
    signal as the JAX package scores it with one zero appended."""
    hop = WS // 2
    rng = np.random.RandomState(5)
    sig = rng.randn(hop * 40) * 500
    noise_amp = tltsd.noise_profile(synth.noise_clip(), WS, device="cpu")
    with pytest.raises(IndexError):
        jltsd.ltsd_scores(sig, noise_amp, WS)
    got = tltsd.ltsd_scores(sig, noise_amp, WS, device="cpu")
    want = jltsd.ltsd_scores(np.append(sig, 0.0), noise_amp, WS)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("amount", [0.0, 0.21, 1.0])
def test_spectral_gate_matches_jax(amount):
    noise = synth.noise_clip()
    jn = jnr.NoiseReduction()
    tn = tnr.NoiseReduction(device="cpu")
    jn.init_noise(FS, noise)
    tn.init_noise(FS, noise)
    np.testing.assert_allclose(tn.profile, jn.profile, rtol=1e-5)
    sig = _signals()[-1][1]
    peak = np.abs(sig).max()
    want = jnr.spectral_gate(sig, jn.profile, jn.window_size, amount)
    got = tnr.spectral_gate(sig, jn.profile, tn.window_size, amount,
                            device="cpu", dtype=torch.float32)
    assert got.shape == want.shape == sig.shape
    assert np.abs(got - want).max() <= GATE_RTOL * peak
    again = tnr.spectral_gate(sig, jn.profile, tn.window_size, amount,
                              device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(got, again)
    if amount == 0.0:  # a = 0 reconstructs the input
        assert np.abs(got - sig).max() <= GATE_RTOL * peak


def test_spectral_gate_attenuates_noise():
    """Full subtraction lowers the noise-only stretch of the stream far
    more than its speech."""
    tn = tnr.NoiseReduction(amount=1.0, device="cpu")
    tn.init_noise(FS, synth.noise_clip())
    sig = _signals()[-1][1]
    out = tn.filter(FS, sig)
    lead = int(synth.CONV_LEAD * FS)
    noise_gain = np.std(out[:lead - 400]) / np.std(sig[:lead - 400])
    speech_gain = np.std(out[lead + 400:]) / np.std(sig[lead + 400:])
    assert noise_gain < 0.5 < 0.9 < speech_gain


@pytest.mark.parametrize("use_nr", [False, True], ids=["ltsd", "nr_ltsd"])
def test_vad_composition_matches_jax(use_nr):
    noise = synth.noise_clip()
    jv = jvad.VAD(use_noise_reduction=use_nr)
    tv = tvad.VAD(use_noise_reduction=use_nr, device="cpu")
    with pytest.raises(RuntimeError, match="Not Initialized"):
        tv.filter(FS, noise)
    jv.init_noise(FS, noise)
    tv.init_noise(FS, noise)
    sig = _signals()[1][1]
    got, got_iv = tv.filter(FS, sig)
    want, want_iv = jv.filter(FS, sig)
    assert got_iv == want_iv and got_iv
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GATE_RTOL * np.abs(sig).max())
