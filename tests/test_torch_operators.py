"""speaker_recognition_tpu_torch keeps its own copies of the JAX package's
numpy modules: the frontend operator builders (ops/frontend.py) and the
wav reader (utils/native_io.read_wav). Each copy must give exactly what
the JAX package's gives."""

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from speaker_recognition_tpu.config import frame_geometry
from speaker_recognition_tpu.ops import frontend as jfrontend
from speaker_recognition_tpu.utils import native_io as jnative_io
from speaker_recognition_tpu_torch.ops import frontend as tfrontend
from speaker_recognition_tpu_torch.testdata import synth
from speaker_recognition_tpu_torch.utils import native_io as tnative_io

RATES = [8000, 16000, 22050, 44100, 48000]
FFT = 2048


def _geometry(fs):
    return frame_geometry(fs, 32.0, 16.0)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("fs", RATES)
def test_builders_equal_jax(fs):
    flen, _ = _geometry(fs)
    for name, args in (
            ("hamming", (flen,)),
            ("mel_filterbank", (fs, FFT, 50)),
            ("mel_filterbank_bounded", (fs, FFT, 55, 0.0, 6000.0)),
            ("mel_filterbank_bounded", (fs, FFT, 40, 100.0, 3000.0, False)),
            ("dct_matrix", (50,)),
            ("dft_power_projection", (flen, FFT)),
            ("windowed_preemph_operator", (flen, 0.95)),
            ("windowed_preemph_operator", (flen, 0.97, True)),
            ("halfspec_to_fullspec", (flen, 2 * flen, FFT))):
        got = getattr(tfrontend, name)(*args)
        want = getattr(jfrontend, name)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            _same(g, w)


@pytest.mark.parametrize("lpc,preemph_first", [(True, False), (False, True),
                                               (True, True)],
                         ids=["lpc", "mfcc_preemph_first", "lpc_preemph_first"])
@pytest.mark.parametrize("fs", RATES)
def test_packed_operators_equal_jax(fs, lpc, preemph_first):
    flen, _ = _geometry(fs)
    mel_t = jfrontend.mel_filterbank(fs, FFT, 50).T
    kw = dict(lpc_order=15 if lpc else None, preemph_first=preemph_first)
    got = tfrontend.packed_frontend_operators(flen, FFT, 0.95, mel_t, **kw)
    want = jfrontend.packed_frontend_operators(flen, FFT, 0.95, mel_t, **kw)
    assert (got[2] is None) == (want[2] is None) == (not lpc)
    for g, w in zip(got, want):
        if w is not None:
            _same(g, w)


@pytest.mark.parametrize("fs", [8000, 48000])
def test_read_wav_equals_jax(tmp_path, fs):
    dirs = synth.write_training_wavs(str(tmp_path), fs)
    paths = [str(p) for d in dirs for p in sorted((tmp_path / d).glob("*.wav"))]
    stereo = str(tmp_path / "stereo.wav")
    sig = synth.synth_utterance("bob", 0.3, 5, fs)
    wavfile.write(stereo, fs, np.stack([sig, sig // 2], axis=1))
    assert len(paths) >= 3
    for path in paths + [stereo]:
        fs_t, x_t = tnative_io.read_wav(path)
        fs_j, x_j = jnative_io.read_wav(path)
        assert fs_t == fs_j == fs
        _same(x_t, x_j)


def test_read_wav_scipy_path_equals_jax(tmp_path, monkeypatch):
    """Without the native library both read through scipy alike, and both
    refuse a file that is no wav."""
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 8000, synth.synth_utterance("alice", 0.4, 2))
    monkeypatch.setattr(tnative_io, "_lib", None)
    monkeypatch.setattr(tnative_io, "_lib_tried", True)
    monkeypatch.setattr(jnative_io, "_lib", None)
    monkeypatch.setattr(jnative_io, "_lib_tried", True)
    fs_t, x_t = tnative_io.read_wav(path)
    fs_j, x_j = jnative_io.read_wav(path)
    assert fs_t == fs_j == 8000
    _same(x_t, x_j)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    for mod in (tnative_io, jnative_io):
        with pytest.raises(ValueError, match="cannot decode"):
            mod.read_wav(str(bad))
