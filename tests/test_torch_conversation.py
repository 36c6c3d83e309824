"""The live operator path of speaker_recognition_tpu_torch against the JAX
package's on the CPU: ModelInterface.init_noise / filter and the session's
VAD state in both directions, ConversationSession on the JAX-calibrated
session (testdata/synth3_conv_*), the web GUI over HTTP, load_batch on the
native and the scipy paths, and the gmm_cli and corpus tools.

The conversation's timeline must be the JAX package's exactly. That holds
while every tick's LTSD scores clear both thresholds and every predicting
tick's best score clears the second by far more than two float32
frontends differ (~1e-4 relative): the margins are asserted on the port's
own numbers, and were recorded from the JAX package's in the fixture."""

import io
import json
import os
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.io.wavfile as wavfile  # noqa: E402

from speaker_recognition_tpu.api.interface import (  # noqa: E402
    ModelInterface as JModel)
from speaker_recognition_tpu.config import (  # noqa: E402
    GmmConfig as JGmmConfig, PipelineConfig as JPipelineConfig)
from speaker_recognition_tpu.gui import server as jgui  # noqa: E402
from speaker_recognition_tpu.tools import corpus as jcorpus  # noqa: E402
from speaker_recognition_tpu.tools import gmm_cli as jgmm_cli  # noqa: E402
from speaker_recognition_tpu.utils import native_io as jio  # noqa: E402
from speaker_recognition_tpu_torch.api.conversation import (  # noqa: E402
    ConversationSession)
from speaker_recognition_tpu_torch.api.interface import (  # noqa: E402
    ModelInterface)
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    GmmConfig, PipelineConfig)
from speaker_recognition_tpu_torch.gui import server as tgui  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.tools import corpus as tcorpus  # noqa: E402
from speaker_recognition_tpu_torch.tools import (  # noqa: E402
    gmm_cli as tgmm_cli)
from speaker_recognition_tpu_torch.utils import native_io as tio  # noqa: E402

FS = synth.FS
STEP = int(ConversationSession.CONV_INTERVAL * FS)
# LTSD scores (dB) of two f32 FFT libraries differ by ~1e-5; the best
# score of a tick (a per-frame average log-likelihood) by ~1e-3
LTSD_MARGIN, SCORE_MARGIN = 1e-2, 0.5


def _feed(conv, stream):
    for i in range(0, len(stream), STEP):
        conv.feed(stream[i:i + STEP])


def _windows(stream):
    seg = int(ConversationSession.CONV_DURATION * FS)
    x = np.asarray(stream, np.float64)
    return [x[max(p - seg, 0):p] for p in range(STEP, len(x) + 1, STEP)]


@pytest.fixture(scope="module")
def conv_model():
    return ModelInterface.load(synth.CONV_SESSION, device="cpu")


def test_conversation_timeline_equals_jax(conv_model):
    """The port's ConversationSession on the JAX-calibrated session and the
    fixture's stream gives the JAX package's timeline and per-tick labels;
    every tick clears the VAD thresholds and every predicting tick the
    second-best speaker by the stated margins."""
    exp = synth.expected(synth.CONV_EXPECTED)
    stream = synth.conversation_stream()
    conv = ConversationSession(conv_model, FS)
    _feed(conv, stream)
    assert [[t, lab] for t, lab in conv.timeline] == exp["timeline"]
    assert conv.result_list == [k["label"] for k in exp["ticks"]]
    assert [lab for _, lab in conv.timeline] == [
        "Nobody", "alice", "bob", "carol", "alice"]
    vad = conv_model.vad
    for window, tick in zip(_windows(stream), exp["ticks"]):
        assert tick["ltsd_margin"] > LTSD_MARGIN
        s = vad.scores(window)
        if len(s):
            assert min(np.abs(s - vad.lambda0).min(),
                       np.abs(s - vad.lambda1).min()) > LTSD_MARGIN
        kept = conv_model.filter(FS, window)
        assert len(kept) == tick["kept"]
        if tick["label"] is not None:
            assert tick["score_margin"] > SCORE_MARGIN
            scores, _ = conv_model.scores_batch(FS, [kept])
            top = np.sort(scores[0])[::-1]
            assert top[0] - top[1] > SCORE_MARGIN


def test_conversation_raises_on_a_programming_error(conv_model):
    """A window the VAD strips too far shows "Nobody"; an error of the
    model raises instead of becoming "Nobody" (the JAX package's
    catch-all, its conversation.py:66, is not copied)."""
    conv = ConversationSession(conv_model, FS)
    assert conv.feed(synth.noise_clip()[:2 * STEP]) == [(0.4, "Nobody")]
    untrained = ModelInterface(device="cpu")
    untrained.vad = conv_model.vad
    conv = ConversationSession(untrained, FS)
    with pytest.raises(RuntimeError, match="train"):
        _feed(conv, synth.conversation_stream())

    class Broken(ModelInterface):
        def predict(self, fs, signal):
            raise TypeError("broken scoring path")

    broken = Broken(device="cpu")
    broken.vad = conv_model.vad
    with pytest.raises(TypeError, match="broken"):
        _feed(ConversationSession(broken, FS), synth.conversation_stream())


def test_init_noise_and_filter_match_jax():
    noise = synth.noise_clip()
    jm, tm = JModel(), ModelInterface(device="cpu")
    jm.init_noise(FS, noise)
    tm.init_noise(FS, noise)
    assert tm.vad.window_size == jm.vad.window_size
    np.testing.assert_allclose(tm.vad.noise_amp, jm.vad.noise_amp,
                               rtol=1e-5)
    assert tm.vad.lambda0 == pytest.approx(jm.vad.lambda0, abs=1e-4)
    for label, clip in synth.enrollment_clips()[:3]:
        np.testing.assert_array_equal(tm.filter(FS, clip),
                                      jm.filter(FS, clip))
    # the keep-fraction rule: a window that is mostly noise comes back
    # empty in both
    mostly_noise = np.concatenate([noise, synth.noisy_utterance(
        "bob", 0.3, 7)])
    assert len(tm.filter(FS, mostly_noise)) == len(
        jm.filter(FS, mostly_noise)) == 0


def test_vad_state_round_trips_with_jax(tmp_path):
    """A session calibrated by either package filters identically in the
    other: the port dumps its VAD state for the JAX package to load, and
    loads the JAX package's."""
    rng = np.random.RandomState(0)
    cfg = dict(n_mixtures=2, n_iterations=3)
    tm = ModelInterface(PipelineConfig(gmm=GmmConfig(**cfg)), device="cpu")
    tm.init_noise(FS, synth.noise_clip())
    for label in ("a", "b"):
        tm.features[label].append(rng.randn(60, 28))
    tm.train()
    path = str(tmp_path / "port.npz")
    tm.dump(path)
    jm = JModel.load(path)
    clip = synth.enrollment_clips()[4][1]
    for k in ("lambda0", "lambda1", "window_size", "order", "fs"):
        assert getattr(jm.vad, k) == getattr(tm.vad, k), k
    np.testing.assert_array_equal(jm.vad.noise_amp, tm.vad.noise_amp)
    np.testing.assert_array_equal(jm.filter(FS, clip), tm.filter(FS, clip))

    back = ModelInterface.load(synth.CONV_SESSION, device="cpu")
    jback = JModel.load(synth.CONV_SESSION)
    for k in ("lambda0", "lambda1", "window_size", "order", "fs"):
        assert getattr(back.vad, k) == getattr(jback.vad, k), k
    np.testing.assert_array_equal(back.filter(FS, clip),
                                  jback.filter(FS, clip))
    # and the port writes back what it read
    path2 = str(tmp_path / "again.npz")
    back.dump(path2)
    again = JModel.load(path2)
    np.testing.assert_array_equal(again.vad.noise_amp, jback.vad.noise_amp)
    assert again.vad.lambda1 == jback.vad.lambda1


# -- the web GUI over HTTP -------------------------------------------------

def _wav(sig):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(np.asarray(sig, np.int16).tobytes())
    return buf.getvalue()


def _call(base, path, body=None):
    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def servers():
    """(port base URL, JAX base URL): each server with a GMM-4 session of
    its package, on an ephemeral port."""
    out = []
    for app in (tgui.GuiApp(model=ModelInterface(PipelineConfig(
                    gmm=GmmConfig(n_mixtures=4, n_iterations=30)),
                    device="cpu"), device="cpu"),
                jgui.GuiApp(model=JModel(JPipelineConfig(
                    gmm=JGmmConfig(n_mixtures=4, n_iterations=30))))):
        mod = tgui if isinstance(app, tgui.GuiApp) else jgui
        srv, _ = mod.make_server(port=0, app=app)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append((srv, f"http://127.0.0.1:{srv.server_address[1]}"))
    yield out[0][1], out[1][1]
    for srv, _ in out:
        srv.shutdown()
        srv.server_close()


def _both(servers, path, body=None):
    port, jax_ = (_call(base, path, body) for base in servers)
    assert port == jax_, (path, port, jax_)
    return port


def test_gui_serves_the_jax_json(servers, tmp_path):
    """The same requests give the same status codes and JSON from the
    port's server and the JAX package's: noise, filtered enrollment,
    training, filtered predictions, a loaded session, a conversation,
    users, errors."""
    code, st = _both(servers, "/api/status")
    assert code == 200 and st["speakers"] == [] and not st["trained"]
    assert _both(servers, "/api/predict", _wav(synth.noise_clip()))[0] == 400
    assert _both(servers, "/api/noise", _wav(synth.noise_clip()))[1] == {
        "seconds": synth.NOISE_SECONDS}
    assert _both(servers, "/api/enroll?name=", _wav(synth.noise_clip()))[
        0] == 400
    for label, clip in synth.enrollment_clips()[:6]:
        code, r = _both(servers, f"/api/enroll?name={label}", _wav(clip))
        assert code == 200 and 0 < r["kept"] < r["original"]
    assert _both(servers, "/api/train", b"")[1] == {
        "speakers": sorted(synth.SPEAKER_FREQS)}
    sec, seed0 = synth.HELDOUT_CONV
    for i, label in enumerate(synth.SPEAKER_FREQS):
        code, r = _both(servers, "/api/predict?filter=1", _wav(
            synth.noisy_utterance(label, sec, seed0 + i)))
        assert r == {"label": label}
    code, st = _both(servers, "/api/load", json.dumps(
        {"path": synth.CONV_SESSION}).encode())
    assert st["trained"] and st["noise_initialized"]
    _both(servers, "/api/conv/start?fs=8000", b"")
    stream = synth.conversation_stream()[:int(4.5 * FS)]
    for i in range(0, len(stream), STEP):
        _both(servers, "/api/conv/feed", stream[i:i + STEP].astype(
            "<i2").tobytes())
    code, tl = _both(servers, "/api/conv/timeline")
    exp = synth.expected(synth.CONV_EXPECTED)["timeline"]
    assert tl["timeline"] == [{"time": t, "label": lab} for t, lab in exp
                              if t <= 4.5]
    _both(servers, "/api/conv/stop", b"")
    assert _both(servers, "/api/conv/timeline")[1] == {"timeline": []}
    users = {"users": [{"name": "alice", "age": 30, "sex": "F"}]}
    _both(servers, "/api/users", json.dumps(users).encode())
    assert _both(servers, "/api/users")[1] == users
    assert _both(servers, "/api/users", b'{"users": [{}]}')[0] == 400
    assert _both(servers, "/api/nope", b"")[0] == 400
    assert _both(servers, "/api/nope")[0] == 404


def test_gui_defaults_to_the_card():
    import inspect
    assert inspect.signature(tgui.GuiApp).parameters[
        "device"].default == "cuda"
    with pytest.raises(SystemExit):
        tgui.main(["--help"])


# -- load_batch, gmm_cli, corpus -------------------------------------------

def _write_wavs(root):
    paths = []
    for i, (label, clip) in enumerate(synth.enrollment_clips()[:4]):
        p = os.path.join(root, f"{i}_{label}.wav")
        quiet = np.zeros(1200, np.int16)
        wavfile.write(p, FS, np.concatenate([quiet, clip, quiet]))
        paths.append(p)
    bad = os.path.join(root, "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav")
    return paths + [bad]


def _no_library(monkeypatch):
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_lib_tried", True)
    monkeypatch.setattr(jio, "_lib", None)
    monkeypatch.setattr(jio, "_lib_tried", True)


@pytest.mark.parametrize("path", ["native", "scipy"])
@pytest.mark.parametrize("remove_silence", [False, True])
def test_load_batch_matches_jax(path, remove_silence, tmp_path,
                                monkeypatch):
    if path == "scipy":
        _no_library(monkeypatch)
    elif tio.load_library() is None:
        pytest.skip("native/libwavio.so cannot be built here")
    # a file that cannot be decoded and one that does not exist
    paths = _write_wavs(str(tmp_path)) + [str(tmp_path / "missing.wav")]
    kw = {}
    if path == "scipy":  # the length probe reads every file: both raise
        for mod in (tio, jio):
            with pytest.raises(ValueError, match="bad.wav"):
                mod.load_batch(paths)
        kw = {"max_len": 4 * FS}
    got = tio.load_batch(paths, remove_silence=remove_silence, **kw)
    want = jio.load_batch(paths, remove_silence=remove_silence, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lengths = got[1]
    assert (lengths[-2:] == 0).all() and (lengths[:-2] > 0).all()
    if remove_silence:
        assert (lengths[:-2] < 3 * FS + 2400).all()


def test_gmm_cli_with_kmeans_interchanges_with_jax(tmp_path, capsys):
    """gmm_cli train -f 1 (k-means|| seeding) in the port; its model file
    scores alike in both packages' score, and so does the JAX CLI's."""
    rng = np.random.RandomState(2)
    mu = rng.randn(3, 4) * 4
    X = np.concatenate([m + 0.5 * rng.randn(200, 4) for m in mu])
    data = tmp_path / "data.txt"
    np.savetxt(data, X)
    for name, main in (("port", tgmm_cli.main), ("jax", jgmm_cli.main)):
        extra = ["--device", "cpu"] if name == "port" else []
        main(["train", "-i", str(data), "-m", str(tmp_path / name), "-k",
              "3", "-f", "1", "-r", "30"] + extra)
    capsys.readouterr()
    scores = {}
    for name in ("port", "jax"):
        tgmm_cli.main(["score", "-i", str(data), "-m", str(tmp_path / name),
                       "--device", "cpu"])
        jgmm_cli.main(["score", "-i", str(data), "-m", str(tmp_path / name)])
        a, b = (float(v) for v in capsys.readouterr().out.split())
        assert a == pytest.approx(b, rel=1e-5)
        scores[name] = a
    # both find the three blobs: the same fit up to the seeding's draws
    assert scores["port"] == pytest.approx(scores["jax"], rel=1e-2)


def test_corpus_tools_match_jax(tmp_path):
    *paths, bad = _write_wavs(str(tmp_path))
    os.remove(bad)
    pattern = str(tmp_path / "*.wav")
    got = tcorpus.remove_silence_corpus(pattern, str(tmp_path / "port"))
    want = jcorpus.remove_silence_corpus(pattern, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == sorted(
        os.path.basename(p) for p in paths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(wavfile.read(g)[1], wavfile.read(w)[1])
    tcorpus.split_corpus(pattern, str(tmp_path / "split_port"),
                         train_time=1.0, test_time=0.5, nr_test=3)
    jcorpus.split_corpus(pattern, str(tmp_path / "split_jax"),
                         train_time=1.0, test_time=0.5, nr_test=3)
    for root, _, names in os.walk(tmp_path / "split_jax"):
        for n in names:
            j = os.path.join(root, n)
            t = j.replace("split_jax", "split_port")
            np.testing.assert_array_equal(wavfile.read(t)[1],
                                          wavfile.read(j)[1])
