"""speaker_recognition_tpu_torch's enrollment slice end to end, as
tests/test_endtoend.py drives the JAX package: cli enroll -> predict on the
CPU, sessions with a UBM crossing between the packages in both directions
with the same open-set decisions, same-seed byte-identical artifacts, and
an enrollment that never imports jax."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.io.wavfile as wavfile  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.api.interface import ModelInterface as JModel  # noqa: E402
from speaker_recognition_tpu_torch import cli  # noqa: E402
from speaker_recognition_tpu_torch.api.interface import ModelInterface  # noqa: E402
from speaker_recognition_tpu_torch.config import GmmConfig, PipelineConfig  # noqa: E402
from speaker_recognition_tpu_torch.features import extract  # noqa: E402
from speaker_recognition_tpu_torch.testdata.synth import (  # noqa: E402
    FS, SPEAKER_FREQS, synth_utterance)
from speaker_recognition_tpu_torch.tools import ubm as tubm  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Open-set margins from the two packages' f32 scoring agree to ~1e-5
# relative on this corpus (different frontend and summation order).
MARGIN_RTOL = 1e-3


def small_config():
    return PipelineConfig(gmm=GmmConfig(n_mixtures=4, n_iterations=50))


def _enroll(m, seconds=3.0, labels=SPEAKER_FREQS, seed=0):
    for i, label in enumerate(labels):
        m.enroll(label, FS, synth_utterance(label, seconds, seed=seed + i))


@pytest.fixture(scope="module")
def ubm_file(tmp_path_factory):
    """A GMM-4 UBM, trained by the port on all three speakers, in the
    reference text format that both packages' UBM_MODEL_FILE reads."""
    pool = [extract.mix_feature(FS, synth_utterance(label, 4.0, 500 + i),
                                device="cpu")
            for i, label in enumerate(SPEAKER_FREQS)]
    ubm = tubm.train_ubm(pool, n_mixtures=4, n_iterations=50, device="cpu")
    path = str(tmp_path_factory.mktemp("ubm") / "ubm.gmm")
    with open(path, "w") as f:
        serialization.dump_reference_gmm(ubm, f)
    return path


def _dev_sets():
    genuine = [synth_utterance(label, 2.0, 950 + j)
               for j, label in enumerate(["alice", "bob", "alice", "bob"])]
    imposter = [synth_utterance("carol", 2.0, 960 + j) for j in range(4)]
    return genuine, imposter


def _held_out():
    return [synth_utterance(label, 3.0, 970 + i)
            for i, label in enumerate(["alice", "bob", "carol"])]


def test_cli_enroll_then_predict(tmp_path, monkeypatch):
    for i, label in enumerate(SPEAKER_FREQS):
        d = tmp_path / label
        d.mkdir()
        wavfile.write(str(d / "a.wav"), FS,
                      synth_utterance(label, 5.0, seed=800 + i))
    test_dir = tmp_path / "test"
    test_dir.mkdir()
    for i, label in enumerate(SPEAKER_FREQS):
        wavfile.write(str(test_dir / f"t_{label}.wav"), FS,
                      synth_utterance(label, 3.0, seed=900 + i))
    model = str(tmp_path / "model.out")
    monkeypatch.setattr(
        "speaker_recognition_tpu_torch.api.interface.PipelineConfig",
        small_config)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["-t", "enroll", "-i",
                  f"{tmp_path}/alice {tmp_path}/bob {tmp_path}/carol",
                  "-m", model, "--device", "cpu"])
    assert "Total length of training data for 'bob' is 40000" in \
        buf.getvalue()
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["-t", "predict", "-i", f"{test_dir}/*.wav", "-m", model,
                  "--device", "cpu"])
    out = buf.getvalue().strip().split("\n")
    assert len(out) == 3
    for line in out:
        f, _, label = line.partition(" -> ")
        assert label == os.path.basename(f)[2:-4], line
    # the session serves in the JAX package too
    jm = JModel.load(model)
    assert jm.config.gmm.n_mixtures == 4
    sigs = [synth_utterance(label, 3.0, seed=900 + i)
            for i, label in enumerate(SPEAKER_FREQS)]
    assert jm.predict_batch(FS, sigs) == list(SPEAKER_FREQS)


def test_port_session_with_ubm_decides_alike_in_jax(tmp_path, monkeypatch,
                                                    ubm_file):
    monkeypatch.setattr(ModelInterface, "UBM_MODEL_FILE", ubm_file)
    m = ModelInterface(small_config(), device="cpu")
    _enroll(m, 6.0, ["alice", "bob"], seed=600)
    m.train()
    assert m.gmmset.ubm is not None and m.gmmset.gmm_order == 4
    op = m.calibrate_rejection(FS, *_dev_sets())
    assert op["eer"] <= 0.5
    path = str(tmp_path / "port_ubm.out")
    m.dump(path)
    jm = JModel.load(path)
    assert jm.gmmset.reject_threshold == m.gmmset.reject_threshold
    sigs = _held_out()
    serial = [m.predict_with_rejection(FS, s) for s in sigs]
    assert serial == [jm.predict_with_rejection(FS, s) for s in sigs]
    assert serial == ["alice", "bob", None]
    assert m.predict_batch(FS, sigs) == jm.predict_batch(FS, sigs)


def test_jax_session_with_ubm_decides_alike_in_port(tmp_path, monkeypatch,
                                                    ubm_file):
    monkeypatch.setattr(JModel, "UBM_MODEL_FILE", ubm_file)
    jm = JModel(jcfg.PipelineConfig(gmm=jcfg.GmmConfig(n_mixtures=4,
                                                       n_iterations=50)))
    for i, label in enumerate(["alice", "bob"]):
        jm.enroll(label, FS, synth_utterance(label, 6.0, seed=600 + i))
    jm.train()
    jm.calibrate_rejection(FS, *_dev_sets())
    path = str(tmp_path / "jax_ubm.out")
    jm.dump(path)
    m = ModelInterface.load(path, device="cpu")
    sigs = _held_out()
    assert [m.predict_with_rejection(FS, s) for s in sigs] == \
        [jm.predict_with_rejection(FS, s) for s in sigs] == \
        ["alice", "bob", None]
    for s in sigs:
        feat = extract.mix_feature(FS, s, device="cpu")
        np.testing.assert_allclose(m.gmmset.rejection_margin(feat),
                                   jm.gmmset.rejection_margin(feat),
                                   rtol=MARGIN_RTOL, atol=1e-5)


def _enroll_and_dump(path, seed=0):
    m = ModelInterface(device="cpu")
    for label in SPEAKER_FREQS:
        for j in range(2):
            m.enroll(label, FS, synth_utterance(label, 3.0, seed=j))
    m.train(seed=seed)
    m.dump(path)
    with open(path, "rb") as f:
        return f.read()


def test_enroll_twice_byte_identical(tmp_path):
    """The README's determinism claim, held by the port as
    tests/test_determinism.py holds the JAX package to it."""
    a = _enroll_and_dump(str(tmp_path / "a.out"))
    assert a == _enroll_and_dump(str(tmp_path / "b.out"))
    assert a != _enroll_and_dump(str(tmp_path / "c.out"), seed=1)


def test_enrollment_imports_no_jax(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
from speaker_recognition_tpu_torch.api.interface import ModelInterface
from speaker_recognition_tpu_torch.config import GmmConfig, PipelineConfig
from speaker_recognition_tpu_torch.testdata.synth import synth_utterance
m = ModelInterface(PipelineConfig(gmm=GmmConfig(n_mixtures=2,
                                                n_iterations=5)), "cpu")
for i, label in enumerate(["alice", "bob"]):
    m.enroll(label, 8000, synth_utterance(label, 1.5, i))
m.train()
m.dump({str(tmp_path / "s.out")!r})
assert m.predict(8000, synth_utterance("bob", 1.5, 1)) == "bob"
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "speaker_recognition_tpu"))
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
