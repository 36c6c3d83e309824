"""speaker_recognition_tpu_torch's batched predict slice end to end against
the JAX package: the serving program, the session API and the CLI, on the
committed fixture session (enrolled by the JAX CLI)."""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import scipy.io.wavfile as wavfile  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.api import fastpath as jfast  # noqa: E402
from speaker_recognition_tpu.api.interface import ModelInterface as JModel  # noqa: E402
from speaker_recognition_tpu_torch import cli  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath as tfast  # noqa: E402
from speaker_recognition_tpu_torch.api.interface import ModelInterface  # noqa: E402
from speaker_recognition_tpu_torch.models.gmm import GmmBank  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402

FS = 8000
# Scores against the JAX package's on the CPU: two f32 frontends of
# different summation order agree to ~3e-5 relative on the fixture; 1e-3
# (the on-card bound of chip_smoke.py) leaves room for BLAS differences.
SCORE_RTOL = 1e-3


@pytest.fixture(scope="module")
def expected():
    return synth.expected()


@pytest.fixture(scope="module")
def utterances(expected):
    return synth.fixture_utterances(expected)


@pytest.mark.parametrize("n_deltas", [0, 1])
def test_predict_scores_matches_jax_pallas_program(n_deltas):
    """tfast.predict_scores on CPU vs the JAX serving program with both
    Pallas kernels in interpret mode."""
    rng = np.random.RandomState(n_deltas)
    L = 8192
    lengths = np.array([8192, 6000, 2500, 100], np.int32)
    sig = np.zeros((4, L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * 3000).astype(np.float32)
    d = 28 * (1 + n_deltas)
    w = rng.dirichlet(np.ones(8), size=3).astype(np.float32)
    mu = rng.randn(3, 8, d).astype(np.float32)
    sd = (0.5 + rng.rand(3, 8, d)).astype(np.float32)
    fn = jfast.predict_scores_fn(FS, jcfg.FeatureConfig(n_deltas=n_deltas),
                                 L, "pallas", "f32", "pallas_wide",
                                 interpret=True)
    want = np.asarray(fn(jnp.asarray(sig), jnp.asarray(lengths),
                         jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sd)))
    got = tfast.predict_scores(
        torch.from_numpy(sig), torch.from_numpy(lengths),
        GmmBank.from_numpy(w, mu, sd, "cpu"), FS,
        tcfg.FeatureConfig(n_deltas=n_deltas)).numpy()
    assert got.shape == (4, 3)
    # per-frame scores are O(100); the frontends' 2e-5 feature
    # differences move them by ~1e-4 relative
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-3)
    assert (got.argmax(-1)[:3] == want.argmax(-1)[:3]).all()
    assert (got[3] == 0).all() and (want[3] == 0).all()


def test_fixture_labels_and_scores_both_packages(expected, utterances):
    truth = [u["label"] for u in expected["utterances"]]
    want = np.asarray(expected["scores"])
    port = ModelInterface.load(synth.SESSION, device="cpu")
    jax_m = JModel.load(synth.SESSION)
    assert port.gmmset.y == jax_m.gmmset.y == expected["speakers"]
    assert port.predict_batch(FS, utterances) == truth
    assert jax_m.predict_batch(FS, utterances) == truth
    got, valid = port.scores_batch(FS, utterances)
    jgot, _ = jax_m.scores_batch(FS, utterances)
    assert valid.all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL)
    np.testing.assert_allclose(got, jgot, rtol=SCORE_RTOL)


def test_cli_predict(tmp_path, expected, utterances):
    for i, (u, sig) in enumerate(zip(expected["utterances"], utterances)):
        wavfile.write(str(tmp_path / f"{i:02d}_{u['label']}.wav"), FS, sig)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["-t", "predict", "-i", f"{tmp_path}/*.wav",
                  "-m", synth.SESSION, "--device", "cpu"])
    lines = buf.getvalue().strip().split("\n")
    assert len(lines) == len(utterances)
    for line in lines:
        f, _, label = line.partition(" -> ")
        assert os.path.basename(f)[3:-4] == label, line


def test_port_dump_serves_in_jax(tmp_path, utterances):
    port = ModelInterface.load(synth.SESSION, device="cpu")
    path = str(tmp_path / "port.out")
    port.dump(path)
    jax_m = JModel.load(path)
    assert dataclasses.asdict(jax_m.config) == dataclasses.asdict(port.config)
    sub = utterances[:3]
    assert jax_m.predict_batch(FS, sub) == port.predict_batch(FS, sub)
    np.testing.assert_array_equal(np.asarray(jax_m.gmmset.bank.means),
                                  port.gmmset.params.means)


def test_short_and_single_utterances(utterances):
    port = ModelInterface.load(synth.SESSION, device="cpu")
    labels = port.predict_batch(FS, [utterances[0], np.zeros(100, np.int16)])
    assert labels == ["alice", None]
    assert port.predict(FS, utterances[1]) == "bob"
    assert port.predict(FS, np.zeros(1000, np.int16)) is None


def test_interface_preconditions():
    with pytest.raises(RuntimeError, match="train"):
        ModelInterface(device="cpu").scores_batch(FS, [np.zeros(4000)])
    f64 = ModelInterface.load(synth.SESSION, device="cpu")
    f64.config = dataclasses.replace(f64.config, dtype="float64")
    with pytest.raises(NotImplementedError, match="float32"):
        f64.scores_batch(FS, [np.zeros(4000)])


def test_cuda_device_without_cuda_raises():
    """The default device is CUDA; without a card the load fails instead
    of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ModelInterface.load(synth.SESSION)
