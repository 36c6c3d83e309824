"""The port's float64 pipeline against the JAX package's float64 path
(tests/conftest.py turns on x64) and the float64 oracles of
tests/oracles.py, with the tolerances the JAX package's own float64 tests
use (tests/test_features.py, tests/test_gmm.py). At float64 every stage
runs its plain torch version on the device the caller names, counted in
features/extract.F64_CALLS and ops/gpu_gmm.F64_CALLS; the kernel wrappers
refuse a float64 CUDA tensor."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))

import oracles  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.api.interface import (  # noqa: E402
    ModelInterface as JaxInterface)
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath  # noqa: E402
from speaker_recognition_tpu_torch.api.interface import (  # noqa: E402
    ModelInterface)
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402,E501
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    framing, gpu_frontend, gpu_gmm, levinson)
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402


def _speech(seconds=1.5, seed=0, fs=8000):
    """tests/test_features.py's kind of input: a voiced-ish signal at int16
    scale."""
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    return (3000 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * rng.randn(n))
            + 300 * rng.randn(n))


@pytest.mark.parametrize("mode", ["packed", "full"])
def test_mix_feature_f64_matches_the_oracles_and_jax(mode, monkeypatch):
    """MFCC and LPC at float64 through mix_feature on both frontends
    against the oracles (tests/test_features.py's 1e-7 / 1e-6) and the JAX
    package's float64 mix_feature (1e-9); counted in F64_CALLS."""
    monkeypatch.setenv("SRTPU_FRONTEND", mode)
    sig = _speech()
    before = text.F64_CALLS
    feat = text.mix_feature(8000, sig, dtype="float64", device="cpu")
    assert feat.dtype == np.float64 and text.F64_CALLS == before + 1
    np.testing.assert_allclose(feat[:, :13], oracles.oracle_mfcc(8000, sig),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(feat[:, 13:], oracles.oracle_lpc(8000, sig),
                               rtol=1e-6, atol=1e-8)
    want = np.asarray(jext.mix_feature(8000, sig, dtype="float64"))
    np.testing.assert_allclose(feat, want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("case", ["lpcc", "deltas", "bob", "48k"])
def test_extract_batch_f64_matches_jax(case):
    """Other configs at float64 through extract_batch, a ragged batch,
    against the JAX package's float64 extractor: LPC cepstra, two deltas,
    bob's bounded mel bank and pre-emphasis order, 48 kHz (the full route
    at the default fft_size)."""
    fs = 48000 if case == "48k" else 8000
    kw = {"lpcc": dict(lpc=("LpcConfig", dict(n_lpcc=16))),
          "deltas": dict(n_deltas=2),
          "bob": dict(mfcc=("bob_mfcc_config", {})),
          "48k": {}}[case]

    def cfg(c):
        return c.FeatureConfig(**{k: (getattr(c, v[0])(**v[1])
                                      if isinstance(v, tuple) else v)
                                  for k, v in kw.items()})
    L = 4096 * (-(-int(fs * 0.6) // 4096))
    rng = np.random.RandomState(3)
    sig = np.zeros((3, L))
    lens = np.array([L, int(0.7 * L), int(0.3 * L)], np.int32)
    for i, n in enumerate(lens):
        sig[i, :n] = _speech(n / fs, seed=i, fs=fs)[:n] + rng.randn(n)
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, cfg(tcfg),
                                   dtype="float64")
    want, wmask = jext.extract_batch(jnp.asarray(sig), jnp.asarray(lens), fs,
                                     cfg(jcfg), dtype="float64")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


def test_levinson_and_framing_at_f64():
    """ops/levinson and ops/framing in float64: the Levinson recursion
    against the oracle (tests/test_features.py's 1e-8), framing exact."""
    rng = np.random.RandomState(2)
    x = rng.randn(400)
    r = np.array([x[: len(x) - k] @ x[k:] for k in range(16)])
    a, e = levinson.levinson(torch.from_numpy(r))
    a_ref, e_ref = oracles.oracle_levinson(r, 15)
    assert a.dtype == torch.float64
    np.testing.assert_allclose(a.numpy(), a_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-8)
    lpc = levinson.lpc_from_autocorr(torch.from_numpy(r[None]))
    np.testing.assert_allclose(lpc[0].numpy(), a_ref[1:], rtol=1e-8,
                               atol=1e-10)
    frames = framing.frame_signal(torch.from_numpy(x[None]), 32, 16)
    assert frames.dtype == torch.float64
    np.testing.assert_array_equal(frames[0, 3].numpy(), x[48:80])


def _bank(S=3, K=4, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S), rng.randn(S, K, d),
            0.5 + rng.rand(S, K, d))


def test_scores_at_f64_match_the_oracle_and_jax():
    """A float64 bank's batched and serial scores against the JAX
    package's float64 scoring and the oracle log-likelihood
    (tests/test_gmm.py's 1e-10), counted in gpu_gmm.F64_CALLS."""
    w, mu, sig = _bank()
    rng = np.random.RandomState(1)
    X = rng.randn(2, 50, 6)
    mask = np.arange(50)[None, :] < np.array([[50], [31]])
    bank = tgmm.GmmBank.from_numpy(w, mu, sig, "cpu", dtype=torch.float64)
    before = gpu_gmm.F64_CALLS
    got = gpu_gmm.batch_scores(bank, torch.from_numpy(X),
                               torch.from_numpy(mask))
    one = gpu_gmm.serial_scores(bank, torch.from_numpy(X[1]),
                                torch.from_numpy(mask[1]))
    assert gpu_gmm.F64_CALLS == before + 2 and got.dtype == torch.float64
    want = np.asarray(jgmm.batch_bank_avg_loglik(
        jgmm.GmmParams(*(jnp.asarray(a) for a in (w, mu, sig))),
        jnp.asarray(X), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=1e-12)
    for s in range(3):
        ll = oracles.oracle_gmm_log_likelihood(X[1, :31], w[s], mu[s],
                                               sig[s])
        np.testing.assert_allclose(got[1, s].item(), np.mean(ll),
                                   rtol=1e-10)


def _session_pair(tmp_path):
    """A float64 session enrolled and trained by the JAX package on the
    synthetic speakers, dumped, and loaded by the port on the CPU."""
    cfg = jcfg.PipelineConfig(dtype="float64")
    j = JaxInterface(cfg)
    for i, label in enumerate(synth.SPEAKER_FREQS):
        for sec, base in synth.TRAIN:
            j.enroll(label, synth.FS, synth.synth_utterance(label, sec,
                                                            base + i))
    j.train()
    path = str(tmp_path / "f64_session.npz")
    j.dump(path)
    return j, ModelInterface.load(path, device="cpu")


def test_session_at_f64_scores_and_decides_as_jax(tmp_path):
    """A float64 session of the JAX package served by the port at float64:
    scores_batch within 1e-9 of the JAX package's, the same labels; the
    open set (a UBM, predict_with_rejection, calibrate_rejection) decided
    alike; only the float64 routes run."""
    j, t = _session_pair(tmp_path)
    utts = synth.fixture_utterances()
    before = (gpu_gmm.F64_CALLS, text.F64_CALLS, gpu_frontend.LAUNCHES,
              gpu_gmm.LAUNCHES, gpu_gmm.SERIAL_LAUNCHES)
    got, valid = t.scores_batch(synth.FS, utts)
    want, wvalid = j.scores_batch(synth.FS, utts)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-9)
    labels = t.predict_batch(synth.FS, utts)
    assert labels == j.predict_batch(synth.FS, utts)
    assert labels == [u["label"] for u in synth.expected()["utterances"]]
    # the open set: the same UBM on both sides
    ubm_feats = [t._feature(synth.FS, u) for u in utts]
    rng = np.random.RandomState(0)
    K, d = t.gmmset.params.weights.shape[-1], ubm_feats[0].shape[1]
    pooled = np.concatenate(ubm_feats)
    ubm = tgmm.GmmParams(np.full(K, 1.0 / K),
                         pooled[rng.choice(len(pooled), K, replace=False)],
                         np.broadcast_to(pooled.std(0), (K, d)).copy())
    t.gmmset.ubm = ubm
    j.gmmset.ubm = jgmm.GmmParams(*(jnp.asarray(a) for a in ubm))
    for u in utts[:3]:
        assert (t.predict_with_rejection(synth.FS, u)
                == j.predict_with_rejection(synth.FS, u))
        ts, tu = t.gmmset.llr_scores(t._feature(synth.FS, u))
        js, ju = j.gmmset.llr_scores(jext.mix_feature(
            synth.FS, u, j.config.features, dtype="float64"))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-9)
        np.testing.assert_allclose(tu, float(ju), rtol=1e-9)
    imp = [synth.voice_utterance(v, 2.0, 9 + i)
           for i, v in enumerate(synth.voices(2, seed=3))]
    tc = t.calibrate_rejection(synth.FS, utts[:4], imp)
    jc = j.calibrate_rejection(synth.FS, utts[:4], imp)
    np.testing.assert_allclose(tc["threshold"], jc["threshold"], rtol=1e-9)
    assert (tc["far"], tc["frr"]) == (jc["far"], jc["frr"])
    after = (gpu_gmm.F64_CALLS, text.F64_CALLS, gpu_frontend.LAUNCHES,
             gpu_gmm.LAUNCHES, gpu_gmm.SERIAL_LAUNCHES)
    assert after[0] > before[0] and after[1] > before[1]
    assert after[2:] == before[2:]


def test_train_at_f64_on_the_cpu_matches_the_oracle_em():
    """ModelInterface.train at float64 (the batched EM in float64): one EM
    iteration from the JAX-free init equals the oracle iteration
    (tests/test_gmm.py's float64 tolerance)."""
    rng = np.random.RandomState(4)
    X = rng.randn(1, 200, 5)
    mask = np.ones((1, 200), bool)
    params0 = tgmm.init_params(torch.from_numpy(X), torch.from_numpy(mask),
                               4, seed=0)
    p = tgmm.GmmParams(*(a.double() for a in params0))
    cfg = tcfg.GmmConfig(n_mixtures=4)
    new = tgmm.m_step(tgmm.sufficient_stats(p, torch.from_numpy(X),
                                            torch.from_numpy(mask)), cfg)
    w, mu, sg = oracles.oracle_gmm_em_iteration(
        X[0], p.weights[0].numpy(), p.means[0].numpy(),
        p.sigmas[0].numpy())[:3]
    for got, want in zip(new, (w, mu, sg)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-9,
                                   atol=1e-12)


def test_predict_scores_f64_plain_on_any_device():
    """fastpath.predict_scores at float64: the plain versions (no kernel
    counter moves), equal to the float32 route's within f32 rounding."""
    fs = synth.FS
    utts = synth.fixture_utterances()[:4]
    L = 4096 * (-(-max(len(u) for u in utts) // 4096))
    sig = np.zeros((4, L))
    for i, u in enumerate(utts):
        sig[i, :len(u)] = u
    lens = torch.tensor([len(u) for u in utts])
    w, mu, sg = _bank(S=2, K=4, d=28, seed=5)
    b64 = tgmm.GmmBank.from_numpy(w, mu, sg, "cpu", dtype=torch.float64)
    b32 = tgmm.GmmBank.from_numpy(w, mu, sg, "cpu")
    before = (gpu_frontend.LAUNCHES, gpu_gmm.LAUNCHES, text.F64_CALLS,
              gpu_gmm.F64_CALLS)
    s64 = fastpath.predict_scores(torch.from_numpy(sig), lens, b64, fs,
                                  tcfg.FeatureConfig())
    after = (gpu_frontend.LAUNCHES, gpu_gmm.LAUNCHES, text.F64_CALLS,
             gpu_gmm.F64_CALLS)
    assert s64.dtype == torch.float64 and after[:2] == before[:2]
    assert after[2:] == (before[2] + 1, before[3] + 1)
    s32 = fastpath.predict_scores(torch.from_numpy(sig).float(), lens, b32,
                                  fs, tcfg.FeatureConfig())
    np.testing.assert_allclose(s64.numpy(), s32.numpy(), rtol=1e-4)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_the_kernel_wrappers_refuse_f64_on_the_card():
    """The float64 route is chosen at the call sites; the kernel wrappers
    themselves take float32 only and refuse a float64 CUDA tensor."""
    fe = text.PackedFrontend(8000, tcfg.FeatureConfig(), "cpu")
    sig = torch.zeros(2, 4096, dtype=torch.float64).as_subclass(_CudaTyped)
    nv = torch.full((2,), 10, dtype=torch.int32).as_subclass(_CudaTyped)
    with pytest.raises(TypeError, match="float32"):
        gpu_frontend.packed_from_signals(sig, nv, fe.D, fe.W, fe.dct, fe.A,
                                         fe.floor, fe.frame_shift, True,
                                         fft=fe.fft)
    bank = tgmm.GmmBank.from_numpy(*_bank(d=28), "cpu")
    feats = torch.zeros(2, 5, 28, dtype=torch.float64).as_subclass(
        _CudaTyped)
    mask = torch.ones(2, 5, dtype=torch.bool).as_subclass(_CudaTyped)
    with pytest.raises(TypeError, match="float32"):
        gpu_gmm.batch_bank_avg_loglik(bank, feats, mask)
    with pytest.raises(TypeError, match="float32"):
        gpu_gmm.bank_avg_loglik(bank, feats[0], mask[0])
