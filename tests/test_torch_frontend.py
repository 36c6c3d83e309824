"""speaker_recognition_tpu_torch frontend (ops/gpu_frontend, features/
extract) against the JAX package: the Pallas signal-level kernel in
interpret mode and the XLA extractor, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend, levinson  # noqa: E402

FS = 8000


def _signals(lengths, L, seed, scale=500.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


def _frontend(fs=FS, **kw):
    return text.PackedFrontend(fs, tcfg.FeatureConfig(**kw), "cpu")


def _n_valid(fe, lengths, L):
    T = tcfg.n_frames(L, fe.frame_len, fe.frame_shift)
    return fe.valid_frames(torch.from_numpy(lengths), T)


@pytest.mark.parametrize("lengths,cmvn", [
    ([7000, 8192, 2000], True),
    ([8192, 300, 0], True),
    ([5000, 8192, 6100], False),
], ids=["ragged", "short_and_empty", "no_cmvn"])
def test_packed_from_signals_matches_pallas(lengths, cmvn):
    """The plain torch frontend vs pallas_frontend.packed_from_signals
    (interpret, n_valid, cmvn, fused Levinson) on the valid frames."""
    L = 8192
    sig, lens = _signals(lengths, L, seed=11)
    fe = _frontend()
    nv = _n_valid(fe, lens, L)
    got = gpu_frontend.packed_from_signals(
        torch.from_numpy(sig), nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
        fe.frame_shift, cmvn).numpy()
    ceps, lpc = pallas_frontend.packed_from_signals(
        jnp.asarray(sig), fe.frame_shift, fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor, fe.A.numpy(), interpret=True,
        n_valid=jnp.asarray(nv.numpy()), cmvn=cmvn, fuse_lpc=True)
    T = L // fe.frame_shift - 1
    m = np.arange(T)[None, :] < nv.numpy()[:, None]
    assert got.shape == (3, T, 28)
    # tolerances of tests/test_pallas_frontend.py:158-161; the cepstra's
    # widened from 1e-5 to 1e-4 because the DFT is summed in another f32
    # order (one 256-long dot here, two 128-long partials there), which
    # leaves up to 2e-5 on CMVN'd values of O(10)
    np.testing.assert_allclose(got[..., :13][m], np.asarray(ceps)[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[..., 13:][m], np.asarray(lpc)[m],
                               rtol=2e-4, atol=2e-4)
    assert (got[~m] == 0).all()


def test_all_zero_utterance_gives_zero_lpc():
    """r = 0 -> Levinson 0/0 -> NaN, zeroed like LPC.py:56 (not NaN)."""
    sig = np.zeros((2, 8192), np.float32)
    sig[1] = np.random.RandomState(0).randn(8192).astype(np.float32)
    feats, mask = text.extract_batch(torch.from_numpy(sig),
                                     torch.tensor([8192, 8192]), FS)
    assert mask.all()
    # only the LPC columns: the MFCC of a silent utterance is constant, and
    # CMVN divides by its zero deviation, as in the JAX package and MFCC.py
    assert torch.isfinite(feats[..., 13:]).all()
    assert torch.isfinite(feats[1]).all()
    assert (feats[0, :, 13:] == 0).all()
    assert (feats[1, :, 13:] != 0).any()
    r = torch.zeros(4, 16)
    assert (levinson.lpc_from_autocorr(r) == 0).all()


def test_masked_frames_are_zero():
    sig, lens = _signals([8192, 3000, 200], 8192, seed=3)
    feats, mask = text.extract_batch(torch.from_numpy(sig),
                                     torch.from_numpy(lens), FS)
    n_valid = mask.sum(-1).tolist()
    assert n_valid == [63, (3000 - 256) // 128 + 1, 0]
    assert (feats[~mask] == 0).all()
    assert (feats[mask] != 0).any(-1).all()


def _jax_cfg(kw):
    k = dict(kw)
    if "mfcc" in k:
        k["mfcc"] = k["mfcc"](jcfg)
    return jcfg.FeatureConfig(**k)


def _torch_cfg(kw):
    k = dict(kw)
    if "mfcc" in k:
        k["mfcc"] = k["mfcc"](tcfg)
    return tcfg.FeatureConfig(**k)


@pytest.mark.parametrize("kw,fs", [
    ({}, 8000),
    ({}, 16000),
    ({"mfcc": lambda c: c.bob_mfcc_config()}, 16000),
    ({"use_lpc": False}, 8000),
    ({"n_deltas": 1}, 8000),
    ({"n_deltas": 2}, 8000),
], ids=["default", "16k", "bob", "mfcc_only", "deltas1", "deltas2"])
def test_extract_batch_matches_jax(kw, fs):
    """The port's extract_batch vs the JAX XLA extractor (f32)."""
    L = 8192
    sig, lens = _signals([L, int(0.6 * L), 900, 0], L, seed=5, scale=3000.0)
    want, wmask = jext._feature_fn(fs, _jax_cfg(kw), L, "float32", "off",
                                   "f32", "packed", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, _torch_cfg(kw))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    # tests/test_pallas_frontend.py:84-85 holds two f32 frontends of
    # different summation order to the same bound
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-2)


def _matches_jax_extractor(fs, cfg_of, mode="packed"):
    """extract_batch vs the JAX XLA extractor under frontend `mode`, with
    the tolerance of test_extract_batch_matches_jax."""
    L = 8192
    sig, lens = _signals([L, 5000, 900], L, seed=7, scale=3000.0)
    want, wmask = jext._feature_fn(fs, cfg_of(jcfg), L, "float32", "off",
                                   "f32", mode, "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, cfg_of(tcfg))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)


@pytest.mark.parametrize("cfg,route", [
    (lambda c: c.FeatureConfig(lpc=c.LpcConfig(n_lpcc=12)), "PackedFrontend"),
    (lambda c: c.FeatureConfig(mfcc=c.MfccConfig(fft_size=256)),
     "FullFrontend"),
], ids=["lpcc", "small_fft"])
def test_unported_configs_raise(cfg, route):
    """The two configs slice 1 refused are served now: LPC cepstra on the
    packed route (frame-level kernel + Levinson + LPCC), fft_size <
    2*frame_len on the full-spectrum route; both held to the JAX
    extractor."""
    assert type(text.frontend(FS, cfg(tcfg), "cpu")).__name__ == route
    _matches_jax_extractor(FS, cfg)


def test_full_frontend_env_raises(monkeypatch):
    """SRTPU_FRONTEND=full, which slice 1 refused, takes the full-spectrum
    route, as in the JAX package, and matches its full extractor."""
    monkeypatch.setenv("SRTPU_FRONTEND", "full")
    assert isinstance(text.frontend(FS, tcfg.FeatureConfig(), "cpu"),
                      text.FullFrontend)
    _matches_jax_extractor(FS, lambda c: c.FeatureConfig(), "full")


def test_float64_features_raise():
    """The float64 parity pipeline has no kernel: it runs the plain
    versions (tests/test_torch_f64.py holds it to the JAX package); a
    dtype other than float32 and float64 raises, naming the two."""
    sig = np.random.RandomState(0).randn(4000) * 1000
    assert text.mix_feature(FS, sig, dtype="float64",
                            device="cpu").dtype == np.float64
    with pytest.raises(ValueError, match="float32 or float64"):
        text.mix_feature(FS, sig, dtype="bfloat16", device="cpu")


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_request_raises_without_cuda():
    """On a CUDA tensor the wrapper builds and launches its kernel or
    raises; it never runs the plain version."""
    fe = _frontend()
    sig, lens = _signals([8192], 8192, seed=1)
    nv = _n_valid(fe, lens, 8192)
    cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    fft = fe.fft._replace(window=cuda(fe.window), mel=cuda(fe.fft_mel),
                          acorr=cuda(fe.fft_acorr))
    args = (cuda(torch.from_numpy(sig)), cuda(nv), cuda(fe.D), cuda(fe.W),
            cuda(fe.dct), cuda(fe.A), fe.floor, fe.frame_shift, True)
    before = gpu_frontend.LAUNCHES
    with pytest.raises(RuntimeError):
        gpu_frontend.packed_from_signals(*args, fft=fft)
    # the kernel runs the FFT route: without its operators it refuses
    with pytest.raises(ValueError, match="fft="):
        gpu_frontend.packed_from_signals(*args)
    assert gpu_frontend.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        gpu_frontend.packed_from_signals(
            torch.from_numpy(sig).to("meta"), nv, fe.D, fe.W, fe.dct, fe.A,
            fe.floor, fe.frame_shift, True)
