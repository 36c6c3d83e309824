"""speaker_recognition_tpu_torch's frame-level frontends (ops/gpu_frontend
packed_from_frames / mfcc_from_frames), window + pre-emphasis and the LPC
recursions against the JAX package: the Pallas kernels in interpret mode
and ops/levinson.py, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.ops import framing as jframing  # noqa: E402
from speaker_recognition_tpu.ops import frontend as operators  # noqa: E402
from speaker_recognition_tpu.ops import levinson as jlevinson  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend  # noqa: E402
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    framing, gpu_frontend, levinson)

FLOOR = 1e-35


def _frames(n, flen, seed, scale=1000.0):
    return (np.random.RandomState(seed).randn(n, flen) * scale).astype(
        np.float32)


def _mel_dct(fs, fft, n_mel=50, n_ceps=13):
    return (operators.mel_filterbank(fs, fft, n_mel).T,
            operators.dct_matrix(n_mel)[1:n_ceps + 1].T)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)


def _check_ceps_r(got, want, with_r):
    ceps, r = (t.numpy() for t in got)
    wc, wr = want if with_r else (want, None)
    # two f32 DFT products of different summation order (one long dot here,
    # Pallas' XLA dot there): ~1e-6 relative on the power, which the log
    # and the DCT carry to ~1e-5 absolute on pre-CMVN cepstra of O(10-100)
    np.testing.assert_allclose(ceps, np.asarray(wc), rtol=1e-4, atol=1e-3)
    if with_r:
        # the raw autocorrelation is a sum of f32 power bins: 1e-4 relative
        # of its largest lag-0 value bounds the reordering
        wr = np.asarray(wr)
        np.testing.assert_allclose(r, wr, rtol=1e-4,
                                   atol=1e-4 * np.abs(wr).max())
    else:
        assert r.shape == (ceps.shape[0], 0)


@pytest.mark.parametrize("flen,fft,fs,with_a", [
    (256, 2048, 8000, True),
    (256, 2048, 8000, False),
    (128, 256, 8000, True),
    (320, 2048, 20000, True),
], ids=["fft2048", "fft2048_mfcc_only", "fft256", "flen320"])
def test_packed_from_frames_matches_pallas(flen, fft, fs, with_a):
    """The plain frame-level packed frontend vs
    pallas_frontend.packed_from_frames (interpret)."""
    mel, dct = _mel_dct(fs, fft)
    D, W, A = operators.packed_frontend_operators(
        flen, fft, 0.95, mel, lpc_order=15 if with_a else None)
    frames = _frames(70, flen, seed=1)
    want = pallas_frontend.packed_from_frames(
        jnp.asarray(frames), D, W, dct, FLOOR, A=A if with_a else None,
        interpret=True)
    A_t = _t(A) if with_a else torch.zeros(D.shape[1], 0)
    got = gpu_frontend.packed_from_frames(_t(frames), _t(D), _t(W), _t(dct),
                                          FLOOR, A_t)
    _check_ceps_r(got, want, with_a)


@pytest.mark.parametrize("flen,fft,fs,with_acorr", [
    (256, 2048, 8000, True),
    (256, 2048, 8000, False),
    (256, 256, 8000, True),
    (1536, 2048, 48000, True),
    (1411, 2048, 44100, False),
], ids=["fft2048", "fft2048_mfcc_only", "fft256", "48k", "44k_mfcc_only"])
def test_mfcc_from_frames_matches_pallas(flen, fft, fs, with_acorr):
    """The plain full-spectrum frontend vs pallas_frontend.mfcc_from_frames
    (interpret): per-bin floor, mel floor, the autocorrelation of the same
    power spectrum."""
    mel, dct = _mel_dct(fs, fft)
    C, S = operators.dft_power_projection(flen, fft)
    acorr = jlevinson.autocorr_operator(flen, fft, 15)
    wp = _frames(40, flen, seed=2)
    wp[3] = 0.0  # a silent frame: every bin at the floor
    want = pallas_frontend.mfcc_from_frames(
        jnp.asarray(wp), C, S, mel, dct, FLOOR,
        acorr_t=acorr if with_acorr else None, interpret=True)
    ac_t = _t(acorr) if with_acorr else torch.zeros(C.shape[1], 0)
    got = gpu_frontend.mfcc_from_frames(_t(wp), _t(C), _t(S), _t(mel),
                                        _t(dct), FLOOR, ac_t)
    _check_ceps_r(got, want, with_acorr)


def test_autocorr_operator_matches_jax():
    for flen, fft, order in ((256, 2048, 15), (1536, 2048, 15), (256, 256, 4)):
        np.testing.assert_array_equal(
            levinson.autocorr_operator(flen, fft, order),
            jlevinson.autocorr_operator(flen, fft, order))


# f64: the same arithmetic in another order, 1e-10 relative; f32: 1e-4
# relative (Levinson amplifies rounding by the autocorrelation's
# conditioning; the recursion order is the same in both packages)
DTYPES = [(np.float64, torch.float64, 1e-10), (np.float32, torch.float32,
                                                1e-4)]


@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("preemph_first", [False, True],
                         ids=["window_first", "bob_order"])
def test_window_preemph_matches_jax(np_dt, t_dt, tol, preemph_first):
    frames = np.random.RandomState(3).randn(2, 5, 200).astype(np_dt) * 100
    want = np.asarray(jframing.window_preemph(jnp.asarray(frames), 200,
                                              0.95, preemph_first))
    got = framing.window_preemph(torch.from_numpy(frames), 200, 0.95,
                                 preemph_first)
    assert got.dtype == t_dt
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 100)


def _autocorr(np_dt, n=12, order=15):
    """Autocorrelations of windowed noise and of an all-zero frame."""
    x = np.random.RandomState(4).randn(n, 256) * np.hamming(256)
    x[0] = 0.0
    r = np.stack([np.sum(x[:, :256 - j] * x[:, j:], axis=-1)
                  for j in range(order + 1)], axis=-1) / 256
    return r.astype(np_dt)


@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES, ids=["f64", "f32"])
def test_levinson_matches_jax(np_dt, t_dt, tol):
    r = _autocorr(np_dt)
    wa, we = (np.asarray(v) for v in jlevinson.levinson(jnp.asarray(r)))
    a, e = levinson.levinson(torch.from_numpy(r))
    assert a.dtype == t_dt and a.shape == (12, 16) and e.shape == (12,)
    # the all-zero frame keeps NaN, as talkbox does (LPC.py:56 zeroes it)
    assert torch.isnan(a[0, 1:]).all() and np.isnan(wa[0, 1:]).all()
    np.testing.assert_allclose(a[1:].numpy(), wa[1:], rtol=tol, atol=tol)
    np.testing.assert_allclose(e[1:].numpy(), we[1:], rtol=tol, atol=0)
    assert (a[:, 0] == 1).all()
    # the recursion's LPC equals the unrolled one that K1 fuses
    np.testing.assert_allclose(a[1:, 1:].numpy(),
                               levinson.lpc_from_autocorr(
                                   torch.from_numpy(r[1:])).numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("np_dt,t_dt,tol", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("n_lpcc", [8, 16, 20], ids=["lt_p", "p+1", "gt_p"])
def test_lpcc_from_lpc_matches_jax(np_dt, t_dt, tol, n_lpcc):
    a = np.asarray(jlevinson.levinson(jnp.asarray(_autocorr(np.float64)))[0])
    a = a[1:].astype(np_dt)
    want = np.asarray(jlevinson.lpcc_from_lpc(jnp.asarray(a), n_lpcc))
    got = levinson.lpcc_from_lpc(torch.from_numpy(a), n_lpcc)
    assert got.dtype == t_dt and got.shape == (11, n_lpcc - 1)
    # the recursion's terms grow with the index, so the bound is relative
    # to each row's largest cepstrum
    scale = np.abs(want).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=tol)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _wrapper_args(full):
    mel, dct = _mel_dct(8000, 2048)
    frames = _t(_frames(8, 256, seed=5))
    if full:
        C, S = operators.dft_power_projection(256, 2048)
        ac = jlevinson.autocorr_operator(256, 2048, 15)
        return (frames, _t(C), _t(S), _t(mel), _t(dct), FLOOR, _t(ac))
    D, W, A = operators.packed_frontend_operators(256, 2048, 0.95, mel,
                                                  lpc_order=15)
    return (frames, _t(D), _t(W), _t(dct), FLOOR, _t(A))


@pytest.mark.parametrize("full", [False, True], ids=["packed", "full"])
def test_cuda_request_raises_without_cuda(full):
    """On a CUDA tensor each frame-level wrapper builds and launches its
    kernel or raises; it never runs the plain version and counts nothing."""
    fn = gpu_frontend.mfcc_from_frames if full else \
        gpu_frontend.packed_from_frames
    args = _wrapper_args(full)
    cuda = [a.as_subclass(_CudaTyped) if isinstance(a, torch.Tensor) else a
            for a in args]
    before = (gpu_frontend.FRAMES_LAUNCHES, gpu_frontend.FULL_LAUNCHES,
              gpu_frontend.LAUNCHES)
    with pytest.raises(RuntimeError):
        fn(*cuda)
    assert (gpu_frontend.FRAMES_LAUNCHES, gpu_frontend.FULL_LAUNCHES,
            gpu_frontend.LAUNCHES) == before
    with pytest.raises(ValueError, match="device"):
        fn(args[0].to("meta"), *args[1:])
    # on the CPU the plain version runs and is not counted
    ceps, r = fn(*args)
    assert ceps.shape == (8, 13) and r.shape == (8, 16)
    assert (gpu_frontend.FRAMES_LAUNCHES, gpu_frontend.FULL_LAUNCHES) == \
        before[:2]
