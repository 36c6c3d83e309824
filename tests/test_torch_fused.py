"""speaker_recognition_tpu_torch's fused predict monolith (ops/gpu_predict)
against the JAX package's: pallas_predict.fused_bank_predict (K6) and
fused_bank_predict_wide (K7) in interpret mode, on the same numpy inputs
as tests/test_pallas_predict.py; and against the port's own two-kernel
predict (api/fastpath.predict_scores)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.ops import pallas_predict  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath  # noqa: E402
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, frame_geometry, n_frames)
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    PackedFrontend)
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    frontend, gpu_predict)

FS = 8000
# tests/test_pallas_predict.py's tolerance for the fused kernels against
# the unfused program: f32 frontends summed in different orders
RTOL = ATOL = 2e-4


def _operators(fcfg: FeatureConfig, fs: int = FS):
    """The packed operators as tests/test_pallas_predict.py builds them."""
    mf, lp = fcfg.mfcc, fcfg.lpc
    flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    mel_np = frontend.mel_filterbank(fs, mf.fft_size, mf.n_filters).T
    dct_np = frontend.dct_matrix(mf.n_filters)[1: mf.n_ceps + 1].T
    D, W, A = frontend.packed_frontend_operators(
        flen, mf.fft_size, mf.pre_emph, mel_np,
        lpc_order=lp.n_lpc if fcfg.use_lpc else None,
        preemph_first=mf.preemph_first)
    floor = max(mf.power_floor, 1e-35)
    return flen, fshift, D, W, dct_np, A, floor


def _batch(fcfg, B=6, seconds=(0.7, 1.0), seed=0, padded=8192,
           lengths=None):
    """tests/test_pallas_predict.py's batch: white noise at int16 scale,
    zero-padded, with each utterance's valid frame count."""
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = rng.randint(int(seconds[0] * FS), int(seconds[1] * FS),
                              size=B)
    signals = np.zeros((len(lengths), padded), np.float32)
    for i, L in enumerate(lengths):
        signals[i, :L] = (rng.randn(L) * 3000).astype(np.float32)
    mf = fcfg.mfcc
    flen, fshift = frame_geometry(FS, mf.win_length_ms, mf.win_shift_ms)
    n_valid = np.array([n_frames(int(L), flen, fshift) for L in lengths],
                       np.int32)
    return signals, np.asarray(lengths), n_valid


def _bank(S, K, d, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _both(fcfg, bank_np, signals, n_valid, wide=False, **kw):
    """(port, JAX) scores of one batch: the port's wrapper on CPU tensors
    (its plain version) and the JAX kernel in interpret mode."""
    flen, fshift, D, W, dct_np, A, floor = _operators(fcfg)
    jbank = jgmm.GmmParams(*(jnp.asarray(a) for a in bank_np))
    tbank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    if wide:
        want = pallas_predict.fused_bank_predict_wide(
            jnp.asarray(signals), jnp.asarray(n_valid), jbank, fshift, D, W,
            dct_np, floor, A, cmvn=fcfg.mfcc.cmvn, interpret=True,
            utt_tile=2, **kw)
        port = gpu_predict.fused_bank_predict_wide
    else:
        want = pallas_predict.fused_bank_predict(
            jnp.asarray(signals), jnp.asarray(n_valid), jbank, fshift, D, W,
            dct_np, floor, A, cmvn=fcfg.mfcc.cmvn, interpret=True, **kw)
        port = gpu_predict.fused_bank_predict
    got = port(torch.from_numpy(signals), torch.from_numpy(n_valid), tbank,
               fshift, _t(D), _t(W), _t(dct_np), floor,
               None if A is None else _t(A), cmvn=fcfg.mfcc.cmvn, **kw)
    return got.numpy(), np.asarray(want)


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()


@pytest.mark.parametrize("S,K", [(4, 32), (3, 8)])
def test_fused_matches_jax(S, K):
    fcfg = FeatureConfig()
    signals, _, n_valid = _batch(fcfg)
    _assert_close(*_both(fcfg, _bank(S, K, fcfg.dim), signals, n_valid))


def test_fused_mfcc_only_matches_jax():
    fcfg = FeatureConfig(use_lpc=False)
    signals, _, n_valid = _batch(fcfg, B=4)
    _assert_close(*_both(fcfg, _bank(2, 8, fcfg.dim), signals, n_valid))


def test_fused_bf16_matches_jax():
    """bf16 DFT operands, f32 products and sums, on both sides; the
    rounding moves the scores well past RTOL from the f32 ones."""
    fcfg = FeatureConfig()
    signals, _, n_valid = _batch(fcfg, B=4)
    bank = _bank(4, 16, fcfg.dim)
    got, want = _both(fcfg, bank, signals, n_valid, mm_bf16=True)
    _assert_close(got, want)
    f32, _ = _both(fcfg, bank, signals, n_valid)
    assert np.abs(got - f32).max() > 10 * ATOL


@pytest.mark.parametrize("use_lpc", [True, False])
def test_fused_wide_matches_jax(use_lpc):
    fcfg = FeatureConfig(use_lpc=use_lpc)
    signals, _, n_valid = _batch(fcfg, B=4)
    _assert_close(*_both(fcfg, _bank(3, 8, fcfg.dim), signals, n_valid,
                         wide=True))


def test_fused_mixed_lengths_matches_jax():
    """A 0.1 s, a 0.5 s and a 3 s utterance in one padded batch: each is
    normalized and averaged over its own valid frames."""
    fcfg = FeatureConfig()
    signals, _, n_valid = _batch(fcfg, lengths=[800, 4000, 24000],
                                 padded=24576)
    assert n_valid.tolist() == [5, 30, 186]
    _assert_close(*_both(fcfg, _bank(3, 8, fcfg.dim), signals, n_valid))


def test_fused_no_valid_frame_scores_zero():
    """An utterance with n_valid = 0 scores 0 for every speaker, as in the
    JAX kernel; the others are untouched by it."""
    fcfg = FeatureConfig()
    signals, _, n_valid = _batch(fcfg, B=4)
    n_valid[1] = 0
    got, want = _both(fcfg, _bank(3, 8, fcfg.dim), signals, n_valid)
    assert (got[1] == 0).all() and (want[1] == 0).all()
    _assert_close(got, want)


@pytest.mark.parametrize("use_lpc", [True, False])
def test_fused_matches_two_kernel_predict(use_lpc):
    """The plain monolith against the port's serving program (frontend,
    then bank scoring) on the same batch, through PackedFrontend's
    operators: the same arithmetic, so 1e-5."""
    fcfg = FeatureConfig(use_lpc=use_lpc)
    signals, lengths, _ = _batch(fcfg, B=5, seed=3)
    fe = PackedFrontend(FS, fcfg, "cpu")
    bank = tgmm.GmmBank.from_numpy(*_bank(4, 32, fcfg.dim), device="cpu")
    sig, lens = torch.from_numpy(signals), torch.from_numpy(lengths)
    T = n_frames(signals.shape[1], fe.frame_len, fe.frame_shift)
    got = gpu_predict.fused_bank_predict(
        sig, fe.valid_frames(lens, T), bank, fe.frame_shift, fe.D, fe.W,
        fe.dct, fe.floor, fe.A, cmvn=fe.cmvn)
    want = fastpath.predict_scores(sig, lens, bank, FS, fcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_fused_cpu_runs_the_plain_version_uncounted():
    fcfg = FeatureConfig()
    flen, fshift, D, W, dct_np, A, floor = _operators(fcfg)
    signals, _, n_valid = _batch(fcfg, B=2)
    bank = tgmm.GmmBank.from_numpy(*_bank(2, 4, fcfg.dim), device="cpu")
    args = (torch.from_numpy(signals), torch.from_numpy(n_valid), bank,
            fshift, _t(D), _t(W), _t(dct_np), floor, _t(A))
    before = (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES)
    plain = gpu_predict.fused_bank_predict_reference(*args)
    assert torch.equal(gpu_predict.fused_bank_predict(*args), plain)
    assert torch.equal(gpu_predict.fused_bank_predict_wide(*args), plain)
    assert (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES) == before


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_fused_rejects_geometry_and_device():
    """Only the packed geometry; a CUDA tensor builds and launches the
    kernel (on the FFT route, given fft=) or raises (no fallback); any
    other device raises."""
    fcfg = FeatureConfig()
    flen, fshift, D, W, dct_np, A, floor = _operators(fcfg)
    signals, _, n_valid = _batch(fcfg, B=2)
    bank = tgmm.GmmBank.from_numpy(*_bank(2, 4, fcfg.dim), device="cpu")
    sig, nv = torch.from_numpy(signals), torch.from_numpy(n_valid)
    for fn in (gpu_predict.fused_bank_predict,
               gpu_predict.fused_bank_predict_wide):
        # 22.05 kHz: frame_len 705 != 2 * 352
        f22, s22, D22, W22, dct22, A22, _ = _operators(fcfg, 22050)
        assert (f22, s22) == (705, 352)
        with pytest.raises(ValueError, match="full-spectrum"):
            fn(sig, nv, bank, s22, _t(D22), _t(W22), _t(dct22), floor,
               _t(A22))
        # full-spectrum operators [frame_len, fft/2+1] are not packed ones
        C, _ = frontend.dft_power_projection(flen, 2048)
        with pytest.raises(ValueError, match="packed geometry"):
            fn(sig, nv, bank, fshift, _t(C), _t(W), _t(dct_np), floor,
               _t(A))
        with pytest.raises(ValueError, match="device"):
            fn(sig.to("meta"), nv, bank, fshift, _t(D), _t(W), _t(dct_np),
               floor, _t(A))
        cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
        cbank = types.SimpleNamespace(
            op=cuda(bank.op), cw=cuda(bank.cw), n_speakers=2, n_mixtures=4,
            dim=bank.dim)
        fe = PackedFrontend(FS, fcfg, "cpu")
        fft = fe.fft._replace(window=cuda(fe.window), mel=cuda(fe.fft_mel),
                              acorr=cuda(fe.fft_acorr))
        before = (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES)
        cargs = (cuda(sig), cuda(nv), cbank, fshift, cuda(_t(D)),
                 cuda(_t(W)), cuda(_t(dct_np)), floor, cuda(_t(A)))
        # the f32 kernel runs the FFT route: without it, a refusal
        with pytest.raises(ValueError, match="fft="):
            fn(*cargs)
        with pytest.raises(RuntimeError):
            fn(*cargs, fft=fft)
        assert (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES) == before


def test_bank_operators_match_jax():
    """models/gmm.bank_operators (float64, the port's one fold for every
    kernel) against pallas_predict.bank_score_operators (float32, padded to
    128 lanes with -1e30 components) on the real components."""
    S, K, d = 3, 8, 28
    w, mu, sig = _bank(S, K, d, seed=5)
    op, cw = tgmm.bank_operators(tgmm.GmmParams(w, mu, sig))
    AB, c = pallas_predict.bank_score_operators(
        jgmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sig)),
        128)
    AB, c = np.asarray(AB), np.asarray(c)
    assert op.shape == (2 * d, S * K) and AB.shape == (2 * d, 128)
    np.testing.assert_allclose(AB[:, :S * K], op, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c[0, :S * K], cw, rtol=1e-6, atol=1e-4)
    assert (c[0, S * K:] == -1e30).all()
