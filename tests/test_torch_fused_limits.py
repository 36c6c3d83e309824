"""The fused predict monolith's f32 route past the FFT tile's limits
(ops/gpu_predict, K6/K7): at an FFT of 32768 points (frames longer than
8192 samples; csrc/predict_fused_big.cu on the card) and at 616 mel +
autocorrelation outputs (chunks of 512 on the tile). The port's wrapper on
CPU tensors (its plain version: the FFT route's where the frontend builds
no dense operators) against the JAX package's pallas_predict.
fused_bank_predict and fused_bank_predict_wide in interpret mode, on the
same numpy inputs; and the routes the wrappers take on the card."""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.ops import frontend as jfrontend  # noqa: E402
from speaker_recognition_tpu.ops import pallas_predict  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    PackedFrontend)
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_predict  # noqa: E402

# tests/test_torch_fused_fft.py's tolerance: the JAX monolith's dense DFT
# against the port's FFT, both f32, on per-speaker means of CMVN'd frames
# (~2e-6 relative measured at both shapes here)
RTOL = 2e-4


def _bank(S, K, d, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _batch(lengths, padded, seed=0):
    rng = np.random.RandomState(seed)
    signals = np.zeros((len(lengths), padded), np.float32)
    for i, L in enumerate(lengths):
        signals[i, :L] = (rng.randn(L) * 3000).astype(np.float32)
    return signals


def _dense_operators(F, fft_size, pre_emph, mel_t, lpc_order, rows=1024):
    """ops/frontend.packed_frontend_operators (default pre-emphasis order)
    at float32, built without its dense products, which take terabytes of
    FLOPs at F = 8194: D from a cosine table and the bidiagonal window +
    pre-emphasis, H @ mel = P2R @ (R2P @ mel) as two real FFTs, and the
    column->bin expansion E as a gather."""
    w = jfrontend.hamming(F)
    fft2 = 2 * F
    ang = 2 * np.pi * np.arange(fft2) / fft2
    cos_t, sin_t = np.cos(ang), -np.sin(ang)
    k = np.arange(F + 1)[None, :]
    D = np.empty((F, fft2), np.float32)
    for r0 in range(0, F, rows):
        r1 = min(F, r0 + rows)
        # rows r0 .. r1 of C and S: one past the block for C[q + 1]
        m = (np.arange(r0, r1 + 1)[:, None] * k) % fft2
        C, S = cos_t[m], sin_t[m]
        if r1 == F:  # no sample past the frame
            C[-1] = S[-1] = 0.0
        # Cw[q] = w[q] (C[q] - a C[q + 1]), and Sw likewise
        Cw = w[r0:r1, None] * (C[:-1] - pre_emph * C[1:])
        Sw = w[r0:r1, None] * (S[:-1] - pre_emph * S[1:])
        D[r0:r1] = np.concatenate([Cw[:, :F], Sw[:, 1:F], Cw[:, F:F + 1]],
                                  axis=1)
    # R2P @ mel: r[l] = 2 sum_k cos(2 pi k l / fft_size) mel[k], half at l = 0
    r = 2.0 * np.fft.fft(mel_t, n=fft_size, axis=0).real[:F]
    r[0] /= 2.0
    # P2R @ r: 2 sum_l cos(2 pi k l / fft2) r[l] / fft2, half at k = 0, F
    Hm = 2.0 * np.fft.fft(r, n=fft2, axis=0).real[:F + 1] / fft2
    Hm[0] /= 2.0
    Hm[F] /= 2.0
    # bin of each packed column: re 0..F-1 | im 1..F-1 | Nyquist
    col_bin = np.concatenate([np.arange(F), 1 + np.arange(F - 1), [F]])
    j = np.arange(lpc_order + 1)[None, :]
    P2R = 2.0 * cos_t[(np.arange(F + 1)[:, None] * j) % fft2] / fft2
    P2R[0] /= 2.0
    P2R[-1] /= 2.0
    return (D, Hm[col_bin].astype(np.float32),
            (P2R / F)[col_bin].astype(np.float32))


def test_blockwise_operators_equal_the_jax_builder():
    """The blockwise builder above is ops/frontend.packed_frontend_operators
    at a frame the JAX builder takes in a moment (to float32 rounding)."""
    F, fft_size = 100, 512
    mel_t = jfrontend.mel_filterbank(3125, fft_size, 26).T
    D, W, A = _dense_operators(F, fft_size, 0.95, mel_t, 15, rows=37)
    Dj, Wj, Aj = jfrontend.packed_frontend_operators(F, fft_size, 0.95,
                                                      mel_t, lpc_order=15)
    np.testing.assert_allclose(D, Dj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(W, Wj, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(A, Aj, rtol=1e-6, atol=1e-12)


def _jax_monolith(fe: PackedFrontend, D, W, A, signals, n_valid, bank_np,
                  wide):
    jbank = jgmm.GmmParams(*(jnp.asarray(a) for a in bank_np))
    args = (jnp.asarray(signals), jnp.asarray(n_valid), jbank,
            fe.frame_shift, D, W, fe.dct.double().numpy(), fe.floor, A)
    if wide:
        return np.asarray(pallas_predict.fused_bank_predict_wide(
            *args, cmvn=fe.cmvn, interpret=True, utt_tile=2))
    return np.asarray(pallas_predict.fused_bank_predict(
        *args, cmvn=fe.cmvn, interpret=True))


def _port(fe: PackedFrontend, signals, n_valid, bank_np, wide):
    fn = (gpu_predict.fused_bank_predict_wide if wide
          else gpu_predict.fused_bank_predict)
    tbank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    return fn(torch.from_numpy(signals), torch.from_numpy(n_valid), tbank,
              fe.frame_shift, fe.D, fe.W, fe.dct, fe.floor, fe.A, fe.cmvn,
              fft=fe.fft).numpy()


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()


def _long_frames():
    """1 s frames at 8194 Hz (8194 samples, past 8192: a 32768-point FFT on
    the packed route) with fft_size 32768 and LPC-15."""
    ms = dict(win_length_ms=1000.0, win_shift_ms=500.0)
    return tcfg.FeatureConfig(mfcc=tcfg.MfccConfig(fft_size=32768, **ms),
                              lpc=tcfg.LpcConfig(**ms))


def test_32768_point_fft_matches_the_jax_monolith():
    """Two short utterances of 8194-sample frames: the port's frontend
    builds no dense operators there, and its wrapper on the CPU runs the
    FFT route's plain version (what csrc/predict_fused_big.cu computes on
    the card), against the JAX monolith on the dense packed operators."""
    fs = 8194
    fe = PackedFrontend(fs, _long_frames(), "cpu")
    assert fe.n_fft == 32768 and fe.D is None
    assert (fe.frame_len, fe.frame_shift) == (8194, 4097)
    padded = 8 * 4097  # the JAX kernel's rows: a multiple of 8 shifts
    signals = _batch([padded, 15000], padded, seed=3)
    n_valid = np.array([tcfg.n_frames(n, 8194, 4097)
                        for n in (padded, 15000)], np.int32)
    assert n_valid.tolist() == [7, 2]
    mel_t = jfrontend.mel_filterbank(fs, 32768, 50).T
    D, W, A = _dense_operators(8194, 32768, fe.pre_emph, mel_t, 15)
    bank = _bank(3, 8, 28, seed=4)
    want = _jax_monolith(fe, D, W, A, signals, n_valid, bank, False)
    for wide in (False, True):
        _assert_close(_port(fe, signals, n_valid, bank, wide), want)


def _wide616():
    """600 mel filters + LPC-15 (616 outputs) at 8 kHz with 200 ms frames
    and fft_size 4096: chip_smoke.py's WIDE616."""
    ms = dict(win_length_ms=200.0, win_shift_ms=100.0)
    return tcfg.FeatureConfig(
        mfcc=tcfg.MfccConfig(fft_size=4096, n_filters=600, **ms),
        lpc=tcfg.LpcConfig(**ms))


@pytest.mark.parametrize("wide", [False, True], ids=["k6", "k7"])
def test_616_outputs_match_the_jax_monolith(wide):
    """616 outputs (two chunks of 512 on the card's tile): the port's FFT
    route's plain version (what the chunked kernel computes) against the
    JAX monolith on the frontend's dense packed operators."""
    fe = PackedFrontend(8000, _wide616(), "cpu")
    assert fe.n_fft == 4096 and fe.fft_mel.shape[1] + fe.fft_acorr.shape[1] \
        == 616
    signals = _batch([12800, 6000], 12800, seed=5)
    n_valid = np.array([tcfg.n_frames(n, 1600, 800) for n in (12800, 6000)],
                       np.int32)
    bank = _bank(4, 8, 28, seed=6)
    tbank = tgmm.GmmBank.from_numpy(*bank, device="cpu")
    got = gpu_predict.fused_bank_predict_fft_reference(
        torch.from_numpy(signals), torch.from_numpy(n_valid), tbank,
        fe.frame_shift, fe.dct, fe.floor, fe.fft, fe.cmvn).numpy()
    want = _jax_monolith(fe, fe.D.double().numpy(), fe.W.double().numpy(),
                         fe.A.double().numpy(), signals, n_valid, bank, wide)
    _assert_close(got, want)
    # and the wrapper's CPU route (the dense plain version) likewise
    _assert_close(_port(fe, signals, n_valid, bank, wide), want)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return t.as_subclass(_CudaTyped)


class _Lib:
    """A stand-in for the kernels' library that records the calls."""

    def __init__(self):
        self.calls = {}

    def srt_fused_component_row(self, d):
        return 2 * 32 + 4

    def srt_fused_scratch_floats(self, B, T, d, S):
        return B * T * d + B * S

    def srt_fft_wide_floats(self, nframes, nout):
        return nframes * 512 * -(-nout // 512) if nout > 512 else 0

    def srt_big_scratch_floats(self, n_fft, nout, chunk):
        return chunk * (n_fft + nout)

    def srt_big_operator_shape(self, n_fft, nout, rows, cols, chunks):
        chunks._obj.value = -(-nout // 512)
        rows._obj.value = (n_fft // 2 + 1 + 15) // 16 * 16 * chunks._obj.value
        cols._obj.value = 512
        return 0

    def srt_fft_operator_shape(self, n_fft, nout, rows, cols, chunks):
        chunks._obj.value = -(-nout // 512)
        rows._obj.value = (n_fft // 2 + 1 + 15) // 16 * 16 * chunks._obj.value
        cols._obj.value = 512
        return 0

    def srt_fused_predict(self, *args):
        self.calls["tile"] = args
        return 0

    def srt_fused_predict_big(self, *args):
        self.calls["big"] = args
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    from speaker_recognition_tpu_torch import _build

    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    return lib


def _cuda_call(fe, fn, Lp):
    bank = tgmm.GmmBank.from_numpy(*_bank(2, 4, 28), device="cpu")
    cbank = types.SimpleNamespace(
        op=_cuda(bank.op), cw=_cuda(bank.cw), n_speakers=2, n_mixtures=4,
        dim=28, component_operator=lambda row: torch.zeros(2, 4, row))
    fft = fe.fft._replace(window=_cuda(fe.window), mel=_cuda(fe.fft_mel),
                          acorr=_cuda(fe.fft_acorr))
    nv = _cuda(torch.full((2,), 3, dtype=torch.int32))
    opt = lambda t: None if t is None else _cuda(t)  # noqa: E731
    return fn(_cuda(torch.zeros(2, Lp)), nv, cbank, fe.frame_shift,
              opt(fe.D), opt(fe.W), _cuda(fe.dct), fe.floor, opt(fe.A),
              fft=fft)


@pytest.mark.parametrize("wide", [False, True], ids=["k6", "k7"])
def test_the_card_routes_take_every_shape(stand_in, wide):
    """On a CUDA tensor the f32 wrappers no longer refuse N > 16384 or more
    than 512 outputs: N = 32768 takes the four-step route (its own counter,
    in place of LAUNCHES / WIDE_LAUNCHES), 616 outputs the tile with device
    rows for the sums (CHUNKED_LAUNCHES beside the wrapper's counter)."""
    fn = (gpu_predict.fused_bank_predict_wide if wide
          else gpu_predict.fused_bank_predict)
    own = "WIDE_LAUNCHES" if wide else "LAUNCHES"
    counts = lambda: {k: getattr(gpu_predict, k) for k in (  # noqa: E731
        own, "BIG_LAUNCHES", "CHUNKED_LAUNCHES")}

    fe = PackedFrontend(8194, _long_frames(), "cpu")
    before = counts()
    assert _cuda_call(fe, fn, 6 * 4097).shape == (2, 2)
    after = counts()
    assert after == {own: before[own], "CHUNKED_LAUNCHES":
                     before["CHUNKED_LAUNCHES"],
                     "BIG_LAUNCHES": before["BIG_LAUNCHES"] + 1}
    c = stand_in.calls.pop("big")
    # B, Lp, T, flen, fshift, nfft, nmel, nac, nceps, S, K (after the
    # signals, n_valid, window, packed operator, dct, components, scratch,
    # four-step scratch and output pointers)
    assert c[9:20] == (2, 6 * 4097, 5, 8194, 4097, 32768, 50, 16, 13, 2, 4)
    assert c[-2] >= 1  # frames a chunk

    fe = PackedFrontend(8000, _wide616(), "cpu")
    before = counts()
    assert _cuda_call(fe, fn, 9600).shape == (2, 2)
    after = counts()
    assert after == {own: before[own] + 1, "BIG_LAUNCHES":
                     before["BIG_LAUNCHES"],
                     "CHUNKED_LAUNCHES": before["CHUNKED_LAUNCHES"] + 1}
    c = stand_in.calls.pop("tile")
    assert c[9] != 0  # the sums rows of two chunks of 512 outputs
    assert c[11:20] == (2, 9600, 11, 1600, 800, 4096, 0, 600, 16)
