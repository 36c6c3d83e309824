"""The full-spectrum frontend from the signals (ops/gpu_frontend.
mfcc_from_signals, csrc/frontend_full_signals.cu on the card) and the LPC
cepstra in the signal kernels' tail (packed_from_signals(n_lpcc=...), csrc/
frontend.cu), held on the CPU to the JAX package on the same numpy inputs:
the plain signal route against the JAX extractor's full route at 44.1, 48
and 96 kHz (MFCC13 + LPC15, LPC cepstra, CMVN off, deltas, pre-emphasis
first, an utterance with no valid frame, a silent one, frames folded past
the fft_size), its pre-CMVN output against JAX framing + the Pallas K5 in
interpret mode, and K1's plain LPC-cepstra mode against the JAX extractor
at 8 kHz (an all-zero frame gives 0); the routes FullFrontend and
PackedFrontend take, and what the wrappers refuse."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.ops import framing as jframing  # noqa: E402
from speaker_recognition_tpu.ops import frontend as joperators  # noqa: E402
from speaker_recognition_tpu.ops import levinson as jlevinson  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402

# Features against the JAX extractor (both f32, another FFT and other
# summation orders): the bound of tests/test_torch_full.py, 2e-3 relative
# and 2e-2 absolute on CMVN'd cepstra and LPC of O(1); LPC cepstra of white
# noise reach O(1e3) through a recursion whose terms cancel, so they are
# held within 2e-2 + 2e-3 of their frame's largest, as
# tests/test_torch_lpcc_route.py holds them.
RTOL, ATOL = 2e-3, 2e-2


def _cfg(c, fs_case: str):
    """The FeatureConfig of a case in config module c."""
    lpcc = c.LpcConfig(n_lpcc=16)
    return {
        "mfcc_lpc": c.FeatureConfig(),
        "lpcc": c.FeatureConfig(lpc=lpcc),
        "cmvn_off": c.FeatureConfig(mfcc=c.MfccConfig(cmvn=False)),
        "cmvn_off_lpcc": c.FeatureConfig(mfcc=c.MfccConfig(cmvn=False),
                                         lpc=lpcc),
        "deltas2": c.FeatureConfig(n_deltas=2),
        "preemph_first": c.FeatureConfig(
            mfcc=c.MfccConfig(preemph_first=True)),
        "mfcc_only": c.FeatureConfig(use_lpc=False, n_deltas=1),
    }[fs_case]


def _signals(lengths, L, seed, scale=3000.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


def _spy_signals(monkeypatch):
    """Calls of mfcc_from_signals, recorded (n_lpcc, cmvn) and run."""
    calls = []
    real = gpu_frontend.mfcc_from_signals

    def spy(*a, **kw):
        calls.append((a[7], a[6]))
        return real(*a, **kw)
    monkeypatch.setattr(gpu_frontend, "mfcc_from_signals", spy)
    return calls


def _assert_features(got, want, nceps, lpcc: bool, per_block: int):
    """MFCC and LPC columns within RTOL / ATOL; LPC cepstra (lpcc) within
    ATOL + RTOL of their frame's largest. Columns repeat every per_block
    (deltas)."""
    assert got.shape == want.shape
    cols = np.arange(got.shape[-1]) % per_block >= nceps
    if not lpcc:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    np.testing.assert_allclose(got[..., ~cols], want[..., ~cols], rtol=RTOL,
                               atol=ATOL)
    scale = np.abs(want[..., cols]).max(axis=-1, keepdims=True)
    assert (np.abs(got[..., cols] - want[..., cols])
            <= ATOL + RTOL * scale).all()


# (fs, case, padded length): 44.1 kHz frames of 1411 samples (odd) and
# shift 705, 48 kHz frames of 1536, both on 2048-point FFTs; 96 kHz frames
# of 3072 samples folded onto the default 2048-point FFT
SIGNAL_CASES = {
    "44k": (44100, "mfcc_lpc", 45056),
    "48k": (48000, "mfcc_lpc", 45056),
    "44k_lpcc": (44100, "lpcc", 45056),
    "48k_lpcc": (48000, "lpcc", 45056),
    "48k_cmvn_off": (48000, "cmvn_off", 45056),
    "44k_deltas2": (44100, "deltas2", 45056),
    "48k_deltas2": (48000, "deltas2", 45056),
    "44k_preemph_first": (44100, "preemph_first", 45056),
    "48k_preemph_first": (48000, "preemph_first", 45056),
    "48k_mfcc_only": (48000, "mfcc_only", 45056),
    "96k_folded": (96000, "mfcc_lpc", 53248),
    "96k_folded_lpcc": (96000, "lpcc", 53248),
}


@pytest.mark.parametrize("case", list(SIGNAL_CASES))
def test_signal_route_matches_jax_full_route(case, monkeypatch):
    """extract_batch on the full-spectrum frontend's signal route (the plain
    version of mfcc_from_signals on the CPU, one call) against the JAX
    extractor's full route (XLA, f32): ragged lengths, an utterance one
    sample short of a frame (no valid frame) and an empty one."""
    fs, name, L = SIGNAL_CASES[case]
    tc, jc = _cfg(tcfg, name), _cfg(jcfg, name)
    fe = text.frontend(fs, tc, "cpu")
    assert isinstance(fe, text.FullFrontend) and fe.signal_route
    assert fe.frame_len > fe.n_fft if fs == 96000 else fe.frame_len <= 2048
    calls = _spy_signals(monkeypatch)
    sig, lens = _signals([L, int(0.6 * L), fe.frame_len - 1, 0], L, seed=7)
    want, wmask = jext._feature_fn(fs, jc, L, "float32", "off", "f32",
                                   "packed", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, tc)
    assert calls == [(tc.lpc.n_lpcc if tc.use_lpc else 0, tc.mfcc.cmvn)]
    assert got.dtype == torch.float32 and got.shape[-1] == tc.dim
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert not mask[2:].any()
    got = got.numpy()
    assert np.isfinite(got).all() and (got[~mask.numpy()] == 0).all()
    _assert_features(got, np.asarray(want), tc.mfcc.n_ceps,
                     tc.use_lpc and tc.lpc.n_lpcc > 0,
                     tc.dim // (tc.n_deltas + 1))


@pytest.mark.parametrize("name", ["mfcc_lpc", "lpcc", "cmvn_off_lpcc"])
def test_silent_utterance_matches_jax(name, monkeypatch):
    """A silent utterance beside a noisy one at 48 kHz: every bin of a
    silent frame sits on the power floor. Its LPC columns agree with the JAX
    extractor's (LPC and LPC cepstra about 0: the floored power's
    autocorrelation is flat), and so does every column of the noisy
    utterance. With CMVN on, a silent utterance's cepstra are the same in
    every frame and CMVN divides by a zero deviation (NaN or +-1, inherited
    from MFCC.py, ROADMAP queue 3), so those columns are compared with CMVN
    off only."""
    tc, jc = _cfg(tcfg, name), _cfg(jcfg, name)
    L = 45056
    sig, lens = _signals([L, L], L, seed=11)
    sig[0] = 0.0
    want, _ = jext._feature_fn(48000, jc, L, "float32", "off", "f32",
                               "packed", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    calls = _spy_signals(monkeypatch)
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), 48000, tc)
    assert len(calls) == 1
    got, want = got.numpy(), np.asarray(want)
    nc = tc.mfcc.n_ceps
    lpcc = tc.lpc.n_lpcc > 0
    _assert_features(got[1:], want[1:], nc, lpcc, tc.dim)
    np.testing.assert_allclose(got[0, :, nc:], want[0, :, nc:], rtol=0,
                               atol=1e-3)
    assert np.abs(got[0, :, nc:]).max() <= 1e-3
    if not tc.mfcc.cmvn:
        np.testing.assert_allclose(got[0, :, :nc], want[0, :, :nc],
                                   rtol=RTOL, atol=ATOL)


def _jax_operators(fs, cfg):
    """(C, S, mel, dct, acorr) of the JAX full route at fs for a jcfg
    FeatureConfig with the default mel bank, float64 numpy."""
    mf = cfg.mfcc
    flen, _ = jcfg.frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    C, S = joperators.dft_power_projection(flen, mf.fft_size)
    mel = joperators.mel_filterbank(fs, mf.fft_size, mf.n_filters).T
    dct = joperators.dct_matrix(mf.n_filters)[1:mf.n_ceps + 1].T
    acorr = jlevinson.autocorr_operator(flen, mf.fft_size, cfg.lpc.n_lpc)
    return C, S, mel, dct, acorr


@pytest.mark.parametrize("fs,name", [(48000, "mfcc_lpc"), (44100, "lpcc"),
                                     (96000, "mfcc_lpc")],
                         ids=["48k", "44k_lpcc", "96k_folded"])
def test_pre_cmvn_matches_the_pallas_kernel(fs, name):
    """FullFrontend.pre_cmvn on the signal route (CMVN off, no deltas)
    against JAX framing, window and pre-emphasis, then pallas_frontend.
    mfcc_from_frames in interpret mode (the dense C and S, which alias
    columns where the frame is longer than the FFT) and the LPC columns of
    its raw autocorrelation by the JAX package's Levinson (and LPC cepstra,
    nan_to_num); a silent stretch puts frames on the floor. Pre-CMVN
    cepstra of O(10-100) within 1e-3 (~1e-6 relative on the power, the
    bound of tests/test_torch_fft.py); LPC within 1e-3, LPC cepstra within
    1e-3 of their frame's largest."""
    tc, jc = _cfg(tcfg, name), _cfg(jcfg, name)
    fe = text.FullFrontend(fs, tc, "cpu")
    L = 4096 * (-(-int(0.3 * fs) // 4096))
    sig, lens = _signals([L, int(0.7 * L)], L, seed=13)
    sig[0, fe.frame_len:3 * fe.frame_len] = 0.0
    ceps, lpc, mask = fe.pre_cmvn(torch.from_numpy(sig),
                                  torch.from_numpy(lens))
    C, S, mel, dct, acorr = _jax_operators(fs, jc)
    frames = jframing.frame_signal(jnp.asarray(sig), fe.frame_len,
                                   fe.frame_shift)
    B, T = frames.shape[:2]
    wp = jframing.window_preemph(frames, fe.frame_len, jc.mfcc.pre_emph,
                                 jc.mfcc.preemph_first)
    wp = wp.reshape(B * T, -1).astype(jnp.float32)
    wc, wr = pallas_frontend.mfcc_from_frames(wp, C, S, mel, dct, fe.floor,
                                              acorr_t=acorr, interpret=True)
    if jc.lpc.n_lpcc > 0:
        a, _ = jlevinson.levinson(wr)
        wl = jnp.nan_to_num(jlevinson.lpcc_from_lpc(a, jc.lpc.n_lpcc),
                            nan=0.0, posinf=0.0, neginf=0.0)
    else:
        wl = jlevinson.lpc_from_autocorr(wr)
    m = mask.numpy()
    wc = np.asarray(wc).reshape(B, T, -1)[m]
    wl = np.asarray(wl).reshape(B, T, -1)[m]
    assert ceps.shape == (B, T, tc.mfcc.n_ceps)
    assert (ceps.numpy()[~m] == 0).all() and (lpc.numpy()[~m] == 0).all()
    np.testing.assert_allclose(ceps.numpy()[m], wc, rtol=1e-4, atol=1e-3)
    scale = np.abs(wl).max(axis=-1, keepdims=True)
    tol = 1e-3 * (scale if jc.lpc.n_lpcc > 0 else 1.0)
    assert (np.abs(lpc.numpy()[m] - wl) <= tol).all()


@pytest.mark.parametrize("fs", [8000, 16000], ids=["8k", "16k"])
def test_k1_lpcc_mode_matches_jax(fs, monkeypatch):
    """PackedFrontend with LPC cepstra (n_lpcc = 16) calls K1's plain
    version once in its LPC-cepstra mode, and its features equal the JAX
    extractor's (XLA: Levinson, the recursion, nan_to_num) within the
    bounds above. An all-zero frame inside an utterance gives LPC cepstra
    of exactly 0 on both sides: the recursion runs on the NaN coefficients
    of r = 0 and zeroes them after. Both plain versions (dense, FFT) of the
    mode equal the raw-autocorrelation mode followed by the torch tail."""
    tc, jc = _cfg(tcfg, "lpcc"), _cfg(jcfg, "lpcc")
    fe = text.frontend(fs, tc, "cpu")
    assert isinstance(fe, text.PackedFrontend)
    L = 8192 if fs == 8000 else 16384
    sig, lens = _signals([L, int(0.6 * L), L // 5, 0], L, seed=17)
    zero = slice(8 * fe.frame_shift, 8 * fe.frame_shift + 3 * fe.frame_len)
    sig[0, zero] = 0.0
    calls = []
    real = gpu_frontend.packed_from_signals

    def spy(*a, **kw):
        calls.append((kw["fuse_lpc"], kw["n_lpcc"]))
        return real(*a, **kw)
    monkeypatch.setattr(gpu_frontend, "packed_from_signals", spy)
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, tc)
    assert calls == [(True, 16)]
    want, wmask = jext._feature_fn(fs, jc, L, "float32", "off", "f32",
                                   "packed", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    _assert_features(got, want, 13, True, tc.dim)
    silent = [t for t in range(mask.shape[1])
              if t * fe.frame_shift >= zero.start
              and t * fe.frame_shift + fe.frame_len <= zero.stop]
    assert silent
    assert (got[0, silent, 13:] == 0).all() and (want[0, silent, 13:] == 0).all()

    nv = fe.valid_frames(torch.from_numpy(lens), mask.shape[1])
    s = torch.from_numpy(sig)
    for name, run in (
            ("dense", lambda fl, n: gpu_frontend.packed_from_signals_reference(
                s, nv, fe.D, fe.W, fe.dct, fe.A, fe.floor, fe.frame_shift,
                True, fl, n_lpcc=n)),
            ("fft", lambda fl, n:
             gpu_frontend.packed_from_signals_fft_reference(
                 s, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, True, fl,
                 n))):
        fused = run(True, 16)
        ceps, r = run(False, 0)
        tail, _ = fe.finish(ceps, r, mask, cmvn_done=True)
        assert torch.equal(fused, tail), name


def test_routes_and_counters(monkeypatch):
    """FullFrontend takes the signal route at float32 with f32 operands and
    a power-of-two fft_size below 32768, and the frame route (the frame
    kernels or their plain versions, then the torch tail) otherwise: an
    fft_size that is not a power of two, 32768 points, bf16 operands,
    float64, LPC cepstra past LPCC_MAX_LAGS lags. PackedFrontend takes K1's
    LPC-cepstra mode except with bf16 operands. On the CPU no counter
    moves, the LPC-cepstra kernel's (LPCC_SIGNAL_LAUNCHES) included."""
    lpcc = tcfg.LpcConfig(n_lpcc=16)
    full = lambda **kw: text.FullFrontend(  # noqa: E731
        48000, tcfg.FeatureConfig(**kw), "cpu")
    assert full().signal_route and full(lpc=lpcc).signal_route
    assert not full(mfcc=tcfg.MfccConfig(fft_size=1500)).signal_route
    assert not text.FullFrontend(48000, tcfg.FeatureConfig(
        mfcc=tcfg.MfccConfig(fft_size=32768)), "meta").signal_route
    assert not text.FullFrontend(48000, tcfg.FeatureConfig(), "cpu",
                                 mm="bf16").signal_route
    assert not text.FullFrontend(48000, tcfg.FeatureConfig(), "cpu",
                                 dtype=torch.float64).signal_route
    wide = tcfg.LpcConfig(n_lpc=gpu_frontend.LPCC_MAX_LAGS, n_lpcc=16)
    assert full(lpc=tcfg.LpcConfig(n_lpc=gpu_frontend.LPCC_MAX_LAGS))\
        .signal_route
    assert not text.FullFrontend(48000, tcfg.FeatureConfig(lpc=wide),
                                 "meta").signal_route
    packed = text.PackedFrontend(8000, tcfg.FeatureConfig(lpc=lpcc), "cpu")
    assert packed._lpcc_in_kernel()
    assert not text.PackedFrontend(8000, tcfg.FeatureConfig(lpc=lpcc), "cpu",
                                   mm="bf16")._lpcc_in_kernel()

    # the frame route at fft_size 1500 never calls mfcc_from_signals
    calls = _spy_signals(monkeypatch)
    sig, lens = _signals([24576, 9000], 24576, seed=3)
    args = (torch.from_numpy(sig), torch.from_numpy(lens), 48000)
    text.extract_batch(*args, tcfg.FeatureConfig(
        mfcc=tcfg.MfccConfig(fft_size=1500)))
    text.extract_batch(*args, tcfg.FeatureConfig(), "float64")
    assert calls == []
    counters = ("FULL_SIGNAL_LAUNCHES", "LAUNCHES", "LPCC_SIGNAL_LAUNCHES")
    before = [getattr(gpu_frontend, c) for c in counters]
    text.extract_batch(*args, tcfg.FeatureConfig())
    text.extract_batch(torch.from_numpy(sig[:, :8192]),
                       torch.from_numpy(np.minimum(lens, 8192)), 8000,
                       tcfg.FeatureConfig(lpc=lpcc))
    assert len(calls) == 1
    assert [getattr(gpu_frontend, c) for c in counters] == before


def test_bf16_lpcc_takes_the_raw_mode(monkeypatch):
    """With bf16 operands the packed frontend's LPC cepstra come from the
    raw-autocorrelation mode and the torch tail (the bf16 kernel has no
    LPC-cepstra mode); the wrapper refuses n_lpcc with mm_bf16."""
    tc = _cfg(tcfg, "lpcc")
    fe = text.PackedFrontend(8000, tc, "cpu", mm="bf16")
    sig, lens = _signals([8192, 5000], 8192, seed=19)
    calls = []
    real = gpu_frontend.packed_from_signals

    def spy(*a, **kw):
        calls.append((kw["fuse_lpc"], kw["n_lpcc"]))
        return real(*a, **kw)
    monkeypatch.setattr(gpu_frontend, "packed_from_signals", spy)
    got, mask = fe(torch.from_numpy(sig), torch.from_numpy(lens))
    assert calls == [(False, 0)] and got.shape[-1] == tc.dim
    assert torch.isfinite(got).all()
    with pytest.raises(ValueError, match="mm_bf16"):
        real(torch.from_numpy(sig), torch.zeros(2, dtype=torch.int32), fe.D,
             fe.W, fe.dct, fe.A, fe.floor, fe.frame_shift, True,
             mm_bf16=True, n_lpcc=16)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrappers_check_before_the_kernel(monkeypatch):
    """On a CUDA tensor mfcc_from_signals checks its arguments before it
    builds anything: a float64 signal, a short signal and LPC cepstra past
    LPCC_MAX_LAGS lags raise; no other device falls back to the CPU."""
    fe = text.FullFrontend(48000, tcfg.FeatureConfig(), "cpu")
    monkeypatch.setattr(gpu_frontend._build, "load", lambda: pytest.fail(
        "the wrapper built the kernels before refusing its arguments"))
    sig = torch.zeros(2, 4096).as_subclass(_CudaTyped)
    nv = torch.zeros(2, dtype=torch.int32).as_subclass(_CudaTyped)
    cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    fft = gpu_frontend.FftRoute(2048, cuda(fe.window), 0.97, False,
                                cuda(fe.mel), cuda(fe.acorr))
    with pytest.raises((TypeError, ValueError)):
        gpu_frontend.mfcc_from_signals(sig.double().as_subclass(_CudaTyped),
                                       nv, fft, cuda(fe.dct), fe.floor, 768,
                                       True)
    with pytest.raises(ValueError):
        gpu_frontend.mfcc_from_signals(
            torch.zeros(2, 1000).as_subclass(_CudaTyped), nv, fft,
            cuda(fe.dct), fe.floor, 768, True)
    wide = fft._replace(acorr=cuda(torch.zeros(fe.mel.shape[0], 513)))
    with pytest.raises(ValueError, match="lags"):
        gpu_frontend.mfcc_from_signals(sig, nv, wide, cuda(fe.dct), fe.floor,
                                       768, True, 16)
    with pytest.raises(ValueError, match="device"):
        gpu_frontend.mfcc_from_signals(torch.zeros(2, 4096, device="meta"),
                                       nv, fft, fe.dct, fe.floor, 768, True)


def _chip_gates():
    """chip_smoke.py's gates on the features: MFCC_ATOL, LPC_ATOL,
    LPC_RTOL."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    with open(path) as f:
        src = f.read()
    mfcc = float(re.search(r"^MFCC_ATOL = (\S+)$", src, re.M)[1])
    m = re.search(r"^LPC_ATOL, LPC_RTOL = (\S+), (\S+)$", src, re.M)
    return mfcc, float(m[1]), float(m[2])


def _tf32(x):
    """cvt.rna.tf32.f32: the low 13 bits, rounded half away."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _mma_sums(terms, nb, ncols):
    """The f32 sums of mma.sync m16n8k8 products over 8-bin k-steps: for
    each k-step each (A, B) of `terms` in turn, its 8 products in float64,
    added to the f32 sums [frames, ncols]."""
    ks = -(-nb // 8)
    acc = np.zeros((len(terms[0][0]), ncols), np.float32)
    for k in range(ks):
        sl = slice(8 * k, 8 * k + 8)
        for a, b in terms:
            acc = (acc.astype(np.float64)
                   + a[:, sl].astype(np.float64) @ b[sl].astype(
                       np.float64)).astype(np.float32)
    return acc


def _split_terms(P, op):
    """The three products of the split: lo.hi, hi.lo, hi.hi."""
    Ph, Bh = _tf32(P), _tf32(op)
    Pl, Bl = _tf32(P - Ph), _tf32(op - Bh)
    return ((Pl, Bh), (Ph, Bl), (Ph, Bh))


def _levinson64(r):
    """a_1 .. a_p of each row of r [n, p + 1], float64 (NaN where r[0] =
    0)."""
    a, _ = gpu_frontend.levinson.levinson(torch.from_numpy(r))
    return a[..., 1:].numpy()


def test_tf32_split_projection_holds_the_gates():
    """The projection of csrc/signal_tile.cuh modelled in numpy: the 48 kHz
    operator ([mel | acorr] of FullFrontend(48000) at N = 2048) and the
    floored power rows of voice frames (two synthetic speakers, windowed
    and pre-emphasized) and of a silent stretch (every bin on the floor),
    each operand split as hi = tf32(x) (cvt.rna: to nearest, ties away),
    lo = tf32(x - hi); per 8-bin k-step the three products lo.hi, hi.lo,
    hi.hi (mma.sync m16n8k8) each added to the f32 sums, the 8 products in
    float64. Against the float64 sums of the same f32 operands: the log-mel
    and the cepstra after the DCT within chip_smoke.py's MFCC_ATOL, the LPC
    and the LPC cepstra (float64 Levinson on both) within LPC_ATOL or
    LPC_RTOL, and the silent frames' LPC cepstra 0 (their lag 0 lies below
    the least normal float: gpu_frontend.lpc_columns' r = 0 rule). Prints
    how far one TF32 term (hi.hi) would land."""
    from speaker_recognition_tpu_torch.ops import framing as tframing
    from speaker_recognition_tpu_torch.testdata import synth

    mfcc_atol, lpc_atol, lpc_rtol = _chip_gates()
    fe = text.FullFrontend(48000, tcfg.FeatureConfig(), "cpu")
    N, nb = fe.n_fft, fe.n_fft // 2 + 1
    nmel, nceps = fe.dct.shape
    op = torch.cat([fe.mel[:nb], fe.acorr[:nb]], 1).numpy()  # f32
    sig = np.concatenate([synth.synth_utterance(who, 0.4, 5, 48000)
                          for who in ("alice", "bob")]).astype(np.float64)
    sig[6000:6000 + 6 * fe.frame_len] = 0.0
    frames = tframing.window_preemph(
        tframing.frame_signal(torch.from_numpy(sig), fe.frame_len,
                              fe.frame_shift), fe.frame_len, fe.pre_emph,
        fe.preemph_first).numpy()
    P = (np.abs(np.fft.rfft(frames, N)) ** 2).astype(np.float32)
    P = np.maximum(P, np.float32(fe.floor))
    silent = (P == np.float32(fe.floor)).all(-1)
    assert 4 <= silent.sum() < len(P) // 2

    def mma_sums(terms):
        return _mma_sums(terms, nb, op.shape[1])

    terms = _split_terms(P, op)
    exact = P.astype(np.float64) @ op.astype(np.float64)
    dct = fe.dct.numpy().astype(np.float64)
    order = fe.acorr.shape[1] - 1
    voiced = ~silent

    def features(sums):
        s = sums.astype(np.float64)
        logmel = np.log(np.maximum(s[:, :nmel], fe.floor))
        r = s[:, nmel:]
        lpc = _levinson64(r[voiced])
        a = torch.from_numpy(np.concatenate(
            [np.ones((voiced.sum(), 1)), lpc], 1))
        lpcc = gpu_frontend.levinson.lpcc_from_lpc(a, 16).numpy()
        return logmel, logmel @ dct, lpc, lpcc

    want = features(exact)
    split = mma_sums(terms)
    got = features(split)
    for name, g, w, (atol, rtol) in zip(
            ("log-mel", "cepstra", "LPC", "LPC cepstra"), got, want,
            ((mfcc_atol, 0.0), (mfcc_atol, 0.0), (lpc_atol, lpc_rtol),
             (lpc_atol, lpc_rtol))):
        d = np.abs(g - w)
        assert np.isfinite(g).all(), name
        bad = (d > atol) & (d > rtol * np.abs(w))
        assert not bad.any(), (name, float(d.max()))
    assert order == 15
    # the LPC cepstra of the silent frames, as the kernel's tail takes them
    r32 = torch.from_numpy(split[:, nmel:])
    assert (r32[silent, 0] < torch.finfo(torch.float32).tiny).all()
    assert (gpu_frontend.lpc_columns(r32[silent], 16) == 0).all()

    one = features(mma_sums(terms[2:]))
    print("3xTF32 against float64: " + ", ".join(
        f"{n} {float(np.abs(g - w).max()):.2e}"
        for n, g, w in zip(("log-mel", "cepstra", "LPC", "LPC cepstra"),
                           got, want)))
    print("one TF32 term (hi.hi) against float64: " + ", ".join(
        f"{n} {float(np.abs(g - w).max()):.2e}"
        for n, g, w in zip(("log-mel", "cepstra", "LPC", "LPC cepstra"),
                           one, want)))


def _tensor_core_add(c, a, b):
    """One mma.sync on the tensor cores' adder (tests/cuda_standin/
    cuda_runtime.h): c [n, m] f32 plus a [n, 8] @ b [8, m] (TF32 values),
    the products exact, c and the 8 products aligned to the largest of
    them and each cut toward zero below that one's 24th bit, summed, the
    sum cut toward zero to f32."""
    terms = torch.cat([c.double()[:, None],
                       a.double()[:, :, None] * b.double()[None]], 1)
    top = torch.frexp(terms)[1].masked_fill(terms == 0, -1000).amax(
        1, keepdim=True)  # -1000: all zero, the sum 0
    unit = torch.ldexp(torch.ones_like(top, dtype=torch.float64), top - 24)
    s = (torch.trunc(terms / unit) * unit).sum(1)
    r = s.float()
    over = r.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _k2_logp(X, op, cw, terms, carried=False):
    """csrc/gmm_score.cu's tensor-route product at d <= 40 modelled on the
    tensor cores' adder: logp [frames, S*K] f32 of the frames X [n, d]
    under op [2d, S*K], cw [S*K] (f32), x^2 formed in f32; per 8-deep
    k-step each of the split products `terms` (of lo.hi, hi.lo, hi.hi) in
    turn into one accumulator from zero, cw added at the end in f32, as
    the kernel does (one part); carried=True: the accumulator starts at
    cw (the design the kernel's parts replaced)."""
    Z = np.concatenate([X * X, X], 1).astype(np.float32)
    ks = -(-Z.shape[1] // 8)
    Z = np.pad(Z, ((0, 0), (0, 8 * ks - Z.shape[1])))
    B = np.pad(op, ((0, 8 * ks - op.shape[0]), (0, 0)))
    Zh, Bh = _tf32(Z), _tf32(B)
    split = {"lo.hi": (_tf32(Z - Zh), Bh), "hi.lo": (Zh, _tf32(B - Bh)),
             "hi.hi": (Zh, Bh)}
    split = {k: (torch.from_numpy(a), torch.from_numpy(b))
             for k, (a, b) in split.items()}
    cwt = torch.from_numpy(cw).expand(len(Z), len(cw))
    acc = cwt.clone() if carried else torch.zeros_like(cwt)
    for k in range(ks):
        sl = slice(8 * k, 8 * k + 8)
        for name in terms:
            a, b = split[name]
            acc = _tensor_core_add(acc, a[:, sl], b[sl])
    return (acc if carried else acc + cwt).numpy()


def _k2_avg(logp, mask, S):
    """The floored logsumexp over each speaker's components and the masked
    mean, float64: [B, S] of logp [B * T, S*K], mask [B, T]."""
    B, T = mask.shape
    lp = logp.astype(np.float64).reshape(B, T, S, -1)
    m = lp.max(-1)
    lse = m + np.log(np.exp(lp - m[..., None]).sum(-1))
    lse = np.where(lse > -745.0, lse, np.log(1e-15))
    w = mask.astype(np.float64)
    return (lse * w[..., None]).sum(1) / np.maximum(w.sum(1), 1.0)[:, None]


@pytest.mark.parametrize("config", ["tel8k-gmm32-s80", "wb48k-gmm32-s4"])
def test_tf32_split_bank_scores_hold_the_limit(config):
    """The batched scoring of csrc/gmm_score.cu's tensor route modelled on
    the tensor cores' adder (_k2_logp: both operands split as hi = tf32(x),
    lo = tf32(x - hi), per 8-deep k-step lo.hi, hi.lo, hi.hi into one
    accumulator from zero, each mma.sync aligning and cutting its terms as
    the card does, cw added in f32 at the end), then the floored logsumexp
    and the masked mean in float64 (the card's f32 mean adds ~1.5e-5 to
    every route, the FP32 one too): each benchmark configuration's
    bank (80 x 32 or 4 x 32, d = 38, drawn as its file's `bank` says)
    against the CMVN'd features of two synthetic voices at the
    configuration's rate (their own extractor's features: MFCC 15 of 55
    filters + LPC 23), with a frame 4 from every mean in each dimension
    (terms of O(100-1000) that cancel) and one 40 away (under the -745
    floor), a third utterance half masked. Held to the float64 average
    log-likelihoods of the same f32 operands within 1e-3 (the benchmark
    cells' score_err limit), within chip_smoke.py's SCORE_RTOL (the card's
    K2 against its plain version) and within its TENSOR_F64_ATOL (the
    card's tensor route against float64); one TF32 term (hi.hi) must lie
    at least TENSOR_APART of those gates away, and the three terms in
    accumulators started at cw (an earlier design: the adder then cuts
    every product at the ulp of a sum of O(50-200)) several times further
    than from zero. Prints all three distances."""
    import json
    import os
    import re

    from perfbench.harness import feature_config
    from speaker_recognition_tpu_torch.models.gmm import GmmBank
    from speaker_recognition_tpu_torch.testdata import synth

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "perfbench", "configs",
                           config + ".json")) as f:
        c = json.load(f)
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    score_rtol, f64_atol, apart = (
        float(re.search(rf"^{name} = (\S+)$", src, re.M)[1])
        for name in ("SCORE_RTOL", "TENSOR_F64_ATOL", "TENSOR_APART"))
    b = c["bank"]
    S, K, d = b["speakers"], b["components"], b["dim"]
    rng = np.random.RandomState(K + S)
    w = np.exp(rng.randn(S, K))
    bank = GmmBank.from_numpy(
        (w / w.sum(-1, keepdims=True)).astype(np.float32),
        (rng.randn(S, K, d) * b["means_std"]).astype(np.float32),
        (b["sigma_min"] + (b["sigma_max"] - b["sigma_min"])
         * rng.rand(S, K, d)).astype(np.float32), "cpu")
    fs = c["fs"]
    sig = np.stack([synth.synth_utterance(who, 1.0, 3, fs)
                    for who in ("alice", "bob", "carol")]).astype(np.float32)
    X, mask = text.extract_batch(torch.from_numpy(sig),
                                 torch.full((3,), sig.shape[1]), fs,
                                 feature_config(c["features"]))
    X, mask = X.numpy().copy(), mask.numpy().copy()
    assert X.shape[-1] == d and mask.all()
    X[0, 5] = 4.0 + bank.op[d:].T.reshape(S, K, d).numpy().max()
    X[1, 7] = 40.0
    mask[2, mask.shape[1] // 2:] = False
    op, cw = bank.op.numpy(), bank.cw.numpy()
    flat = X.reshape(-1, d)
    exact = _k2_avg(flat.astype(np.float64) ** 2 @ op[:d].astype(np.float64)
                    + flat.astype(np.float64) @ op[d:].astype(np.float64)
                    + cw.astype(np.float64), mask, S)
    logp = _k2_logp(flat, op, cw, ("lo.hi", "hi.lo", "hi.hi"))
    assert (logp.reshape(len(X), -1, S * K)[1, 7] < -745.0).all()
    got = _k2_avg(logp, mask, S)
    one = _k2_avg(_k2_logp(flat, op, cw, ("hi.hi",)), mask, S)
    carried = _k2_avg(_k2_logp(flat, op, cw, ("lo.hi", "hi.lo", "hi.hi"),
                               carried=True), mask, S)
    err, err_one, err_carried = (np.abs(v - exact).max()
                                 for v in (got, one, carried))
    print(f"{config}: 3xTF32 against float64 {err:.2e}, carried from cw "
          f"{err_carried:.2e}, one TF32 term (hi.hi) {err_one:.2e} (limits "
          f"1e-3, {f64_atol:g})")
    assert np.isfinite(got).all()
    assert err <= min(1e-3, f64_atol)
    np.testing.assert_allclose(got, exact, rtol=score_rtol, atol=0)
    assert err_one >= apart * f64_atol
    assert err_carried > 4 * err


def _voice_factor():
    """chip_smoke.py's VOICE_FACTOR (phase 20's rule on the voice)."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    with open(path) as f:
        return float(re.search(r"^VOICE_FACTOR = (\S+)$", f.read(), re.M)[1])


def _k1_features(fe, sums):
    """(cepstra, LPC cepstra) of [frames, nmel + nac] sums at K1's
    operator, in float64: log(max(mel, floor)) . dct, and lpc_columns
    with n_lpcc = 16 (float64 Levinson and recursion, r = 0 below the
    least normal float)."""
    s = torch.from_numpy(np.asarray(sums, np.float64))
    nmel = fe.dct.shape[0]
    ceps = torch.log(torch.clamp_min(s[:, :nmel], fe.floor)) @ fe.dct.double()
    return ceps.numpy(), gpu_frontend.lpc_columns(s[:, nmel:], 16).numpy()


@pytest.mark.parametrize("fs", [8000, 16000], ids=["n512", "n1024"])
def test_tf32_split_holds_the_gates_at_k1s_operator(fs):
    """K1's LPC-cepstra kernel (csrc/frontend_lpcc_signals.cu) modelled in
    numpy: K1's bin-domain operator [M | R] (PackedFrontend with n_lpcc =
    16: N = 512 at 8 kHz, 1024 at 16 kHz), whose mel part M = H . mel has
    negative weights, and the unfloored power rows (K1 floors the mel sums
    only); the three TF32 products of the split per 8-bin k-step added to
    f32 sums, as the 48 kHz model above. Against the float64 sums of the
    same f32 operands:
      * int16-scale white noise (the frames chip_smoke.py holds the kernel
        on): cepstra within MFCC_ATOL, no LPC cepstrum past LPC_ATOL and
        LPC_RTOL;
      * at 8 kHz, phase 20's voice, the frames tests/test_torch_voice_lpc.py
        reads (its first MAX_UTT_ROWS rows), with a silent stretch: the
        near-singular frames part every f32 route from float64 (mel sums
        that cancel to 1e-7 of their terms, LPC of poles at radius 0.97),
        so phase 20's rule holds instead: the cepstra's max |d| and the
        frames whose LPC cepstra part past the bounds at most VOICE_FACTOR
        times the farther of the two f32 plain versions' (the FFT route's
        f32 product, the dense route's D, W, A); the silent frames' lag 0
        exactly 0, so their LPC cepstra are 0.
    Prints how far one TF32 term (hi.hi) would land."""
    from speaker_recognition_tpu_torch.ops import framing as tframing
    from speaker_recognition_tpu_torch.testdata import synth

    mfcc_atol, lpc_atol, lpc_rtol = _chip_gates()
    fe = text.PackedFrontend(fs, tcfg.FeatureConfig(
        lpc=tcfg.LpcConfig(n_lpcc=16)), "cpu")
    N, nb = fe.n_fft, fe.n_fft // 2 + 1
    assert N == {8000: 512, 16000: 1024}[fs]
    nmel = fe.dct.shape[0]
    op = torch.cat([fe.fft_mel[:nb], fe.fft_acorr[:nb]], 1).numpy()
    assert (op[:, :nmel] < 0).any()

    def power(sig):
        frames = tframing.frame_signal(torch.from_numpy(sig), fe.frame_len,
                                       fe.frame_shift)
        wp = tframing.window_preemph(frames.double(), fe.frame_len,
                                     fe.pre_emph, fe.preemph_first)
        return frames, (np.abs(np.fft.rfft(wp.numpy(), N)) ** 2).astype(
            np.float32)

    def parted(got, want):
        """(cepstra max |d|, frames whose LPC cepstra part past the
        bounds)."""
        d = np.abs(got[1] - want[1])
        bad = (d > lpc_atol) & (d > lpc_rtol * np.abs(want[1]))
        return float(np.abs(got[0] - want[0]).max()), int(bad.any(-1).sum())

    rng = np.random.RandomState(fs)
    noise = (rng.randn(fs * 4) * 3000).astype(np.float32)
    _, P = power(noise)
    terms = _split_terms(P, op)
    want = _k1_features(fe, P.astype(np.float64) @ op.astype(np.float64))
    got = _k1_features(fe, _mma_sums(terms, nb, op.shape[1]))
    d_ceps, bad = parted(got, want)
    one = parted(_k1_features(fe, _mma_sums(terms[2:], nb, op.shape[1])),
                 want)
    print(f"K1's operator at {fs} Hz, white noise ({len(P)} frames), "
          f"3xTF32 against float64: cepstra {d_ceps:.2e}, LPC cepstra "
          f"frames past the bounds {bad}; one term: {one}")
    assert d_ceps <= mfcc_atol and bad == 0
    if fs != 8000:
        return

    sig = synth.voice_utterance(synth.voices(1, seed=2000)[0], 60.0, 2001)
    sig = sig[:pallas_frontend.MAX_UTT_ROWS * fe.frame_shift].astype(
        np.float32)
    sig[8000:8000 + 6 * fe.frame_len] = 0.0
    frames, P = power(sig)
    silent = (P == 0).all(-1)
    assert 4 <= silent.sum() < len(P) // 100
    terms = _split_terms(P, op)
    split = _mma_sums(terms, nb, op.shape[1])
    want = _k1_features(fe, P.astype(np.float64) @ op.astype(np.float64))
    Y = (frames @ fe.D) ** 2
    plain = {
        "FFT route f32": torch.from_numpy(P) @ torch.from_numpy(op),
        "dense f32": torch.cat([Y @ fe.W, Y @ fe.A], 1)}
    far = [0.0, 0]
    for name, sums in plain.items():
        p = parted(_k1_features(fe, sums.numpy()), want)
        far = [max(far[0], p[0]), max(far[1], p[1])]
        print(f"K1's operator, phase 20's voice ({len(P)} frames), {name} "
              f"against float64: cepstra {p[0]:.2e}, LPC cepstra frames "
              f"past the bounds {p[1]}")
    got = parted(_k1_features(fe, split), want)
    one = parted(_k1_features(fe, _mma_sums(terms[2:], nb, op.shape[1])),
                 want)
    print(f"K1's operator, phase 20's voice, 3xTF32 against float64: "
          f"cepstra {got[0]:.2e}, LPC cepstra frames past the bounds "
          f"{got[1]}; one term: {one}")
    factor = _voice_factor()
    assert got[0] <= factor * far[0] and got[1] <= factor * far[1]
    assert far[1] >= 0.1 * len(P)  # the voice parts every f32 route
    assert (split[silent, nmel] == 0).all()
    assert (gpu_frontend.lpc_columns(torch.from_numpy(split[silent, nmel:]),
                                     16) == 0).all()
