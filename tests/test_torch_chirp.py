"""K5 at an fft_size that is not a power of two on the chirp-z route
(ops/gpu_frontend.mfcc_from_frames, csrc/frontend_chirp.cu on the card)
and the four-step route's packed operator (csrc/rfft_big.cuh's fused
power + projection pass). The chirp-z route's plain version
(mfcc_from_frames_chirp_reference: the same host tables and torch.fft.fft
at M points), the FFT route's and the port's dense plain versions against
the JAX package's pallas_frontend.mfcc_from_frames in interpret mode and
its XLA extractor, on the same numpy inputs: 8 kHz with fft_size 1500 and
216 outputs, 44.1 kHz with fft_size 1411 (the frame), a folded 48 kHz
frame (fft_size 1000 < 1536), a prime fft_size (1009), M at the tile
kernel's reach (8192) and past it on the cluster (16384: fft_size 15874
and 16000; 32768: fft_size 33000, csrc/frontend_chirp_cluster.cu) and on
the device-memory passes (262144: fft_size 261634). Also the tables
against float64, which counter each shape's launch moves on the card (a
stand-in library records the C calls; the four-step route's
device-memory passes past 262144 points and the chirp's past M =
131072), and the shapes of the chirp-z and four-step operators and shared
memory (models of the C functions)."""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.ops import frontend as joperators  # noqa: E402
from speaker_recognition_tpu.ops import levinson as jlevinson  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402

FLOOR = 1e-35

CASES = {  # id: (fs, fft_size, mel filters, frames; M, route on the card)
    "8k_1500_216": (8000, 1500, 200, 40, 1024, "chirp"),
    "44k_1411": (44100, 1411, 26, 24, 4096, "chirp"),
    "48k_1000_folded": (48000, 1000, 26, 24, 2048, "chirp"),
    "16k_prime_1009": (16000, 1009, 26, 24, 1024, "chirp"),
    "8k_reach_15872": (8000, 15872, 26, 8, 8192, "chirp"),
    "8k_past_15874": (8000, 15874, 26, 8, 16384, "chirp"),
    "8k_16000": (8000, 16000, 26, 8, 16384, "chirp"),
    "8k_33000": (8000, 33000, 26, 8, 32768, "chirp"),
}
# a shape past the cluster's reach (M = 262144): the chirp-z route on the
# device-memory passes
PAST_CLUSTER = (8000, 261634, 26, 4, 262144, "chirp")


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)


def _operators(fs, fft, nfilt):
    """The JAX extractor's full-route operators (features/extract.py): mel,
    dct, acorr of LPC order 15, C and S, in float64 numpy."""
    flen, _ = tcfg.frame_geometry(fs, 32.0, 16.0)
    mel = joperators.mel_filterbank(fs, fft, nfilt).T
    dct = joperators.dct_matrix(nfilt)[1:14].T
    acorr = jlevinson.autocorr_operator(flen, fft, 15)
    C, S = joperators.dft_power_projection(flen, fft)
    return flen, mel, dct, acorr, C, S


def _frames(n, flen, seed=2):
    wp = (np.random.RandomState(seed).randn(n, flen) * 1000).astype(
        np.float32)
    wp[3] = 0.0  # a silent frame: every bin on the floor
    return wp


def test_chirp_size_and_reach():
    """M is the least power of two, at least 1024, that holds the linear
    convolution of L = min(flen, N) and L + N/2 terms; 0 for a power of
    two and past 2^23 (the dense template's shapes): the tile kernel up to
    8192, the cluster from 16384 (fft_size 15874 and 16000 at 8 kHz, 14000
    at 48 kHz) to 131072 (8 blocks of 16384 points), the device-memory
    passes from 262144 (fft_size 261634 at 8 kHz) to 2^23."""
    size = gpu_frontend.chirp_size
    assert [size(n, f) for n, f in ((1500, 256), (1411, 1411), (1000, 1536),
                                    (1009, 512), (400, 400), (15872, 256),
                                    (15874, 256), (14000, 1536), (4096, 1536),
                                    (1, 10), (16000, 256), (33000, 256),
                                    (261630, 256), (261634, 256),
                                    (260000, 1536), (16776000, 256),
                                    (16777214, 256), (16777218, 1))] == [
        1024, 4096, 2048, 1024, 1024, 8192, 16384, 16384, 0, 0, 16384,
        32768, 131072, 262144, 262144, 1 << 23, 0, 0]
    assert gpu_frontend.CHIRP_CLUSTER_M == 8 * gpu_frontend.CLUSTER_BLOCK
    assert gpu_frontend.CHIRP_MAX_M == 1 << 23
    for fs, fft, _, _, M, _ in [*CASES.values(), PAST_CLUSTER]:
        flen, _ = tcfg.frame_geometry(fs, 32.0, 16.0)
        assert size(fft, flen) == M


@pytest.mark.parametrize("n_fft,flen", [(1500, 256), (1411, 1411),
                                        (1000, 1536), (1009, 512),
                                        (15872, 256)],
                         ids=["1500", "1411", "1000_folded", "1009",
                              "15872"])
def test_chirp_tables_against_float64(n_fft, flen):
    """The f32 tables differ from float64 by their rounding alone: c (unit
    complex numbers) within 2^-24 per part, and Bh within 2^-24 of its
    largest value, where the float64 reference takes exp(-pi i j^2 / N)
    with j^2 unreduced (exact below 2^53) and a direct DFT of b (its
    exponents k m mod M in integers) for Bh, not the FFT.
    In float64 the tables' convolution is the DFT: |X_k| from them equals
    np.fft.rfft's to 1e-12 of the largest."""
    c, bh = (torch.view_as_complex(x).numpy()
             for x in gpu_frontend.chirp_tables(n_fft, flen))
    L, nb, M = min(flen, n_fft), n_fft // 2 + 1, bh.shape[0]
    assert c.shape == (L,) and M == gpu_frontend.chirp_size(n_fft, flen)
    j = np.arange(max(L, nb), dtype=np.float64)
    c64 = np.exp(-1j * np.pi * (j * j) / n_fft)
    assert np.abs(c.real - c64[:L].real).max() <= 2.0 ** -24
    assert np.abs(c.imag - c64[:L].imag).max() <= 2.0 ** -24
    b = np.zeros(M, np.complex128)
    b[:nb] = np.conj(c64[:nb])
    b[M - L + 1:] = np.conj(c64[1:L])[::-1]
    m = np.arange(M, dtype=np.int64)
    bh64 = np.concatenate([  # a direct DFT, k m mod M in integers
        np.exp(-2j * np.pi * (np.outer(k, m) % M) / M) @ b
        for k in np.split(m, max(1, M // 512))]) / M
    scale = np.abs(bh64).max()
    assert np.abs(bh.real - bh64.real).max() <= 2.0 ** -24 * scale
    assert np.abs(bh.imag - bh64.imag).max() <= 2.0 ** -24 * scale
    x = np.random.RandomState(n_fft).randn(L)
    y = np.fft.fft(np.conj(np.fft.fft(x * c64[:L], n=M) * bh64))[:nb]
    want = np.abs(np.fft.rfft(x, n=n_fft))
    assert np.abs(np.abs(y) - want).max() <= 1e-12 * want.max()


@pytest.mark.parametrize("case", list(CASES))
def test_chirp_reference_matches_pallas_and_the_plain_routes(case):
    """The chirp-z route's plain version (f32: the host tables, cuFFT's or
    pocketfft's FFT at M points) vs pallas_frontend.mfcc_from_frames
    (interpret; the dense C, S, which alias columns where the frame is
    longer than N) and the port's dense and FFT-route plain versions, on
    the same frames. Tolerances of tests/test_torch_fft.py's K5 cases
    (~1e-6 relative on the power, carried to ~1e-5 on pre-CMVN cepstra of
    O(10-100); the raw autocorrelation to 1e-4 of its largest value); the
    two FFT-based plain versions agree on the power to 2e-6 of its
    largest. Past the route's reach the chirp-z tables refuse."""
    fs, fft, nfilt, n, M, route = CASES[case]
    flen, mel, dct, acorr, C, S = _operators(fs, fft, nfilt)
    wp = _frames(n, flen)
    args = (_t(mel), _t(dct), FLOOR, _t(acorr))
    fftp = gpu_frontend.mfcc_from_frames_fft_reference(_t(wp), *args, fft)
    dense = gpu_frontend.mfcc_from_frames_reference(_t(wp), _t(C), _t(S),
                                                    *args)
    wc, wr = (np.asarray(x) for x in pallas_frontend.mfcc_from_frames(
        jnp.asarray(wp), C, S, mel, dct, FLOOR, acorr_t=acorr,
        interpret=True))
    outs = {"fft": fftp, "dense": dense}
    if route == "chirp":
        outs["chirp"] = gpu_frontend.mfcc_from_frames_chirp_reference(
            _t(wp), *args, fft)
        p_chirp = gpu_frontend._chirp_power(_t(wp), fft)
        p_fft = gpu_frontend._power(_t(wp), fft)
        assert p_chirp.shape == (n, fft // 2 + 1)
        assert ((p_chirp - p_fft).abs().max() <= 2e-6 * p_fft.max())
    else:
        with pytest.raises(ValueError, match="no chirp-z route"):
            gpu_frontend.mfcc_from_frames_chirp_reference(_t(wp), *args, fft)
    for name, (ceps, r) in outs.items():
        assert ceps.dtype == torch.float32 and ceps.shape == (n, 13), name
        np.testing.assert_allclose(ceps.numpy(), wc, rtol=1e-4, atol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(r.numpy(), wr, rtol=1e-4,
                                   atol=1e-4 * np.abs(wr).max(),
                                   err_msg=name)


def _chirp_route(monkeypatch):
    """Serve the full frontend through the routes the card takes: the
    chirp-z plain version where chirp_size is not 0, the dense one past
    it."""
    def full(wp, C, S, mel, dct, floor, acorr, n_fft=None):
        assert n_fft & (n_fft - 1)
        if gpu_frontend.chirp_size(n_fft, wp.shape[-1]):
            return gpu_frontend.mfcc_from_frames_chirp_reference(
                wp, mel, dct, floor, acorr, n_fft)
        return gpu_frontend.mfcc_from_frames_reference(
            wp, C, S, mel, dct, floor, acorr)
    monkeypatch.setattr(gpu_frontend, "mfcc_from_frames", full)


@pytest.mark.parametrize("case", ["8k_1500_216", "44k_1411",
                                  "48k_1000_folded", "16k_prime_1009",
                                  "8k_16000", "past_cluster"])
def test_extract_batch_on_the_chirp_route_matches_jax(case, monkeypatch):
    """extract_batch on the full route (SRTPU_FRONTEND=full) through the
    chirp-z plain version vs the JAX XLA extractor (f32) on the same
    route, ragged lengths with an empty utterance, CMVN'd MFCC + LPC; the
    bound of tests/test_torch_fft.py's extract_batch cases (two f32
    frontends of different arithmetic). past_cluster: fft_size 261634 at 8
    kHz, M = 262144, the passes' shape."""
    fs, fft, nfilt, _, M, _ = (PAST_CLUSTER if case == "past_cluster"
                               else CASES[case])
    assert gpu_frontend.chirp_size(fft, tcfg.frame_geometry(
        fs, 32.0, 16.0)[0]) == M
    monkeypatch.setenv("SRTPU_FRONTEND", "full")
    _chirp_route(monkeypatch)

    def cfg(c):
        return c.FeatureConfig(mfcc=c.MfccConfig(fft_size=fft,
                                                 n_filters=nfilt))
    L = 4096 * (-(-fs // 8192))
    rng = np.random.RandomState(5)
    lens = np.asarray([L, int(0.6 * L), L // 3, 0], np.int32)
    sig = np.zeros((4, L), np.float32)
    for i, k in enumerate(lens):
        sig[i, :k] = (rng.randn(k) * 3000).astype(np.float32)
    want, wmask = jext._feature_fn(fs, cfg(jcfg), L, "float32", "off",
                                   "f32", "full", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    fe = text.frontend(fs, cfg(tcfg), "cpu")
    assert isinstance(fe, text.FullFrontend) and fe.n_fft == fft
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, cfg(tcfg))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return t.as_subclass(_CudaTyped)


def _ck_chirp(opl):
    return 8 if opl > 32 else 16


def _ck_big(opl):
    return 64 if opl <= 16 else 32 if opl <= 32 else 16


def _opl(nout):
    return 9 if nout <= 72 else 16 if nout <= 128 else 32 if nout <= 256 \
        else 64


class _Lib:
    """A stand-in for the kernels' library: the shape functions of csrc/
    frontend_chirp.cu and csrc/frontend_fft.cu in Python, and the entry
    points recorded."""

    def __init__(self):
        self.calls = {}

    def srt_chirp_operator_shape(self, n_fft, flen, nout, rows, cols,
                                 chunks):
        M = gpu_frontend.chirp_size(n_fft, flen)
        if M == 0 or nout < 1:
            return -1
        # either chunk of the tile kernel, or the fused pass's past it
        opl = _opl(nout)
        ck = 2 * _ck_chirp(opl) if M <= 8192 else _ck_big(opl)
        chunks._obj.value = max(1, -(-nout // 512))
        rows._obj.value = (-(-(n_fft // 2 + 1) // ck) * ck
                           * chunks._obj.value)
        cols._obj.value = 8 * opl
        return 0

    def srt_big_operator_shape(self, n_fft, nout, rows, cols, chunks):
        if n_fft < 32768 or n_fft > 1 << 24 or n_fft & (n_fft - 1):
            return -1
        opl, ck = _opl(nout), _ck_big(_opl(nout))
        chunks._obj.value = max(1, -(-nout // 512))
        rows._obj.value = (-(-(n_fft // 2 + 1) // ck) * ck
                           * chunks._obj.value)
        cols._obj.value = 8 * opl
        return 0

    def srt_fft_operator_shape(self, n_fft, nout, rows, cols, chunks):
        chunks._obj.value = max(1, -(-nout // 512))
        rows._obj.value = (-(-(n_fft // 2 + 1) // 16) * 16
                           * chunks._obj.value)
        cols._obj.value = 8 * _opl(nout)
        return 0

    def srt_fft_wide_floats(self, nframes, nout):
        return nframes * 512 * -(-nout // 512) if nout > 512 else 0

    def srt_frames_scratch_floats(self, n, nout):
        return 0

    def srt_big_scratch_floats(self, n_fft, nout, chunk):
        return chunk * (n_fft + nout)

    def srt_chirp_scratch_floats(self, n_fft, flen, nout, chunk):
        if gpu_frontend.chirp_size(n_fft, flen) <= 8192:
            return -1
        return chunk * ((n_fft // 2 + 4) // 4 * 4 + nout)

    def __getattr__(self, name):  # the kernels' entry points
        if not name.startswith("srt_"):
            raise AttributeError(name)

        def call(*args):
            self.calls[name] = args
            return 0
        return call


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
    tables = gpu_frontend.chirp_tables
    monkeypatch.setattr(gpu_frontend, "chirp_tables",
                        lambda n, flen, device="cpu": tables(n, flen))
    return lib


COUNTERS = ("FULL_LAUNCHES", "FULL_CHIRP_LAUNCHES", "FULL_DENSE_LAUNCHES",
            "FULL_BIG_LAUNCHES", "CHUNKED_LAUNCHES", "BIG_PASSES_LAUNCHES")


@pytest.mark.parametrize("case,entry", [
    ("8k_1500_216", "srt_chirp_frames_frontend"),
    ("44k_1411", "srt_chirp_frames_frontend"),
    ("48k_1000_folded", "srt_chirp_frames_frontend"),
    ("16k_prime_1009", "srt_chirp_frames_frontend"),
    ("8k_reach_15872", "srt_chirp_frames_frontend"),
    ("8k_past_15874", "srt_chirp_cluster_frontend"),
    ("8k_16000", "srt_chirp_cluster_frontend"),
    ("8k_33000", "srt_chirp_cluster_frontend"),
    ("past_cluster", "srt_chirp_cluster_frontend"),
], ids=["1500", "1411", "1000_folded", "1009", "reach", "past_reach",
        "16000", "33000", "past_cluster_reach"])
def test_the_card_route_and_its_counter(stand_in, case, entry):
    """On a CUDA tensor mfcc_from_frames takes the chirp-z route where M
    <= 2^23 (FULL_CHIRP_LAUNCHES, the tables c [L] and Bh [M] and the
    packed operator passed): the tile kernel up to M = 8192, past it
    csrc/frontend_chirp_cluster.cu with a scratch in chunks of frames, on
    the cluster up to 131072 (fft_size 15874, 16000 and 33000 at 8 kHz; Bh
    in the cluster's decimated order), on the device-memory passes past it
    (fft_size 261634, M = 262144; Bh as [M1][M2], and BIG_PASSES_LAUNCHES
    moves too); exactly the route's counters move, and FullFrontend builds
    C and S on the card only for the dense route (tests/test_torch_fft.py
    holds a shape past 2^23)."""
    fs, fft, nfilt, n, M, route = (PAST_CLUSTER if case == "past_cluster"
                                   else CASES[case])
    cfg = tcfg.FeatureConfig(mfcc=tcfg.MfccConfig(fft_size=fft,
                                                  n_filters=nfilt))
    fe = text.FullFrontend(fs, cfg, "meta")
    assert (fe.C is not None) == (route == "dense")
    cpu = text.FullFrontend(fs, cfg, "cpu")
    wp = _cuda(_t(_frames(n, cpu.frame_len)))
    C, S = ((None, None) if route == "chirp" else (_cuda(cpu.C),
                                                   _cuda(cpu.S)))
    before = {k: getattr(gpu_frontend, k) for k in COUNTERS}
    ceps, r = gpu_frontend.mfcc_from_frames(
        wp, C, S, _cuda(cpu.mel), _cuda(cpu.dct), cpu.floor,
        _cuda(cpu.acorr), fft)
    moved = {k: getattr(gpu_frontend, k) - v for k, v in before.items()}
    assert ceps.shape == (n, 13) and r.shape == (n, 16)
    want = {"FULL_CHIRP_LAUNCHES"} if route == "chirp" else \
        {"FULL_DENSE_LAUNCHES"}
    if M > gpu_frontend.CHIRP_CLUSTER_M:
        want.add("BIG_PASSES_LAUNCHES")
    assert moved == {k: int(k in want) for k in COUNTERS}
    assert list(stand_in.calls) == [entry]
    args = stand_in.calls[entry]
    if route == "chirp":
        # frames, cz, bh, op, dct, ceps, r, wsums | scratch, n, flen, nfft,
        # ...
        assert args[8:14] == (n, cpu.frame_len, fft, nfilt, 16, 13)
        cz, bh = gpu_frontend.chirp_tables(fft, cpu.frame_len)
        assert cz.shape == (min(cpu.frame_len, fft), 2)
        assert bh.shape == (M, 2)
        if M <= 8192:
            assert args[7] == 0  # no sums rows up to 512 outputs
            return
        dec = gpu_frontend.chirp_cluster_bh(fft, cpu.frame_len)
        if M <= gpu_frontend.CHIRP_CLUSTER_M:
            # the decimated Bh [m2][m1] = Bh[C m1 + m2]; a chunk
            C = M // gpu_frontend.CLUSTER_BLOCK
            assert dec.shape == (C, gpu_frontend.CLUSTER_BLOCK, 2)
            assert torch.equal(dec[1 % C, 5], bh[C * 5 + 1 % C])
            assert args[7] != 0 and args[15] == n
        else:  # Bh as [M1][M2]: Bh[k1 + M1 k2] at [k1][k2]; a chunk
            M1, M2 = gpu_frontend.passes_shape(M)
            assert dec.shape == (M1, M2, 2)
            assert torch.equal(dec[5, 3], bh[5 + M1 * 3])
            assert args[7] != 0 and args[15] == n


@pytest.mark.parametrize("n_fft,passes", [(32768, 0), (262144, 0),
                                          (524288, 1)],
                         ids=["32768", "262144_cluster_reach",
                              "524288_past_the_cluster"])
def test_the_four_step_routes_and_their_counters(stand_in, n_fft, passes):
    """On a CUDA tensor mfcc_from_frames at a power of two from 32768 takes
    the four-step route (srt_big_fft_frames, FULL_BIG_LAUNCHES): a frame's
    spectrum on a block or a cluster up to CLUSTER_MAX_N = 262144 points,
    past it the device-memory passes, which BIG_PASSES_LAUNCHES counts as
    well; no other counter moves."""
    nb = n_fft // 2 + 1
    rng = np.random.RandomState(n_fft % 97)
    mel, acorr = (_t(rng.rand(nb + 3, k)) for k in (26, 16))
    dct = _t(rng.randn(26, 13))
    wp = _cuda(_t(_frames(4, 1536)))
    assert gpu_frontend.CLUSTER_MAX_N == 262144
    before = {k: getattr(gpu_frontend, k) for k in COUNTERS}
    ceps, r = gpu_frontend.mfcc_from_frames(
        wp, None, None, _cuda(mel), _cuda(dct), FLOOR, _cuda(acorr), n_fft)
    moved = {k: getattr(gpu_frontend, k) - v for k, v in before.items()}
    assert ceps.shape == (4, 13) and r.shape == (4, 16)
    assert moved == {k: {"FULL_BIG_LAUNCHES": 1,
                         "BIG_PASSES_LAUNCHES": passes}.get(k, 0)
                     for k in COUNTERS}
    assert list(stand_in.calls) == ["srt_big_fft_frames"]
    assert stand_in.calls["srt_big_fft_frames"][8] == n_fft


@pytest.mark.parametrize("n_fft,nmel,nac,shape", [
    (32768, 50, 16, (16448, 72)),
    (32768, 128, 16, (16416, 256)),
    (65536, 26, 16, (32832, 72)),
    (65536, 100, 16, (32832, 128)),
    (65536, 250, 16, (32784, 512)),
    (32768, 600, 16, (2 * 16400, 512)),
], ids=["32768", "32768_144_outputs", "65536", "65536_116_outputs",
        "65536_266_outputs", "32768_616_outputs"])
def test_big_operator_shape(n_fft, nmel, nac, shape):
    """The four-step route's own operator (srt_big_operator_shape, beside
    the tile's, which refuses N >= 32768: tests/test_torch_limits.py):
    [mel | acorr | 0] on rows 0..N/2, zero rows to the fused pass's chunk
    of bins (64 up to 128 columns, 32 at 256, 16 at 512), one 512-column
    operator per chunk of outputs past 512."""
    lib = _Lib()
    nb = n_fft // 2 + 1
    mel = torch.rand(nb + 3, nmel, dtype=torch.float32)
    acorr = torch.rand(nb + 3, nac, dtype=torch.float32)
    op = gpu_frontend._big_operator(lib, mel, acorr, n_fft)
    assert tuple(op.shape) == shape
    R = op.shape[0] // max(1, -(-(nmel + nac) // 512))
    full = torch.cat([mel[:nb], acorr[:nb]], dim=1)
    assert torch.equal(op[:nb, :min(512, nmel + nac)], full[:, :512])
    assert (op[nb:R] == 0).all()
    if nmel + nac > 512:
        assert torch.equal(op[R:R + nb, :nmel + nac - 512], full[:, 512:])
    with pytest.raises(ValueError, match="four-step"):
        gpu_frontend._big_operator(lib, mel, acorr, 16384)


def _chirp_smem(M, opl, nb):
    """csrc/frontend_chirp.cu smem_floats in bytes."""
    warps = {1024: 8, 2048: 4, 4096: 2, 8192: 1}[M]
    ft = {1024: 32, 2048: 16, 4096: 4, 8192: 2}[M]
    nbuf = 2 if M >= 4096 else 1
    tw = 16 + (M if M <= 2048 else M // 32) - 32
    ys = max(nb | 1, 8 * opl)
    return 4 * (_ck_chirp(opl) * 8 * opl + 2 * warps * nbuf * (M + 32)
                + 2 * tw + ft * ys)


def test_shared_memory_of_both_routes_fits():
    """Every shape the chirp-z kernel takes fits a block's 227 KB: at each
    M the most bins its convolution leaves room for (nb <= M) at every
    operator width (the widest 230,336 bytes, M = 2048), with the narrow
    operator chunk; the wide one (twice the bins) fits at the bench's nb
    of 751 (M = 1024) and 501 (48 kHz, fft_size 1000: M = 2048); the
    four-step route's fused pass takes at most 49 KB (the power rows in
    stages of 512 bins of 8 frames beside a chunk of 16 x 512 operator
    rows); a block of the cluster FFT (csrc/rfft_cluster.cuh: 16384
    complex values with a float2 of padding after every 16, and the
    two-level twiddle table of W_M) takes at most 145,408 bytes, at M =
    131072 (8 blocks), one block an SM; a block of the device-memory
    passes (csrc/rfft_passes.cuh: the same values with 32 more float2 of
    padding, and the table of W_T) at most 188,672 bytes, at T = 2^23."""
    worst = max(_chirp_smem(M, opl, M) for M in (1024, 2048, 4096, 8192)
                for opl in (9, 16, 32, 64))
    assert worst == _chirp_smem(2048, 64, 2048) == 230336
    assert worst <= 232448
    for M, nb in ((1024, 751), (2048, 501)):
        wide = _chirp_smem(M, 32, nb) + 4 * _ck_chirp(32) * 8 * 32
        assert wide <= 232448, (M, nb, wide)
    rows = max(4 * (_ck_big(opl) * 8 * opl + 8 * (512 + 1))
               for opl in (9, 16, 32, 64))
    assert rows == 4 * (16 * 512 + 8 * 513) == 49184

    def cluster(lgm, pad=0):  # srt_cluster / passes::smem_bytes
        lgb = (lgm + 1) // 2
        return 8 * (16384 + 16384 // 16 + pad + (1 << lgb)
                    + (1 << (lgm - lgb)))
    sizes = [cluster(lgm) for lgm in range(14, 18)]  # M = 16384 .. 131072
    assert max(sizes) == cluster(17) == 145408 <= 232448 < 2 * cluster(14)
    passes = [cluster(lgt, 32) for lgt in range(18, 24)]
    assert max(passes) == cluster(23, 32) == 188672 <= 232448
