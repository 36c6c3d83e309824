"""The FFT route of speaker_recognition_tpu_torch's frontend kernels K1
(ops/gpu_frontend.packed_from_signals, csrc/frontend.cu) and K5
(mfcc_from_frames, csrc/frontend_fft.cu): the bin-domain operators of
ops/frontend.fft_packed_operators in float64, and the FFT route's plain
torch versions against the JAX package's Pallas kernels in interpret mode
and against its XLA extractor, on the same numpy inputs."""

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
from speaker_recognition_tpu_torch.ops import frontend as operators  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402

FLOOR = 1e-35


def _geometry(fs):
    return tcfg.frame_geometry(fs, 32.0, 16.0)


def test_rfft_size():
    assert [operators.rfft_size(F) for F in (256, 352, 512, 705, 1024)] == \
        [512, 1024, 1024, 2048, 2048]


@pytest.mark.parametrize("fs", [8000, 16000, 32000])
def test_fft_operators_are_rows_of_w_and_a(fs):
    """At n_fft = 2F, M and R are W's and A's rows with the packed column
    expansion undone (re^2 rows of bins 0..F-1, im^2 rows of bins 1..F-1,
    the Nyquist row), to float64 rounding of another association. Where
    n_fft is also fft_size (32 kHz) M is mel itself: W's map from the
    2F- to the fft_size-point spectrum is then the identity on the power
    spectra of F-sample frames (test_fft_operators_are_exact_on_spectra),
    not as a matrix, and M skips its dense product."""
    F, _ = _geometry(fs)
    mel_t = operators.mel_filterbank(fs, 2048, 50).T
    D, W, A = operators.packed_frontend_operators(F, 2048, 0.95, mel_t,
                                                  lpc_order=15)
    M, R = operators.fft_packed_operators(F, 2048, mel_t, lpc_order=15)
    assert M.shape == (F + 1, 50) and R.shape == (F + 1, 16)
    assert M.dtype == R.dtype == np.float64
    pairs = ((M, W), (R, A))
    if 2 * F == 2048:
        np.testing.assert_array_equal(M, mel_t)
        pairs = ((R, A),)
    for got, want in pairs:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[:F], want[:F], rtol=0,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(got[1:F], want[F:2 * F - 1], rtol=0,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(got[F], want[2 * F - 1], rtol=0,
                                   atol=1e-12 * scale)
    assert operators.fft_packed_operators(F, 2048, mel_t)[1] is None


@pytest.mark.parametrize("fs", [8000, 11025, 16000, 22050, 32000])
def test_fft_operators_are_exact_on_spectra(fs):
    """For any frame of F samples, the n_fft-point power spectrum through M
    gives the fft_size-point spectrum's mel energies, and through R the
    biased autocorrelation r[l]/F, in float64 (11.025 kHz: n_fft 1024 >
    2F; 22.05 kHz: an odd frame, n_fft 2048 = fft_size)."""
    F, _ = _geometry(fs)
    N = operators.rfft_size(F)
    mel_t = operators.mel_filterbank(fs, 2048, 50).T
    M, R = operators.fft_packed_operators(F, 2048, mel_t, lpc_order=15)
    y = np.random.RandomState(fs).randn(3, F)
    p = np.abs(np.fft.rfft(y, n=N)) ** 2
    big = np.abs(np.fft.rfft(y, n=2048)) ** 2
    want_mel = big @ mel_t
    np.testing.assert_allclose(p @ M, want_mel, rtol=1e-9,
                               atol=1e-9 * np.abs(want_mel).max())
    r = np.stack([np.sum(y[:, :F - j] * y[:, j:], axis=-1)
                  for j in range(16)], axis=-1) / F
    np.testing.assert_allclose(p @ R, r, rtol=0, atol=1e-9 * np.abs(r).max())


def _signals(lengths, L, seed, scale=500.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


K1_CASES = {  # id: (fs, FeatureConfig kwargs of a config module, cmvn)
    "8k": (8000, lambda c: {}, True),
    "11k": (11025, lambda c: {}, True),
    "16k": (16000, lambda c: {}, True),
    "32k": (32000, lambda c: {}, True),
    "8k_preemph_first": (8000, lambda c: {
        "mfcc": c.MfccConfig(preemph_first=True)}, True),
    "16k_bob": (16000, lambda c: {"mfcc": c.bob_mfcc_config()}, True),
    "8k_mfcc_only": (8000, lambda c: {"use_lpc": False}, True),
    "8k_no_cmvn": (8000, lambda c: {}, False),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_packed_fft_reference_matches_pallas(case):
    """K1's FFT route in plain torch (float32) vs pallas_frontend.
    packed_from_signals (interpret; framing, CMVN and Levinson fused) with
    the dense packed operators, on the valid frames. Tolerances of
    tests/test_torch_frontend.py: two f32 spectra of different arithmetic
    (an FFT here, a dense DFT product there) agree to ~1e-6 relative on
    the power, which CMVN'd cepstra of O(10) and Levinson carry to < 1e-4
    and < 2e-4."""
    fs, kw_of, cmvn = K1_CASES[case]
    fe = text.PackedFrontend(fs, tcfg.FeatureConfig(**kw_of(tcfg)), "cpu")
    # the Pallas kernel takes rows of fshift samples, 8 rows at a time
    L = 8 * fe.frame_shift * (-(-int(1.1 * fs) // (8 * fe.frame_shift)))
    sig, lens = _signals([L, int(0.7 * L), fe.frame_len + 3, 0], L, seed=11)
    with_lpc = fe.fft.acorr.shape[1] > 0
    T = tcfg.n_frames(L, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(torch.from_numpy(lens), T)
    got = gpu_frontend.packed_from_signals_fft_reference(
        torch.from_numpy(sig), nv, fe.fft, fe.dct, fe.floor, fe.frame_shift,
        cmvn).numpy()
    assert got.dtype == np.float32
    ceps, lpc = pallas_frontend.packed_from_signals(
        jnp.asarray(sig), fe.frame_shift, fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor,
        fe.A.numpy() if with_lpc else np.zeros((fe.D.shape[1], 8)),
        interpret=True, n_valid=jnp.asarray(nv.numpy()), cmvn=cmvn,
        fuse_lpc=with_lpc)
    nc = fe.dct.shape[1]
    m = np.arange(T)[None, :] < nv.numpy()[:, None]
    assert got.shape == (4, T, nc + max(fe.fft.acorr.shape[1] - 1, 0))
    if cmvn:
        np.testing.assert_allclose(got[..., :nc][m],
                                   np.asarray(ceps)[:, :T][m], rtol=1e-4,
                                   atol=1e-4)
    else:  # pre-CMVN cepstra of O(100)
        np.testing.assert_allclose(got[..., :nc][m],
                                   np.asarray(ceps)[:, :T][m], rtol=1e-4,
                                   atol=1e-3)
    if with_lpc:
        np.testing.assert_allclose(got[..., nc:][m],
                                   np.asarray(lpc)[:, :T][m], rtol=2e-4,
                                   atol=2e-4)
    assert (got[~m] == 0).all()


K5_CASES = {  # id: (flen, fft, fs, mel bank, with acorr)
    "48k": (1536, 2048, 48000, "melfb", True),
    "44k_mfcc_only": (1411, 2048, 44100, "melfb", False),
    "8k_fft256": (256, 256, 8000, "melfb", True),
    "16k_flen_over_fft": (512, 256, 16000, "melfb", True),
    "8k_full_env": (256, 2048, 8000, "melfb", True),
    "48k_bob": (1536, 2048, 48000, "bob", True),
}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_mfcc_fft_reference_matches_pallas(case):
    """K5's FFT route in plain torch (float32) vs pallas_frontend.
    mfcc_from_frames (interpret) with the dense C, S (which alias columns
    where the frame is longer than the FFT: the route folds sample t onto
    t mod N); a silent frame puts every bin on the floor. Tolerances of
    tests/test_torch_frames.py: ~1e-6 relative on the power, carried to
    ~1e-5 on pre-CMVN cepstra of O(10-100); the raw autocorrelation to
    1e-4 of its largest value."""
    flen, fft, fs, bank, with_acorr = K5_CASES[case]
    mel = (joperators.mel_filterbank_bounded(fs, fft, 55, 0.0, 6000.0)
           if bank == "bob" else joperators.mel_filterbank(fs, fft, 50)).T
    dct = joperators.dct_matrix(mel.shape[1])[1:14].T
    C, S = joperators.dft_power_projection(flen, fft)
    acorr = jlevinson.autocorr_operator(flen, fft, 15)
    wp = (np.random.RandomState(2).randn(40, flen) * 1000).astype(np.float32)
    wp[3] = 0.0
    want = pallas_frontend.mfcc_from_frames(
        jnp.asarray(wp), C, S, mel, dct, FLOOR,
        acorr_t=acorr if with_acorr else None, interpret=True)
    wc, wr = want if with_acorr else (want, None)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x),  # noqa: E731
                                  dtype=torch.float32)
    ac = t(acorr) if with_acorr else torch.zeros(mel.shape[0], 0)
    ceps, r = gpu_frontend.mfcc_from_frames_fft_reference(
        t(wp), t(mel), t(dct), FLOOR, ac, fft)
    assert ceps.dtype == torch.float32
    np.testing.assert_allclose(ceps.numpy(), np.asarray(wc), rtol=1e-4,
                               atol=1e-3)
    if with_acorr:
        wr = np.asarray(wr)
        np.testing.assert_allclose(r.numpy(), wr, rtol=1e-4,
                                   atol=1e-4 * np.abs(wr).max())
    else:
        assert r.shape == (40, 0)


def _fft_route(monkeypatch):
    """Serve the frontends through the FFT route's plain versions, as the
    kernels do on the card."""
    def packed(signals, n_valid, D, W, dct, A, floor, fshift, cmvn,
               fft=None, fuse_lpc=True, mm_bf16=False, n_lpcc=0):
        assert not mm_bf16  # the f32 kernel's route
        return gpu_frontend.packed_from_signals_fft_reference(
            signals, n_valid, fft, dct, floor, fshift, cmvn, fuse_lpc,
            n_lpcc)

    def full(wp, C, S, mel, dct, floor, acorr, n_fft=None):
        assert n_fft & (n_fft - 1) == 0
        return gpu_frontend.mfcc_from_frames_fft_reference(
            wp, mel, dct, floor, acorr, n_fft)
    monkeypatch.setattr(gpu_frontend, "packed_from_signals", packed)
    monkeypatch.setattr(gpu_frontend, "mfcc_from_frames", full)


SLICE_CASES = {  # id: (fs, FeatureConfig of a config module)
    "8k": (8000, lambda c: c.FeatureConfig()),
    "11k": (11025, lambda c: c.FeatureConfig()),
    "16k": (16000, lambda c: c.FeatureConfig()),
    "22k": (22050, lambda c: c.FeatureConfig()),
    "44k": (44100, lambda c: c.FeatureConfig()),
    "48k": (48000, lambda c: c.FeatureConfig()),
    "48k_bob": (48000, lambda c: c.FeatureConfig(mfcc=c.bob_mfcc_config())),
    "48k_lpcc": (48000, lambda c: c.FeatureConfig(
        lpc=c.LpcConfig(n_lpcc=16))),
    "48k_mfcc_only": (48000, lambda c: c.FeatureConfig(use_lpc=False)),
    "16k_bob": (16000, lambda c: c.FeatureConfig(mfcc=c.bob_mfcc_config())),
}


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_extract_batch_on_the_fft_route_matches_jax(case, monkeypatch):
    """extract_batch with both frontends on the FFT route vs the JAX XLA
    extractor (f32), ragged lengths with an empty utterance; the bound of
    tests/test_torch_full.py (two f32 frontends of different arithmetic;
    LPC cepstra of white noise reach O(1e3))."""
    fs, cfg_of = SLICE_CASES[case]
    _fft_route(monkeypatch)
    L = 4096 * (-(-fs // 4096)) if fs > 8000 else 8192
    sig, lens = _signals([L, int(0.6 * L), L // 5, 0], L, seed=5,
                         scale=3000.0)
    want, wmask = jext._feature_fn(fs, cfg_of(jcfg), L, "float32", "off",
                                   "f32", "packed", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, cfg_of(tcfg))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)


# a frame of one sample at 8 kHz, two filters, no LPC: the least C and S
# (1 x 8,388,612) past the chirp-z route's reach, where M would be 2^24
PAST_REACH = dict(win_length_ms=0.125, win_shift_ms=0.125, n_filters=2,
                  n_ceps=1)


@pytest.mark.parametrize("fs,fft_size,dense,mfcc", [
    (48000, 2048, False, {}), (48000, 1500, False, {}),
    (8000, 16777218, True, PAST_REACH), (48000, 14000, False, {}),
    (8000, 261634, False, {})],
    ids=["power_of_two", "not_a_power_of_two", "past_the_chirp_reach",
         "past_the_chirp_tile", "past_the_cluster"])
def test_full_frontend_operators_follow_the_route(fs, fft_size, dense, mfcc):
    """On the card the full-spectrum frontend keeps C and S only where the
    dense kernel reads them (an fft_size that is not a power of two and
    whose chirp-z convolution passes 2^23 points: 16777218 with a frame of
    one sample; 1500 takes the chirp-z kernel at 48 kHz, 14000 its cluster
    route, M = 16384, 261634 at 8 kHz the passes, M = 262144); on the CPU
    its plain version always reads them."""
    cfg = tcfg.FeatureConfig(mfcc=tcfg.MfccConfig(fft_size=fft_size, **mfcc),
                             use_lpc=not mfcc)
    fe = text.FullFrontend(fs, cfg, "meta")
    nb = fft_size // 2 + 1
    assert fe.n_fft == fft_size and fe.mel.shape[0] == nb + (-nb % 4)
    assert (fe.C is not None) == (fe.S is not None) == dense
    cpu = text.FullFrontend(fs, cfg, "cpu")
    flen = tcfg.frame_geometry(fs, cfg.mfcc.win_length_ms,
                               cfg.mfcc.win_shift_ms)[0]
    assert cpu.C.shape == (flen, nb + (-nb % 4))


def test_dense_template_sums_hold_past_the_chirp_reach():
    """The dense template's order of sums (csrc/frontend_frames.cu) at
    fft_size 16777218 on frames of two samples (8.4M bins, chip_smoke.py
    phase 15's shape past the chirp-z reach), modelled in numpy against the
    float64 sum of power x mel: each 128-bin chunk summed in f32 and the
    chunks in float64 stay within 1e-6 relative; the one f32 running sum
    over all bins it replaced (each term a few ulps of the sum, every add
    rounded alike) drifts past 1e-3."""
    cfg = tcfg.FeatureConfig(
        mfcc=tcfg.MfccConfig(fft_size=16777218, win_length_ms=0.25,
                             win_shift_ms=0.25, n_filters=2, n_ceps=1),
        use_lpc=False)
    fe = text.FullFrontend(8000, cfg, "cpu")
    C, S, mel = (x.numpy() for x in (fe.C, fe.S, fe.mel))
    rng = np.random.RandomState(0)
    worst_old = 0.0
    for _ in range(2):
        w = (rng.randn(2) * 300).astype(np.float32)
        re = w[0] * C[0] + w[1] * C[1]
        im = w[0] * S[0] + w[1] * S[1]
        p = np.maximum(re * re + im * im, np.float32(fe.floor))
        for j in range(2):
            t = p * mel[:, j]  # f32 products
            exact = float(np.dot(p.astype(np.float64), mel[:, j]))
            chunks = np.cumsum(np.pad(t, (0, -len(t) % 128)).reshape(-1, 128),
                               axis=1, dtype=np.float32)[:, -1]
            new = float(np.sum(chunks.astype(np.float64)))
            old = float(np.cumsum(t, dtype=np.float32)[-1])
            assert abs(new / exact - 1) < 1e-6
            worst_old = max(worst_old, abs(old / exact - 1))
    assert worst_old > 1e-3


class _ShapeLib:
    """The library's srt_fft_operator_shape in Python: chunks of 16 rows (32
    at n_fft 2048), 72 or 128 columns (csrc/rfft_tile.cuh)."""

    def srt_fft_operator_shape(self, n_fft, nout, rows, cols, chunks):
        if n_fft < 64 or n_fft > 2048 or n_fft & (n_fft - 1) or nout > 128:
            return -1
        ck = 32 if n_fft >= 2048 else 16
        rows._obj.value = -(-(n_fft // 2 + 1) // ck) * ck
        cols._obj.value = 72 if nout <= 72 else 128
        chunks._obj.value = 1
        return 0


def test_packed_operator_layout_and_cache():
    """The FFT kernels' operator: [mel | acorr | 0] on rows 0..n_fft/2 and
    zero rows to a multiple of the kernel's chunk; built once per (mel, acorr, n_fft),
    rebuilt after an in-place write, never confused with another tensor
    that reuses freed storage; an FFT size the tile does not take
    raises."""
    lib = _ShapeLib()
    mel = torch.rand(1028, 50, dtype=torch.float32)
    acorr = torch.rand(1028, 16, dtype=torch.float32)
    op = gpu_frontend._packed_operator(lib, mel, acorr, 2048)
    assert op.shape == (1056, 72)
    assert torch.equal(op[:1025, :50], mel[:1025])
    assert torch.equal(op[:1025, 50:66], acorr[:1025])
    assert (op[1025:] == 0).all() and (op[:, 66:] == 0).all()
    assert gpu_frontend._packed_operator(lib, mel, acorr, 2048) is op
    mel.mul_(2.0)
    again = gpu_frontend._packed_operator(lib, mel, acorr, 2048)
    assert torch.equal(again[:1025, :50], mel[:1025])
    other = gpu_frontend._packed_operator(lib, mel.clone(), acorr, 2048)
    assert other is not again and torch.equal(other, again)
    small = gpu_frontend._packed_operator(lib, mel, acorr, 256)
    assert small.shape == (144, 72) and (small[129:] == 0).all()
    with pytest.raises(ValueError, match="power of two"):
        gpu_frontend._packed_operator(lib, mel, acorr, 1500)


K4_CASES = {  # id: (fs, FeatureConfig kwargs of a config module)
    "8k": (8000, lambda c: {}),
    "16k": (16000, lambda c: {}),
    "8k_preemph_first": (8000, lambda c: {
        "mfcc": c.MfccConfig(preemph_first=True)}),
    "16k_bob": (16000, lambda c: {"mfcc": c.bob_mfcc_config()}),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_frames_fft_reference_matches_pallas(case):
    """K4's FFT route in plain torch (float32: window and pre-emphasis per
    sample, the rfft_size(frame_len)-point power, the bin-domain operators)
    vs pallas_frontend.packed_from_frames (interpret; the dense packed
    operators D, W, A) on raw frames with LPC; a silent frame puts every
    mel energy on the floor. The bounds of tests/test_torch_frames.py:
    ~1e-6 relative on the power, carried to ~1e-5 on pre-CMVN cepstra of
    O(10-100); the raw autocorrelation to 1e-4 of its largest value."""
    fs, kw_of = K4_CASES[case]
    fe = text.PackedFrontend(fs, tcfg.FeatureConfig(**kw_of(tcfg)), "cpu")
    frames = (np.random.RandomState(fs).randn(45, fe.frame_len) * 1000
              ).astype(np.float32)
    frames[4] = 0.0
    wc, wr = pallas_frontend.packed_from_frames(
        jnp.asarray(frames), fe.D.numpy(), fe.W.numpy(), fe.dct.numpy(),
        fe.floor, A=fe.A.numpy(), interpret=True)
    ceps, r = gpu_frontend.packed_from_frames_fft_reference(
        torch.from_numpy(frames), fe.fft, fe.dct, fe.floor)
    assert ceps.dtype == torch.float32 and r.shape == (45, 16)
    np.testing.assert_allclose(ceps.numpy(), np.asarray(wc), rtol=1e-4,
                               atol=1e-3)
    wr = np.asarray(wr)
    np.testing.assert_allclose(r.numpy(), wr, rtol=1e-4,
                               atol=1e-4 * np.abs(wr).max())
