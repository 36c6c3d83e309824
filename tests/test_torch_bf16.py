"""speaker_recognition_tpu_torch's bf16 operand modes against the JAX
package's, on the same numpy inputs: K2's and K3's precision="bf16"
(ops/gpu_gmm and the plain versions of models/gmm against
pallas_gmm.batch_bank_avg_loglik / bank_sum_loglik in interpret mode), K1's
and K4's mm_bf16 (ops/gpu_frontend against pallas_frontend in interpret
mode), and the slice, api/fastpath.predict_scores(mm="bf16"), against the
JAX serving program with mm="bf16" at 8 kHz and the JAX extractor's bf16
product on the full route at 48 kHz. Each mode must sit at least 10x its
tolerance away from its f32 counterpart, so a mode that rounds nothing
fails. Also: the bf16 kernels' component layout (GmmBank.mma_operator)
multiplied out in f32 reproduces the plain scores, and mm="bf16" at float64
is the float64 route.

JAX's interpret-mode bf16 dot with f32 accumulation on the CPU equals an f32
dot of the rounded operands up to summation order: 1e-7 of the largest
term measured (products of two bf16 values are exact in f32)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.api import fastpath as jfast  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend, pallas_gmm  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath as tfast  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend, gpu_gmm  # noqa: E402

FS = 8000
# Scores: f32 sums of exact bf16 products in other orders; ~4e-7 relative
# measured on both averages and sums
SCORE_RTOL, SCORE_ATOL = 5e-6, 5e-5
# Features: the dense DFT summed in other f32 orders, 2e-5 measured on
# cepstra (CMVN'd or not) and 4e-5 on LPC (tests/test_torch_frontend.py's
# bounds, absolute); the raw autocorrelation relative to its lag 0, 6e-7
# measured
CEPS_ATOL, LPC_ATOL, LPC_RTOL, ACORR_RTOL = 1e-4, 1e-4, 1e-5, 1e-5
# the slice, frontend and scoring composed: both packages take the same
# rounded dense product (the FFT plays no part), 1.1e-6 relative measured
# at 8 kHz and 6e-7 at 48 kHz; scores are means over hundreds of frames,
# so the bf16 rounding moves them by only ~6e-5 relative at 8 kHz
SLICE_RTOL, SLICE_ATOL = 2e-6, 2e-5
# each bf16 mode lies at least this many tolerances from its f32 mode
APART = 10


def _bank_np(S, K, d, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _jbank(bank_np):
    return jgmm.GmmParams(*(jnp.asarray(a, jnp.float32) for a in bank_np))


def _feats(B, T, d, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    mask = np.arange(T)[None, :] < (T - 37 * np.arange(B))[:, None]
    return np.where(mask[..., None], x, 0).astype(np.float32), mask


def _signals(lengths, L, seed, scale=3000.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


def _apart(bf16, f32, want, rtol, atol):
    """The bf16 mode's distance from the f32 mode is at least APART times
    the largest deviation the tolerance allows."""
    allowed = float(np.max(atol + rtol * np.abs(want)))
    dist = float(np.max(np.abs(bf16 - f32)))
    assert dist >= APART * allowed, (dist, allowed)


def _port_batch(bank, feats, mask, precision):
    return gpu_gmm.batch_bank_avg_loglik(
        bank, torch.from_numpy(feats), torch.from_numpy(mask),
        precision=precision).numpy()


@pytest.mark.parametrize("S,K", [(4, 32), (11, 8)])
def test_batched_bf16_scores_match_jax(S, K):
    """K2's bf16 mode: the plain version against the Pallas kernel in
    interpret mode, at the bench bank's S x K and at an S that is not a
    multiple of its SPK_BLOCK (padded speakers)."""
    d = 28
    bank_np = _bank_np(S, K, d)
    feats, mask = _feats(3, 250, d)
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    got = _port_batch(bank, feats, mask, "bf16")
    want = np.asarray(pallas_gmm.batch_bank_avg_loglik(
        _jbank(bank_np), jnp.asarray(feats), jnp.asarray(mask),
        interpret=True, precision="bf16"))
    assert got.shape == (3, S) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    _apart(got, _port_batch(bank, feats, mask, "f32"), want, SCORE_RTOL,
           SCORE_ATOL)


def _port_sum(bank, x, mask, precision):
    return gpu_gmm.bank_sum_loglik(bank, torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   precision=precision).numpy()


def _jax_sum(bank_np, x, mask, precision="bf16"):
    return np.asarray(pallas_gmm.bank_sum_loglik(
        _jbank(bank_np), jnp.asarray(x), jnp.asarray(mask), interpret=True,
        precision=precision))


# sums over ~200 frames of O(40) per-frame scores
SUM_RTOL, SUM_ATOL = 2e-6, 1e-3


def test_serial_bf16_sums_match_jax():
    """K3's bf16 mode: the plain version against the Pallas kernel in
    interpret mode on an utterance where no frame underflows."""
    bank_np = _bank_np(5, 16, 28)
    feats, mask = _feats(1, 230, 28)
    x, m = feats[0], mask[0]
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    got = _port_sum(bank, x, m, "bf16")
    want = _jax_sum(bank_np, x, m)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    _apart(got, _port_sum(bank, x, m, "f32"), want, SUM_RTOL, SUM_ATOL)


def test_serial_bf16_differs_only_where_every_component_underflows():
    """The port's K3 applies the -745 floor, the TPU kernel does not
    (ROADMAP queue 3): with one frame far from every component, the port's
    bf16 sum is the JAX sum over the other frames plus log(1e-15)."""
    bank_np = _bank_np(3, 8, 6)
    feats, mask = _feats(1, 60, 6)
    x, m = feats[0].copy(), mask[0]
    x[5] = 1e3  # every component underflows at frame 5
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    got = _port_sum(bank, x, m, "bf16")
    others = m.copy()
    others[5] = False
    want = _jax_sum(bank_np, x, others) + math.log(1e-15)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    assert (np.abs(got - _jax_sum(bank_np, x, m)) > 1e3).all()


def _swapped(bank, X, precision_square_rounded):
    """The plain scores with the other kernel's rounding of x^2."""
    Z, op = tgmm._operands(bank, X, "bf16", precision_square_rounded)
    return Z @ op + bank.cw


def test_each_kernel_rounds_x2_its_own_way():
    """K2 rounds x, squares it and rounds again; K3 squares in f32 and
    rounds once. Each plain version matches its own JAX kernel, and each
    would fail the other's."""
    S, K, d = 4, 8, 28
    bank_np = _bank_np(S, K, d)
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    feats, mask = _feats(2, 200, d, seed=5)
    # K2 under K3's rounding, against the JAX batched kernel
    want = np.asarray(pallas_gmm.batch_bank_avg_loglik(
        _jbank(bank_np), jnp.asarray(feats), jnp.asarray(mask),
        interpret=True, precision="bf16"))
    lse = tgmm._floored_lse(_swapped(bank, torch.from_numpy(feats), False)
                            .reshape(2, 200, S, K), 1e-15)
    m = torch.from_numpy(mask).float()
    k2_as_k3 = (torch.einsum("bts,bt->bs", lse, m)
                / m.sum(-1, keepdim=True)).numpy()
    assert not np.allclose(k2_as_k3, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_allclose(_port_batch(bank, feats, mask, "bf16"), want,
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    # K3 under K2's rounding, against the JAX serial kernel
    x, mk = feats[0], mask[0]
    want = _jax_sum(bank_np, x, mk)
    lse = tgmm._floored_lse(_swapped(bank, torch.from_numpy(x), True)
                            .reshape(200, S, K), 1e-15)
    k3_as_k2 = (torch.from_numpy(mk).float() @ lse).numpy()
    assert not np.allclose(k3_as_k2, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(_port_sum(bank, x, mk, "bf16"), want,
                               rtol=SUM_RTOL, atol=SUM_ATOL)


def _emulate_mma(bank, X, mask, square_rounded):
    """What the bf16 kernels compute from GmmBank.mma_operator's rows, in
    f32: [x^2 | x | 0] . the rows' dk values + cw from the rows' tail, the
    logsumexp over each speaker's kp rows (padding included), the floor,
    the masked mean over frames. X [B, T, d]."""
    d = bank.dim
    dk = -(-2 * d // 16) * 16
    kp = -(-bank.n_mixtures // 8) * 8
    rows = bank.mma_operator(dk + 8, kp)
    assert rows.dtype == torch.bfloat16 and rows.shape == (
        bank.n_speakers, kp, dk + 8)
    terms = rows[..., :dk].float()                       # [S, kp, dk]
    cw = rows.view(torch.float32)[..., dk // 2]          # [S, kp]
    xb = X.bfloat16().float()
    x2 = (xb * xb if square_rounded else X * X).bfloat16().float()
    A = torch.cat([x2, xb, X.new_zeros(*X.shape[:-1], dk - 2 * d)], -1)
    logp = torch.einsum("btj,skj->btsk", A, terms) + cw
    lse = tgmm._floored_lse(logp, 1e-15)                 # [B, T, S]
    m = mask.float()
    return torch.einsum("bts,bt->bs", lse, m) / m.sum(-1).clamp_min(1)[:, None]


@pytest.mark.parametrize("K,d", [(12, 5), (32, 28)])
def test_mma_rows_reproduce_the_plain_scores(K, d):
    """GmmBank.mma_operator: a and b rounded to bf16, zeros up to the
    MMA's depth, cw as f32 bits in the row's tail, components padded to a
    multiple of 8 with rows that add nothing (K = 12 pads to 16); the
    rows multiplied out reproduce both kernels' plain versions."""
    bank = tgmm.GmmBank.from_numpy(*_bank_np(3, K, d), device="cpu")
    feats, mask = _feats(2, 90, d, seed=7)
    X, mk = torch.from_numpy(feats), torch.from_numpy(mask)
    got = _emulate_mma(bank, X, mk, True).numpy()
    want = _port_batch(bank, feats, mask, "bf16")
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    got = _emulate_mma(bank, X[:1], mk[:1], False).numpy()[0]
    want = _port_sum(bank, feats[0], mask[0], "bf16") / mask[0].sum()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    rows = bank.mma_operator(-(-2 * d // 16) * 16 + 8, -(-K // 8) * 8)
    assert (rows[:, K:, :-8].float() == 0).all()
    assert (rows.view(torch.float32)[:, K:, -4] == tgmm.PAD_CW).all()


def test_precision_and_mm_are_checked():
    bank = tgmm.GmmBank.from_numpy(*_bank_np(2, 4, 3), device="cpu")
    feats, mask = _feats(1, 10, 3)
    for fn, args in ((gpu_gmm.batch_bank_avg_loglik,
                      (torch.from_numpy(feats), torch.from_numpy(mask))),
                     (gpu_gmm.bank_sum_loglik,
                      (torch.from_numpy(feats[0]),
                       torch.from_numpy(mask[0])))):
        with pytest.raises(ValueError, match="precision"):
            fn(bank, *args, precision="tf32")
    sig, lens = _signals([4000], 8192, seed=1)
    with pytest.raises(ValueError, match="mm"):
        text.extract_batch(torch.from_numpy(sig), torch.from_numpy(lens), FS,
                           mm="fp8")


def _frontend(fs=FS, mm="f32", **kw):
    return text.PackedFrontend(fs, tcfg.FeatureConfig(**kw), "cpu", mm=mm)


def _k1(fe, sig, nv, cmvn, fuse_lpc, mm_bf16):
    out = gpu_frontend.packed_from_signals(
        torch.from_numpy(sig), nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
        fe.frame_shift, cmvn, fuse_lpc=fuse_lpc, mm_bf16=mm_bf16)
    if fuse_lpc:
        nc = fe.dct.shape[1]
        return out[..., :nc].numpy(), out[..., nc:].numpy()
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("cmvn", [True, False])
@pytest.mark.parametrize("fuse_lpc", [True, False])
def test_k1_bf16_matches_jax(cmvn, fuse_lpc):
    """K1's mm_bf16: the plain version against
    pallas_frontend.packed_from_signals(mm_bf16=True) in interpret mode,
    with the fused Levinson and with the raw autocorrelation (the LPCC
    route), CMVN on and off."""
    L = 8192
    sig, lens = _signals([7000, 8192, 2000], L, seed=11)
    fe = _frontend()
    T = L // fe.frame_shift - 1
    nv = fe.valid_frames(torch.from_numpy(lens), T)
    ceps, second = _k1(fe, sig, nv, cmvn, fuse_lpc, True)
    jc, jr = pallas_frontend.packed_from_signals(
        jnp.asarray(sig), fe.frame_shift, fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor, fe.A.numpy(), interpret=True,
        mm_bf16=True, n_valid=jnp.asarray(nv.numpy()), cmvn=cmvn,
        fuse_lpc=fuse_lpc)
    jc, jr = np.asarray(jc), np.asarray(jr)
    m = np.arange(T)[None, :] < nv.numpy()[:, None]
    f32c, f32r = _k1(fe, sig, nv, cmvn, fuse_lpc, False)
    np.testing.assert_allclose(ceps[m], jc[m], rtol=0, atol=CEPS_ATOL)
    _apart(ceps[m], f32c[m], jc[m], 0, CEPS_ATOL)
    if fuse_lpc:
        np.testing.assert_allclose(second[m], jr[m], rtol=LPC_RTOL,
                                   atol=LPC_ATOL)
        _apart(second[m], f32r[m], jr[m], LPC_RTOL, LPC_ATOL)
    else:
        lag0 = np.abs(jr[..., :1])[m]
        assert (np.abs(second[m] - jr[m]) <= ACORR_RTOL * lag0).all()
        assert (np.abs(second[m] - f32r[m])
                > APART * ACORR_RTOL * lag0).any()
    assert (ceps[~m] == 0).all() and (second[~m] == 0).all()


def test_k1_bf16_mfcc_only_matches_jax():
    """MFCC only: the port's A has no columns, the JAX package runs the
    kernel with a zero 8-column placeholder (features/extract.py:259-262)."""
    L = 8192
    sig, lens = _signals([8192, 5000], L, seed=12)
    fe = _frontend(use_lpc=False)
    T = L // fe.frame_shift - 1
    nv = fe.valid_frames(torch.from_numpy(lens), T)
    got = gpu_frontend.packed_from_signals(
        torch.from_numpy(sig), nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
        fe.frame_shift, True, mm_bf16=True).numpy()
    jc, _ = pallas_frontend.packed_from_signals(
        jnp.asarray(sig), fe.frame_shift, fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor, np.zeros((fe.D.shape[1], 8)),
        interpret=True, mm_bf16=True, n_valid=jnp.asarray(nv.numpy()),
        cmvn=True, fuse_lpc=False)
    m = np.arange(T)[None, :] < nv.numpy()[:, None]
    assert got.shape == (2, T, 13)
    np.testing.assert_allclose(got[m], np.asarray(jc)[m], rtol=0,
                               atol=CEPS_ATOL)
    f32 = gpu_frontend.packed_from_signals(
        torch.from_numpy(sig), nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
        fe.frame_shift, True).numpy()
    _apart(got[m], f32[m], np.asarray(jc)[m], 0, CEPS_ATOL)


@pytest.mark.parametrize("use_lpc", [True, False])
def test_k4_bf16_matches_jax(use_lpc):
    """K4's mm_bf16: the plain version against
    pallas_frontend.packed_from_frames(mm_bf16=True) in interpret mode on
    raw frames (pre-CMVN cepstra, raw autocorrelation)."""
    fe = _frontend(use_lpc=use_lpc)
    rng = np.random.RandomState(13)
    frames = (rng.randn(300, fe.frame_len) * 3000).astype(np.float32)
    ceps, r = gpu_frontend.packed_from_frames(
        torch.from_numpy(frames), fe.D, fe.W, fe.dct, fe.floor, fe.A,
        mm_bf16=True)
    out = pallas_frontend.packed_from_frames(
        jnp.asarray(frames), fe.D.numpy(), fe.W.numpy(), fe.dct.numpy(),
        fe.floor, A=fe.A.numpy() if use_lpc else None, interpret=True,
        mm_bf16=True)
    jc, jr = out if use_lpc else (out, None)
    ceps, jc = ceps.numpy(), np.asarray(jc)
    np.testing.assert_allclose(ceps, jc, rtol=0, atol=CEPS_ATOL)
    f32c, f32r = gpu_frontend.packed_from_frames(
        torch.from_numpy(frames), fe.D, fe.W, fe.dct, fe.floor, fe.A)
    _apart(ceps, f32c.numpy(), jc, 0, CEPS_ATOL)
    if use_lpc:
        jr = np.asarray(jr)
        lag0 = np.abs(jr[:, :1])
        assert (np.abs(r.numpy() - jr) <= ACORR_RTOL * lag0).all()
        assert (np.abs(r.numpy() - f32r.numpy())
                > APART * ACORR_RTOL * lag0).any()
    else:
        assert r.shape == (300, 0)


def _slice_inputs(fs, seconds, B=4, seed=0):
    rng = np.random.RandomState(seed)
    L = -(-int(seconds * fs) // 4096) * 4096
    lengths = np.array([L, int(0.7 * L), int(0.4 * L), 2 * fs // 5][:B],
                       np.int32)
    sig, _ = _signals(lengths, L, seed)
    d = tcfg.FeatureConfig().dim
    bank_np = (rng.dirichlet(np.ones(8), size=3).astype(np.float32),
               rng.randn(3, 8, d).astype(np.float32),
               (0.5 + rng.rand(3, 8, d)).astype(np.float32))
    return sig, lengths, bank_np


def _port_scores(sig, lengths, bank_np, fs, mm, dtype=torch.float32):
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu", dtype=dtype)
    return tfast.predict_scores(torch.from_numpy(sig),
                                torch.from_numpy(lengths), bank, fs,
                                tcfg.FeatureConfig(), mm=mm).numpy()


def test_predict_scores_bf16_matches_jax_program():
    """The slice at 8 kHz: predict_scores(mm="bf16") against
    predict_scores_fn(FS, cfg, Lp, "pallas", "bf16", "pallas_wide") with
    both Pallas kernels in interpret mode (K1's bf16 mode, K2 at f32)."""
    sig, lengths, bank_np = _slice_inputs(FS, 1.0)
    fn = jfast.predict_scores_fn(FS, jcfg.FeatureConfig(), sig.shape[1],
                                 "pallas", "bf16", "pallas_wide",
                                 interpret=True)
    want = np.asarray(fn(jnp.asarray(sig), jnp.asarray(lengths),
                         *_jbank(bank_np)))
    got = _port_scores(sig, lengths, bank_np, FS, "bf16")
    np.testing.assert_allclose(got, want, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    _apart(got, _port_scores(sig, lengths, bank_np, FS, "f32"), want,
           SLICE_RTOL, SLICE_ATOL)


def test_full_route_bf16_matches_jax_extractor():
    """The slice at 48 kHz (the full-spectrum route): the port's bf16
    product against the JAX extractor's (_feature_fn with matmul_dtype
    "bf16", its XLA route), each scored by its package's f32 batched
    scoring; the route is counted, and K5's plain version is not run."""
    fs = 48000
    sig, lengths, bank_np = _slice_inputs(fs, 0.5, seed=3)
    feats, mask = jext._feature_fn(fs, jcfg.FeatureConfig(), sig.shape[1],
                                   "float32", "off", "bf16")(
        jnp.asarray(sig), jnp.asarray(lengths))
    want = np.asarray(jgmm.batch_bank_avg_loglik(_jbank(bank_np), feats,
                                                 mask))
    calls = gpu_frontend.FULL_BF16_CALLS
    got = _port_scores(sig, lengths, bank_np, fs, "bf16")
    assert gpu_frontend.FULL_BF16_CALLS == calls + 1
    np.testing.assert_allclose(got, want, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    _apart(got, _port_scores(sig, lengths, bank_np, fs, "f32"), want,
           SLICE_RTOL, SLICE_ATOL)
    tfe, tmask = text.extract_batch(torch.from_numpy(sig),
                                    torch.from_numpy(lengths), fs, mm="bf16")
    assert (tmask.numpy() == np.asarray(mask)).all()
    np.testing.assert_allclose(tfe.numpy(), np.asarray(feats), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("fs", [FS, 48000])
def test_mm_bf16_at_float64_is_the_float64_route(fs):
    """mm applies at float32 only, as the JAX package's mm_dt: at float64
    mm="bf16" runs the float64 route unchanged, bitwise."""
    sig, lengths, bank_np = _slice_inputs(fs, 0.5, B=2, seed=4)
    s, n = torch.from_numpy(sig), torch.from_numpy(lengths)
    a = text.extract_batch(s, n, fs, dtype="float64", mm="bf16")
    b = text.extract_batch(s, n, fs, dtype="float64")
    assert a[0].dtype == torch.float64
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    got = _port_scores(sig, lengths, bank_np, fs, "bf16", torch.float64)
    want = _port_scores(sig, lengths, bank_np, fs, "f32", torch.float64)
    assert np.array_equal(got, want)
