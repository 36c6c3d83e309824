"""speaker_recognition_tpu_torch's LPC-cepstra route and the scoring
kernels' widened shapes against the JAX package, on the same numpy inputs:
the signal frontend's raw-autocorrelation mode (ops/gpu_frontend.
packed_from_signals(fuse_lpc=False), both plain versions) against the Pallas
kernel in interpret mode; extract_batch with n_lpcc = 16 against the JAX
extractor, which serves it through that kernel; and the plain serial and
batched bank scores at d = 102 and at 1024 components against the JAX
package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.models.gmmset import GMMSet as JGMMSet  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend, pallas_gmm  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.models.gmmset import GMMSet  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend, gpu_gmm  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402


def _lpcc(c, **kw):
    return c.FeatureConfig(lpc=c.LpcConfig(n_lpcc=16), **kw)


def _signals(lengths, L, seed, scale=3000.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


def _padded_len(fe):
    """About 1.1 s in rows of fshift samples, 8 rows at a time (what the
    Pallas signal kernel takes)."""
    step = 8 * fe.frame_shift
    return step * (-(-int(1.1 * fe.frame_shift * 62.5) // step))


# -- (a) the raw-autocorrelation mode ----------------------------------------

@pytest.mark.parametrize("plain", ["dense", "fft"])
@pytest.mark.parametrize("fs,cmvn", [(8000, True), (16000, True),
                                     (8000, False)],
                         ids=["8k", "16k", "8k_no_cmvn"])
def test_raw_autocorrelation_mode_matches_pallas(fs, cmvn, plain):
    """Both plain versions of packed_from_signals(fuse_lpc=False) (float32)
    vs pallas_frontend.packed_from_signals(fuse_lpc=False, interpret=True),
    on the valid frames (the TPU kernel leaves the rest unmasked; the port
    zeroes them). Cepstra as tests/test_torch_fft.py bounds them (1e-4 on
    CMVN'd cepstra, 1e-3 on pre-CMVN ones of O(100)); the autocorrelation
    is a sum of f32 power bins in another order, held to 1e-4 of the
    frame's lag-0 value, its largest."""
    fe = text.PackedFrontend(fs, _lpcc(tcfg), "cpu")
    L = _padded_len(fe)
    sig, lens = _signals([L, int(0.7 * L), fe.frame_len + 3, 0], L, seed=21)
    T = tcfg.n_frames(L, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(torch.from_numpy(lens), T)
    if plain == "dense":
        ceps, r = gpu_frontend.packed_from_signals_reference(
            torch.from_numpy(sig), nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
            fe.frame_shift, cmvn, fuse_lpc=False)
    else:
        ceps, r = gpu_frontend.packed_from_signals_fft_reference(
            torch.from_numpy(sig), nv, fe.fft, fe.dct, fe.floor,
            fe.frame_shift, cmvn, fuse_lpc=False)
    assert ceps.dtype == r.dtype == torch.float32
    assert ceps.shape == (4, T, 13) and r.shape == (4, T, 16)
    wc, wr = pallas_frontend.packed_from_signals(
        jnp.asarray(sig), fe.frame_shift, fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor, fe.A.numpy(), interpret=True,
        n_valid=jnp.asarray(nv.numpy()), cmvn=cmvn, fuse_lpc=False)
    wc, wr = np.asarray(wc)[:, :T], np.asarray(wr)[:, :T]
    assert wr.shape == r.shape
    m = np.arange(T)[None, :] < nv.numpy()[:, None]
    np.testing.assert_allclose(ceps.numpy()[m], wc[m], rtol=1e-4,
                               atol=1e-4 if cmvn else 1e-3)
    lag0 = np.abs(wr[m][:, :1])
    assert (np.abs(r.numpy()[m] - wr[m]) <= 1e-4 * lag0).all()
    assert (ceps.numpy()[~m] == 0).all() and (r.numpy()[~m] == 0).all()


def test_wrapper_modes_on_the_cpu():
    """On CPU tensors the wrapper runs the dense plain version in either
    mode and counts nothing; the raw mode's cepstra are the fused mode's
    and its autocorrelation gives the fused mode's LPC; without LPC the
    autocorrelation is zero-width."""
    fe = text.PackedFrontend(8000, _lpcc(tcfg), "cpu")
    sig, lens = _signals([8192, 5000], 8192, seed=22)
    nv = fe.valid_frames(torch.from_numpy(lens), 63)
    args = (torch.from_numpy(sig), nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
            fe.frame_shift, fe.cmvn)
    before = gpu_frontend.LAUNCHES
    fused = gpu_frontend.packed_from_signals(*args)
    ceps, r = gpu_frontend.packed_from_signals(*args, fuse_lpc=False)
    assert gpu_frontend.LAUNCHES == before
    assert torch.equal(ceps, fused[..., :13])
    from speaker_recognition_tpu_torch.ops import levinson
    mask = torch.arange(63) < nv[:, None]
    lpc = levinson.lpc_from_autocorr(r)
    assert torch.equal(torch.where(mask[..., None], lpc,
                                   torch.zeros_like(lpc)), fused[..., 13:])
    mfcc_only = text.PackedFrontend(8000, tcfg.FeatureConfig(use_lpc=False),
                                    "cpu")
    c0, r0 = gpu_frontend.packed_from_signals(
        args[0], nv, mfcc_only.D, mfcc_only.W, mfcc_only.dct, mfcc_only.A,
        mfcc_only.floor, 128, True, fuse_lpc=False)
    assert c0.shape == (2, 63, 13) and r0.shape == (2, 63, 0)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_raw_mode_cuda_request_raises_without_cuda():
    """On a CUDA tensor the raw-autocorrelation mode builds and launches
    the kernel or raises, as the fused mode does: no plain version, no
    count."""
    fe = text.PackedFrontend(8000, _lpcc(tcfg), "cpu")
    sig, lens = _signals([8192], 8192, seed=23)
    cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    fft = gpu_frontend.FftRoute(fe.n_fft, cuda(fe.window), fe.pre_emph,
                                fe.preemph_first, cuda(fe.fft_mel),
                                cuda(fe.fft_acorr))
    before = gpu_frontend.LAUNCHES
    with pytest.raises(RuntimeError):
        gpu_frontend.packed_from_signals(
            cuda(torch.from_numpy(sig)),
            cuda(torch.tensor([63], dtype=torch.int32)), fe.D, fe.W,
            cuda(fe.dct), fe.A, fe.floor, fe.frame_shift, True, fft=fft,
            fuse_lpc=False)
    assert gpu_frontend.LAUNCHES == before


# -- (b) the LPC-cepstra slice -----------------------------------------------

def _fft_route(monkeypatch):
    """Serve the signal frontend through its FFT route's plain version, as
    the kernel does on the card."""
    def packed(signals, n_valid, D, W, dct, A, floor, fshift, cmvn,
               fft=None, fuse_lpc=True, mm_bf16=False, n_lpcc=0):
        assert not mm_bf16  # the f32 kernel's route
        return gpu_frontend.packed_from_signals_fft_reference(
            signals, n_valid, fft, dct, floor, fshift, cmvn, fuse_lpc,
            n_lpcc)
    monkeypatch.setattr(gpu_frontend, "packed_from_signals", packed)


@pytest.mark.parametrize("route", ["dense", "fft"])
@pytest.mark.parametrize("n_deltas", [0, 2], ids=["no_deltas", "deltas2"])
@pytest.mark.parametrize("fs", [8000, 16000], ids=["8k", "16k"])
def test_lpcc_extract_batch_matches_jax_pallas_route(fs, n_deltas, route,
                                                     monkeypatch):
    """extract_batch with n_lpcc = 16 (the signal frontend's raw mode, then
    Levinson, the LPCC recursion and deltas in torch) vs the JAX extractor
    with its Pallas kernels in interpret mode, which takes
    packed_from_signals(fuse_lpc=False) too; ragged lengths with an empty
    utterance. MFCC columns and their deltas: the bound of
    tests/test_torch_full.py (two f32 frontends of different arithmetic).
    LPC cepstra of white noise reach O(1e3) through a recursion whose terms
    grow with the index and cancel, so they and their deltas are held
    relative to their frame's largest one, as tests/test_torch_frames.py
    holds lpcc_from_lpc."""
    if route == "fft":
        _fft_route(monkeypatch)
    L = 8192 if fs == 8000 else 16384
    sig, lens = _signals([L, int(0.6 * L), L // 5, 0], L, seed=5)
    calls = []
    real = pallas_frontend.packed_from_signals
    jext._feature_fn.cache_clear()  # trace anew: the spy sees the kernel
    monkeypatch.setattr(
        pallas_frontend, "packed_from_signals",
        lambda *a, **kw: calls.append(kw["fuse_lpc"]) or real(*a, **kw))
    want, wmask = jext._feature_fn(
        fs, _lpcc(jcfg, n_deltas=n_deltas), L, "float32", "interpret", "f32",
        "packed", "default")(jnp.asarray(sig), jnp.asarray(lens))
    assert calls == [False]  # the JAX side did take the raw mode
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs,
                                   _lpcc(tcfg, n_deltas=n_deltas))
    assert got.shape == (4, mask.shape[1], 28 * (n_deltas + 1))
    assert got.is_contiguous() and mask.is_contiguous()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert np.isfinite(got.numpy()).all()
    assert (got.numpy()[~mask.numpy()] == 0).all()
    got, want = got.numpy(), np.asarray(want)
    lpcc = np.arange(got.shape[-1]) % 28 >= 13
    np.testing.assert_allclose(got[..., ~lpcc], want[..., ~lpcc], rtol=2e-3,
                               atol=2e-2)
    scale = np.abs(want[..., lpcc]).max(axis=-1, keepdims=True)
    assert (np.abs(got[..., lpcc] - want[..., lpcc])
            <= 2e-2 + 2e-3 * scale).all()


def test_lpcc_route_is_the_signal_kernel(monkeypatch):
    """With LPC cepstra the packed frontend calls the signal kernel once,
    in its LPC-cepstra mode (the recursion in the kernel's tail) with CMVN
    inside, and never the frame-level kernel; CMVN is not applied a second
    time. On the CPU neither the LPC-cepstra kernel's counter
    (LPCC_SIGNAL_LAUNCHES) nor K1's moves."""
    calls = []
    real = gpu_frontend.packed_from_signals

    def spy(*a, **kw):
        calls.append((a[8], kw.get("fuse_lpc"), kw.get("n_lpcc")))
        return real(*a, **kw)

    def no_frames(*a, **kw):
        raise AssertionError("the frame-level kernel has no serving caller")
    monkeypatch.setattr(gpu_frontend, "packed_from_signals", spy)
    monkeypatch.setattr(gpu_frontend, "packed_from_frames", no_frames)
    fe = text.PackedFrontend(8000, _lpcc(tcfg), "cpu")
    sig, lens = _signals([8192, 6000], 8192, seed=24)
    before = gpu_frontend.LPCC_SIGNAL_LAUNCHES, gpu_frontend.LAUNCHES
    got, mask = fe(torch.from_numpy(sig), torch.from_numpy(lens))
    assert calls == [(True, True, 16)]
    assert (gpu_frontend.LPCC_SIGNAL_LAUNCHES,
            gpu_frontend.LAUNCHES) == before
    mfcc = got[..., :13]
    for b in range(2):
        v = mfcc[b][mask[b]]
        # normalized once: zero mean, unit population deviation
        np.testing.assert_allclose(v.mean(0).numpy(), 0, atol=1e-4)
        np.testing.assert_allclose(v.std(0, unbiased=False).numpy(), 1,
                                   rtol=1e-4)


@pytest.mark.parametrize("n_fft,n_lpcc,entry,counter", [
    (512, 16, "srt_lpcc_signals_frontend", "LPCC_SIGNAL_LAUNCHES"),
    (16384, 16, "srt_lpcc_signals_frontend", "LPCC_SIGNAL_LAUNCHES"),
    (512, 0, "srt_packed_frontend", "LAUNCHES"),
    (32768, 16, "srt_big_packed_frontend", "BIG_LAUNCHES")],
    ids=["lpcc_512", "lpcc_16384", "lpc_512", "lpcc_32768"])
def test_lpcc_route_on_the_card_is_one_kernel(monkeypatch, n_fft, n_lpcc,
                                              entry, counter):
    """On CUDA tensors packed_from_signals sends the LPC-cepstra mode below
    BIG_N to csrc/frontend_lpcc_signals.cu's entry point alone, with the
    signal tile's packed operator and no raw rows (its CMVN inside), and
    counts it in LPCC_SIGNAL_LAUNCHES; the LPC mode keeps K1's tile
    (LAUNCHES) and from BIG_N on the LPC cepstra keep the four-step route's
    raw rows (BIG_LAUNCHES). A failed launch raises and counts nothing. The
    library is a stand-in that records the C calls; the tensors CPU
    tensors that report the card."""
    import contextlib
    import types
    from speaker_recognition_tpu_torch import _build

    calls = []
    status = [0]

    class Lib:
        def __getattr__(self, name):
            if not name.endswith("_frontend"):
                raise AttributeError(name)
            return lambda *a: calls.append((name, a)) or status[0]

        @staticmethod
        def srt_error_string(err):
            return b"stand-in error"

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    ops = {}
    for name in ("signal_operator", "_packed_operator", "_big_operator"):
        monkeypatch.setattr(gpu_frontend, name,
                            lambda lib, mel, acorr, n, name=name:
                            ops.setdefault(name, torch.zeros(4)))
    monkeypatch.setattr(gpu_frontend, "_wide_rows", lambda *a: None)
    monkeypatch.setattr(gpu_frontend, "_big_scratch",
                        lambda *a: (7, torch.zeros(4)))
    cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    flen, B = n_fft // 2, 3
    nb = n_fft // 2 + 1
    fft = gpu_frontend.FftRoute(n_fft, cuda(torch.rand(flen)), 0.97, False,
                                cuda(torch.rand(nb, 26)),
                                cuda(torch.rand(nb, 16)))
    args = (cuda(torch.zeros(B, 4 * flen)),
            cuda(torch.ones(B, dtype=torch.int32)), None, None,
            cuda(torch.rand(26, 13)), None, 1e-35, flen // 2, True)
    counters = ("LAUNCHES", "LPCC_SIGNAL_LAUNCHES", "BIG_LAUNCHES")
    before = {c: getattr(gpu_frontend, c) for c in counters}
    feat = gpu_frontend.packed_from_signals(*args, fft=fft, n_lpcc=n_lpcc)
    T = (4 * flen - flen) // (flen // 2) + 1
    assert feat.shape == (B, T, 13 + 15)
    assert [c for c, _ in calls] == [entry]
    a = calls[0][1]
    if entry == "srt_lpcc_signals_frontend":
        assert ops.keys() == {"signal_operator"}
        assert len(a) == 22 and a[7] == B and a[12] == n_fft
        assert a[19:21] == (1, n_lpcc)  # CMVN inside, the cepstra's count
    elif entry == "srt_packed_frontend":
        assert ops.keys() == {"_packed_operator"} and len(a) == 22
    else:
        assert a[21] == n_lpcc and a[22] != 0  # the raw rows
    moved = {c: getattr(gpu_frontend, c) - before[c] for c in counters}
    assert moved == {c: int(c == counter) for c in counters}
    status[0] = 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        gpu_frontend.packed_from_signals(*args, fft=fft, n_lpcc=n_lpcc)
    assert {c: getattr(gpu_frontend, c) - before[c]
            for c in counters} == moved


def test_lpcc_mix_feature_matches_jax():
    """One utterance through mix_feature with LPC cepstra (B = 1 on the
    signal kernel's route) vs the JAX package's mix_feature."""
    sig = synth.synth_utterance("carol", 1.2, seed=8)
    got = text.mix_feature(synth.FS, sig, _lpcc(tcfg), device="cpu")
    want = np.asarray(jext.mix_feature(synth.FS, sig, _lpcc(jcfg)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def test_delta_masks_are_contiguous():
    """apply_deltas hands the scoring kernel a mask it can read through a
    raw pointer."""
    feat = torch.randn(3, 20, 5)
    mask = torch.arange(20)[None, :] < torch.tensor([20, 7, 0])[:, None]
    for nd in (0, 1, 2):
        f, m = text.apply_deltas(feat, mask, nd)
        assert f.is_contiguous() and m.is_contiguous()
        assert f.shape == (3, 20 - nd, 5 * (nd + 1))
        assert torch.equal(m, mask[:, nd:])


# -- (c) scoring at d = 102 and at 1024 components ---------------------------

def _bank_np(S, K, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _bob_features():
    """[B, T, 102] features of bob's MFCC + LPC-15 with two deltas at
    16 kHz, from the port's extractor, and their mask."""
    cfg = tcfg.FeatureConfig(mfcc=tcfg.bob_mfcc_config(), n_deltas=2)
    assert cfg.dim == 102
    sigs = [synth.synth_utterance(label, sec, 30 + i, 16000)
            for i, (label, sec) in enumerate([("alice", 1.0), ("bob", 0.7)])]
    L = 16384
    batch = np.zeros((2, L), np.float32)
    for i, s in enumerate(sigs):
        batch[i, :len(s)] = s
    feats, mask = text.extract_batch(
        torch.from_numpy(batch), torch.tensor([len(s) for s in sigs]), 16000,
        cfg)
    return feats.numpy(), mask.numpy()


SHAPES = {"d102": (3, 8, 102), "k1024": (2, 1024, 28)}


def _features(shape_id):
    if shape_id == "d102":
        return _bob_features()
    rng = np.random.RandomState(31)
    mask = np.arange(120)[None, :] < np.array([120, 77])[:, None]
    x = rng.randn(2, 120, 28).astype(np.float32)
    return np.where(mask[..., None], x, 0).astype(np.float32), mask


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_batched_plain_scores_match_jax(shape_id):
    """The plain batched bank score (what CPU callers run and the batched
    kernel is held to) vs models/gmm.batch_bank_avg_loglik and the Pallas
    wide kernel in interpret mode, float32 on both sides: means of sums of
    2d products per component in other orders, 2e-5 relative as
    tests/test_torch_serial.py."""
    S, K, d = SHAPES[shape_id]
    bank = _bank_np(S, K, d, seed=d + K)
    feats, mask = _features(shape_id)
    tb = tgmm.GmmBank.from_numpy(*bank, device="cpu")
    got = gpu_gmm.batch_bank_avg_loglik(tb, torch.from_numpy(feats),
                                        torch.from_numpy(mask)).numpy()
    jb = jgmm.GmmParams(*(jnp.asarray(a, jnp.float32) for a in bank))
    jf, jm = jnp.asarray(feats, jnp.float32), jnp.asarray(mask)
    assert got.shape == (feats.shape[0], S) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jgmm.batch_bank_avg_loglik(jb, jf, jm)), rtol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(pallas_gmm.batch_bank_avg_loglik(jb, jf, jm,
                                                         interpret=True)),
        rtol=2e-5)


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_serial_plain_scores_match_jax(shape_id):
    """The plain single-utterance bank score at the widened shapes vs
    models/gmm.bank_avg_loglik and the Pallas serial kernel (interpret)."""
    S, K, d = SHAPES[shape_id]
    bank = _bank_np(S, K, d, seed=d + K + 1)
    feats, mask = _features(shape_id)
    x, m = feats[1], mask[1]
    tb = tgmm.GmmBank.from_numpy(*bank, device="cpu")
    got = gpu_gmm.bank_avg_loglik(tb, torch.from_numpy(x),
                                  torch.from_numpy(m)).numpy()
    sums = gpu_gmm.bank_sum_loglik(tb, torch.from_numpy(x),
                                   torch.from_numpy(m)).numpy()
    jb = jgmm.GmmParams(*(jnp.asarray(a, jnp.float32) for a in bank))
    jx, jm = jnp.asarray(x, jnp.float32), jnp.asarray(m)
    np.testing.assert_allclose(
        got, np.asarray(jgmm.bank_avg_loglik(jb, jx, jm)), rtol=2e-5)
    np.testing.assert_allclose(
        sums, np.asarray(pallas_gmm.bank_sum_loglik(jb, jx, jm,
                                                    interpret=True)),
        rtol=2e-5)


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_gmmset_open_set_matches_jax_at_wide_shapes(shape_id):
    """GMMSet's serial scores, llr_scores and open-set decisions at d = 102
    and at 1024 components vs the JAX package's GMMSet from the same
    state."""
    S, K, d = SHAPES[shape_id]
    w, mu, sg = _bank_np(S + 1, K, d, seed=7)
    st = {"labels": [f"spk{i}" for i in range(S)], "weights": w[:S],
          "means": mu[:S], "sigmas": sg[:S], "reject_threshold": 0.5,
          "ubm_weights": w[S], "ubm_means": mu[S] * 0.2,
          "ubm_sigmas": sg[S] + 1.0}
    port, jax_gs = GMMSet.from_state(st, device="cpu"), JGMMSet.from_state(st)
    feats, mask = _features(shape_id)
    rng = np.random.RandomState(9)
    near = (mu[1][rng.randint(0, K, size=90)]
            + 0.3 * rng.randn(90, d)).astype(np.float32)
    for x in (feats[0][mask[0]], near):
        np.testing.assert_allclose(port._scores(x), jax_gs._scores(x),
                                   rtol=2e-5)
        (s, u), (js, ju) = port.llr_scores(x), jax_gs.llr_scores(x)
        np.testing.assert_allclose(s, js, rtol=2e-5)
        np.testing.assert_allclose(u, ju, rtol=2e-5)
        assert port.predict_one_with_rejection(x) == \
            jax_gs.predict_one_with_rejection(x)
    assert port.predict_one(near) == "spk1"


@pytest.mark.parametrize("d,row", [(28, 60), (102, 212), (130, 268), (5, 20)])
def test_component_operator_rows_follow_the_kernels(d, row):
    """The scoring kernels read rows of 2*dp + 4 floats with dp = d rounded
    up to 4 (csrc/gmm_lse.cuh row_floats), at any d: a, b, cw and padding
    where the kernels expect them."""
    dp = -(-d // 4) * 4
    assert row == 2 * dp + 4
    bank = tgmm.GmmBank.from_numpy(*_bank_np(2, 3, d, seed=d), device="cpu")
    comp = bank.component_operator(row)
    assert comp.shape == (2, 3, row) and comp.is_contiguous()
    flat = comp.reshape(6, row)
    assert torch.equal(flat[:, :d], bank.op[:d].T)
    assert torch.equal(flat[:, dp:dp + d], bank.op[d:].T)
    assert torch.equal(flat[:, 2 * dp], bank.cw)
    assert (flat[:, d:dp] == 0).all() and (flat[:, dp + d:2 * dp] == 0).all()
    assert (flat[:, 2 * dp + 1:] == 0).all()
