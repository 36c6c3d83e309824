"""The fused predict monolith's f32 route on the FFT tile (ops/gpu_predict,
K6/K7 on csrc/rfft_tile.cuh): its plain version
`fused_bank_predict_fft_reference`, which computes what the kernel
computes on the card, against the JAX package's pallas_predict.
fused_bank_predict (K6) and fused_bank_predict_wide (K7) in interpret mode
on the same numpy inputs; at the shapes the dense tile refused (48 kHz
with fft_size 4096, 96 kHz with fft_size 8192, 1024 components) against
the JAX extractor and models/gmm.batch_bank_avg_loglik; and the routes the
wrappers take."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.ops import pallas_predict  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    PackedFrontend)
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_predict  # noqa: E402

# tests/test_pallas_predict.py's tolerance for the fused kernels against
# the unfused program (and tests/test_torch_fused.py's): f32 frontends of
# different arithmetic, here an FFT against the TPU kernel's dense DFT
RTOL = ATOL = 2e-4
# against the JAX extractor at the wide shapes: the bound of
# tests/test_torch_limits.py on the features (2e-3 relative), which the
# per-speaker means of hundreds of frames carry at 1e-3
EXTRACT_RTOL = 1e-3


def _bank(S, K, d, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _batch(fs, lengths, padded, seed=0):
    """White noise at int16 scale, zero-padded (tests/test_pallas_predict.py's
    batch)."""
    rng = np.random.RandomState(seed)
    signals = np.zeros((len(lengths), padded), np.float32)
    for i, L in enumerate(lengths):
        signals[i, :L] = (rng.randn(L) * 3000).astype(np.float32)
    return signals, np.asarray(lengths, np.int64)


def _fft_scores(fe: PackedFrontend, signals, n_valid, bank_np):
    """The FFT-route plain monolith's [B, S] scores."""
    tbank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    return gpu_predict.fused_bank_predict_fft_reference(
        torch.from_numpy(signals), torch.from_numpy(n_valid), tbank,
        fe.frame_shift, fe.dct, fe.floor, fe.fft, fe.cmvn).numpy()


def _jax_fused(fe: PackedFrontend, signals, n_valid, bank_np, wide):
    jbank = jgmm.GmmParams(*(jnp.asarray(a) for a in bank_np))
    A = None if fe.A.shape[1] == 0 else fe.A.double().numpy()
    args = (jnp.asarray(signals), jnp.asarray(n_valid), jbank,
            fe.frame_shift, fe.D.double().numpy(), fe.W.double().numpy(),
            fe.dct.double().numpy(), fe.floor, A)
    if wide:
        return np.asarray(pallas_predict.fused_bank_predict_wide(
            *args, cmvn=fe.cmvn, interpret=True, utt_tile=2))
    return np.asarray(pallas_predict.fused_bank_predict(
        *args, cmvn=fe.cmvn, interpret=True))


def _valid(fe, lengths, padded):
    T = tcfg.n_frames(padded, fe.frame_len, fe.frame_shift)
    return fe.valid_frames(torch.from_numpy(lengths), T).numpy()


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()


def _fcfg(use_lpc=True):
    return tcfg.FeatureConfig(use_lpc=use_lpc)


@pytest.mark.parametrize("wide", [False, True], ids=["k6", "k7"])
@pytest.mark.parametrize("S,K", [(4, 32), (3, 8)])
def test_fft_route_matches_jax(S, K, wide):
    """The bench geometry (8 kHz, MFCC13 + LPC15) with both bank sizes of
    tests/test_torch_fused.py, against K6 and K7 in interpret mode."""
    fe = PackedFrontend(8000, _fcfg(), "cpu")
    rng = np.random.RandomState(0)
    lengths = rng.randint(5600, 8000, size=4)
    signals, lengths = _batch(8000, lengths, 8192)
    n_valid = _valid(fe, lengths, 8192)
    bank = _bank(S, K, fe.dct.shape[1] + fe.A.shape[1] - 1)
    _assert_close(_fft_scores(fe, signals, n_valid, bank),
                  _jax_fused(fe, signals, n_valid, bank, wide))


@pytest.mark.parametrize("wide", [False, True], ids=["k6", "k7"])
def test_fft_route_mfcc_only_matches_jax(wide):
    fe = PackedFrontend(8000, _fcfg(use_lpc=False), "cpu")
    signals, lengths = _batch(8000, [7000, 6100, 5800], 8192, seed=2)
    n_valid = _valid(fe, lengths, 8192)
    bank = _bank(2, 8, 13)
    _assert_close(_fft_scores(fe, signals, n_valid, bank),
                  _jax_fused(fe, signals, n_valid, bank, wide))


def test_fft_route_mixed_lengths_matches_jax():
    """A 0.1 s, a 0.5 s and a 3 s utterance in one padded batch: each is
    normalized and averaged over its own valid frames."""
    fe = PackedFrontend(8000, _fcfg(), "cpu")
    signals, lengths = _batch(8000, [800, 4000, 24000], 24576, seed=3)
    n_valid = _valid(fe, lengths, 24576)
    assert n_valid.tolist() == [5, 30, 186]
    bank = _bank(3, 8, 28)
    _assert_close(_fft_scores(fe, signals, n_valid, bank),
                  _jax_fused(fe, signals, n_valid, bank, False))


def test_fft_route_no_valid_frame_scores_zero():
    """An utterance with n_valid = 0 scores 0 for every speaker, as in the
    JAX kernel; the others are untouched by it."""
    fe = PackedFrontend(8000, _fcfg(), "cpu")
    signals, lengths = _batch(8000, [8000, 6000, 7000, 5000], 8192, seed=4)
    n_valid = _valid(fe, lengths, 8192)
    n_valid[1] = 0
    bank = _bank(3, 8, 28)
    got = _fft_scores(fe, signals, n_valid, bank)
    want = _jax_fused(fe, signals, n_valid, bank, True)
    assert (got[1] == 0).all() and (want[1] == 0).all()
    _assert_close(got, want)


def _jax_two_programs(fs, cfg_of, signals, lengths, bank_np):
    """The JAX package's unfused predict: its extractor, then
    models/gmm.batch_bank_avg_loglik."""
    feats, mask = jext.extract_batch(jnp.asarray(signals),
                                     jnp.asarray(lengths.astype(np.int32)),
                                     fs, cfg_of(jcfg))
    jbank = jgmm.GmmParams(*(jnp.asarray(a) for a in bank_np))
    return np.asarray(jgmm.batch_bank_avg_loglik(jbank, feats, mask))


def _fft(n):
    return lambda c: c.FeatureConfig(mfcc=c.MfccConfig(fft_size=n))


@pytest.mark.parametrize("fs,n_fft,lengths,padded", [
    (48000, 4096, [30000, 16000, 9000], 32768),
    (96000, 8192, [30000, 16000], 32768),
], ids=["48k_fft4096", "96k_fft8192"])
def test_fft_route_where_the_dense_tile_refused_matches_jax(fs, n_fft,
                                                            lengths, padded):
    """Frames of 1536 (48 kHz) and 3072 samples (96 kHz) with fft_size
    4096 and 8192: the dense tile had no room for them; the FFT route runs
    4096- and 8192-point FFTs."""
    fe = PackedFrontend(fs, _fft(n_fft)(tcfg), "cpu")
    assert fe.n_fft == n_fft and fe.frame_len == 2 * fe.frame_shift
    signals, lengths = _batch(fs, lengths, padded, seed=fs % 97)
    n_valid = _valid(fe, lengths, padded)
    bank = _bank(4, 16, 28, seed=7)
    got = _fft_scores(fe, signals, n_valid, bank)
    want = _jax_two_programs(fs, _fft(n_fft), signals, lengths, bank)
    _assert_close(got, want, rtol=EXTRACT_RTOL, atol=0.0)


def test_fft_route_with_1024_components_matches_jax():
    """A 4 x 1024 bank at d = 28: one speaker's components beside a frame
    tile passed a block's shared memory on the dense tile; the FFT route
    streams them."""
    fe = PackedFrontend(8000, _fcfg(), "cpu")
    signals, lengths = _batch(8000, [8000, 5000, 3000], 8192, seed=8)
    n_valid = _valid(fe, lengths, 8192)
    bank = _bank(4, 1024, 28, seed=9)
    got = _fft_scores(fe, signals, n_valid, bank)
    want = _jax_two_programs(8000, lambda c: c.FeatureConfig(), signals,
                             lengths, bank)
    _assert_close(got, want, rtol=EXTRACT_RTOL, atol=0.0)


def test_fft_route_agrees_with_the_dense_plain_version():
    """The two plain monoliths on one batch through PackedFrontend's
    operators: the FFT route and the dense DFT compute one function."""
    fe = PackedFrontend(8000, _fcfg(), "cpu")
    signals, lengths = _batch(8000, [8000, 4000, 6500], 8192, seed=10)
    nv = torch.from_numpy(_valid(fe, lengths, 8192))
    bank = tgmm.GmmBank.from_numpy(*_bank(4, 32, 28), device="cpu")
    sig = torch.from_numpy(signals)
    fft = gpu_predict.fused_bank_predict_fft_reference(
        sig, nv, bank, fe.frame_shift, fe.dct, fe.floor, fe.fft, fe.cmvn)
    dense = gpu_predict.fused_bank_predict_reference(
        sig, nv, bank, fe.frame_shift, fe.D, fe.W, fe.dct, fe.floor, fe.A,
        fe.cmvn)
    _assert_close(fft.numpy(), dense.numpy())


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return t.as_subclass(_CudaTyped)


def _cuda_args(fe, bank):
    sig = torch.zeros(2, 8192)
    nv = torch.full((2,), 30, dtype=torch.int32)
    cbank = types.SimpleNamespace(op=_cuda(bank.op), cw=_cuda(bank.cw),
                                  n_speakers=bank.n_speakers,
                                  n_mixtures=bank.n_mixtures, dim=bank.dim)
    fft = fe.fft._replace(window=_cuda(fe.window), mel=_cuda(fe.fft_mel),
                          acorr=_cuda(fe.fft_acorr))
    return ((_cuda(sig), _cuda(nv), cbank, fe.frame_shift, _cuda(fe.D),
             _cuda(fe.W), _cuda(fe.dct), fe.floor, _cuda(fe.A)), fft)


def test_f32_route_on_the_card_takes_the_fft_tile(monkeypatch):
    """On a CUDA tensor the f32 wrappers need the FFT route (fft=) and then
    build and launch the kernel or raise; the bf16 route takes the dense
    operators and refuses, in its own words, what the dense tile cannot
    hold. Nothing is counted on a refusal."""
    from speaker_recognition_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "load", no_nvcc)
    fe = PackedFrontend(8000, _fcfg(), "cpu")
    bank = tgmm.GmmBank.from_numpy(*_bank(2, 4, 28), device="cpu")
    args, fft = _cuda_args(fe, bank)
    before = (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES,
              gpu_predict.BF16_LAUNCHES)
    for fn in (gpu_predict.fused_bank_predict,
               gpu_predict.fused_bank_predict_wide):
        with pytest.raises(ValueError, match="fft="):
            fn(*args)
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(*args, fft=fft)
    with pytest.raises(RuntimeError, match="nvcc"):
        gpu_predict.fused_bank_predict(*args, mm_bf16=True)
    assert (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES,
            gpu_predict.BF16_LAUNCHES) == before


def test_bf16_route_keeps_the_dense_tile_limits(monkeypatch):
    """The bf16 route keeps the dense tile (it rounds the DFT operand D,
    which the FFT route does not have), whose limits are lifted: 48 kHz
    frames with fft_size 4096 and 128 mel filters + LPC (144 outputs, past
    the tile's 128) reach the kernel, with device rows for the sums of
    its output chunks (the JAX monolith serves both in interpret mode).
    The library is a stand-in that records the call."""
    import contextlib
    from speaker_recognition_tpu_torch import _build

    calls = {}

    class Lib:
        @staticmethod
        def srt_fused_component_row(d):
            return 2 * 128 + 4

        @staticmethod
        def srt_fused_scratch_floats(B, T, d, S):
            return B * T * d + B * S

        @staticmethod
        def srt_fused_bf16_wide_floats(B, T, nout):
            return B * T * 128 * -(-nout // 128) if nout > 128 else 0

        @staticmethod
        def srt_fused_predict(*args):
            calls["predict"] = args
            return 0

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    cfg = tcfg.FeatureConfig(mfcc=tcfg.MfccConfig(fft_size=4096,
                                                  n_filters=128))
    fe = PackedFrontend(48000, cfg, "cpu")
    bank = tgmm.GmmBank.from_numpy(*_bank(2, 4, cfg.dim), device="cpu")
    args, _ = _cuda_args(fe, bank)
    args[2].component_operator = lambda row: torch.zeros(2, 4, row)
    args = (_cuda(torch.zeros(2, 16384)),) + args[1:]
    before = gpu_predict.BF16_LAUNCHES
    out = gpu_predict.fused_bank_predict(*args, mm_bf16=True)
    assert out.shape == (2, 2)
    assert gpu_predict.BF16_LAUNCHES == before + 1
    c = calls["predict"]
    B, T = 2, (16384 - 1536) // 768 + 1
    assert c[9] != 0  # the sums rows of two chunks of 128 outputs
    assert c[11:15] == (B, 16384, T, 1536) and c[-2] == 1  # bf16
