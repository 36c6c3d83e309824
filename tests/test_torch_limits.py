"""The shapes the frontend kernels' tile was widened to, against the JAX
package on the same numpy inputs: a 4096-point FFT (44.1 and 48 kHz with
fft_size 4096, on the packed route, which takes K1, and on the full route,
which takes K5), 8192- and 16384-point FFTs (96 kHz with fft_size 8192 and
192 kHz with fft_size 16384 on the packed route, fft_size 8192 on the full
route), 128 mel filters with LPC (144 mel + autocorrelation outputs), more
than 256 outputs, 216 outputs at fft_size 1500 (the dense K5 template's
shape past its former 192), and LPC order 40 with 40 cepstra (the Levinson and the
CMVN past 32 columns). Each runs through the CPU's plain versions (the
dense operators) and through the FFT route's plain versions, which compute
what the kernels compute on the card; the FFT tile's operator layout at
the new shapes is checked against a model of csrc/rfft_tile.cuh, and the
wrappers no longer refuse a batch or a bank past the grid's 65535. The
limits lifted last: FFTs of 32768 and 65536 points (csrc/rfft_big.cuh's
route on the card), 616 outputs (chunks of 512 on the tile) and the bf16
monolith past its old dense tile."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402


def _signals(lengths, L, seed, scale=3000.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return sig, np.asarray(lengths, np.int32)


def _fft_route(monkeypatch):
    """Serve the frontends through the FFT route's plain versions, as the
    kernels do on the card (K1 at rfft_size(frame_len) points, K5 at
    fft_size points)."""
    def packed(signals, n_valid, D, W, dct, A, floor, fshift, cmvn,
               fft=None, fuse_lpc=True, mm_bf16=False, n_lpcc=0):
        assert not mm_bf16  # the f32 kernel's route
        return gpu_frontend.packed_from_signals_fft_reference(
            signals, n_valid, fft, dct, floor, fshift, cmvn, fuse_lpc,
            n_lpcc)

    def full(wp, C, S, mel, dct, floor, acorr, n_fft=None):
        return gpu_frontend.mfcc_from_frames_fft_reference(
            wp, mel, dct, floor, acorr, n_fft)
    monkeypatch.setattr(gpu_frontend, "packed_from_signals", packed)
    monkeypatch.setattr(gpu_frontend, "mfcc_from_frames", full)


def _extract_both(fs, cfg_of, mode, impl, monkeypatch, L=None):
    """(port features, JAX features, port mask, JAX mask) of a ragged
    batch with an empty utterance, on `mode`'s route, the port through
    `impl` ("dense": the CPU's plain versions; "fft": the FFT route's)."""
    if impl == "fft":
        _fft_route(monkeypatch)
    monkeypatch.setenv("SRTPU_FRONTEND", mode)
    L = L or 4096 * (-(-fs // 4096))
    sig, lens = _signals([L, int(0.6 * L), L // 5, 0], L, seed=fs % 97)
    want, wmask = jext._feature_fn(fs, cfg_of(jcfg), L, "float32", "off",
                                   "f32", mode, "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs, cfg_of(tcfg))
    return got.numpy(), np.asarray(want), mask.numpy(), np.asarray(wmask)


def _fft4096(c):
    return c.FeatureConfig(mfcc=c.MfccConfig(fft_size=4096))


@pytest.mark.parametrize("impl", ["dense", "fft"])
@pytest.mark.parametrize("mode", ["packed", "full"])
@pytest.mark.parametrize("fs", [48000, 44100], ids=["48k", "44k"])
def test_fft_size_4096_matches_jax(fs, mode, impl, monkeypatch):
    """fft_size 4096 at 44.1 and 48 kHz: the packed route (2*frame_len <=
    4096, so the default route; K1 runs a 4096-point FFT) and the full
    route (K5 at 4096 points) against the JAX extractor on the same route.
    Bound of tests/test_torch_fft.py: two f32 frontends of different
    arithmetic (an FFT or another product order)."""
    monkeypatch.setenv("SRTPU_FRONTEND", mode)
    fe = text.frontend(fs, _fft4096(tcfg), "cpu")
    assert fe.n_fft == 4096
    assert isinstance(fe, text.PackedFrontend if mode == "packed"
                      else text.FullFrontend)
    got, want, mask, wmask = _extract_both(fs, _fft4096, mode, impl,
                                           monkeypatch)
    np.testing.assert_array_equal(mask, wmask)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def _filters128(c):
    return c.FeatureConfig(mfcc=c.MfccConfig(n_filters=128))


@pytest.mark.parametrize("impl", ["dense", "fft"])
@pytest.mark.parametrize("fs,mode", [(8000, "packed"), (48000, "full")],
                         ids=["8k_packed", "48k_full"])
def test_128_filters_with_lpc_match_jax(fs, mode, impl, monkeypatch):
    """128 mel filters with LPC order 15: 144 mel + autocorrelation outputs,
    past the 128 the tile took before (it now takes 256)."""
    got, want, mask, wmask = _extract_both(fs, _filters128, mode, impl,
                                           monkeypatch,
                                           L=8192 if fs == 8000 else None)
    np.testing.assert_array_equal(mask, wmask)
    assert got.shape[-1] == 13 + 15
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def _dense216(c):
    return c.FeatureConfig(mfcc=c.MfccConfig(fft_size=1500, n_filters=200))


@pytest.mark.parametrize("impl", ["dense", "fft"])
def test_dense_template_216_outputs_matches_jax(impl, monkeypatch):
    """fft_size 1500 (not a power of two: the dense K5 template on the
    card) with 200 mel filters and LPC order 15, 216 mel + autocorrelation
    outputs, past the 192 the template took before, on the full route at
    8 kHz against the JAX extractor on the same route."""
    monkeypatch.setenv("SRTPU_FRONTEND", "full")
    fe = text.frontend(8000, _dense216(tcfg), "cpu")
    assert isinstance(fe, text.FullFrontend) and fe.n_fft == 1500
    assert fe.mel.shape[1] + fe.acorr.shape[1] == 216
    got, want, mask, wmask = _extract_both(8000, _dense216, "full", impl,
                                           monkeypatch, L=8192)
    np.testing.assert_array_equal(mask, wmask)
    assert got.shape[-1] == 13 + 15
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def _order40(c):
    return c.FeatureConfig(mfcc=c.MfccConfig(n_ceps=40),
                           lpc=c.LpcConfig(n_lpc=40))


@pytest.mark.parametrize("impl", ["dense", "fft"])
@pytest.mark.parametrize("fs", [8000, 16000], ids=["8k", "16k"])
def test_order_40_and_40_cepstra_through_mix_feature_match_jax(
        fs, impl, monkeypatch):
    """mix_feature with LPC order 40 and 40 cepstra (d = 80) against the JAX
    package's: the Levinson and the per-utterance CMVN past 32 columns
    (the tolerance of tests/test_torch_serial.py's mix_feature test; LPC of
    order 40 amplifies rounding a little more: 5e-3 absolute)."""
    if impl == "fft":
        _fft_route(monkeypatch)
    sig = synth.synth_utterance("carol", 1.7, seed=9, fs=fs)
    got = text.mix_feature(fs, sig, _order40(tcfg), device="cpu")
    want = np.asarray(jext.mix_feature(fs, sig, _order40(jcfg)))
    assert got.shape == want.shape and got.shape[1] == 80
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3)


def test_order_40_fused_lpc_matches_the_unfused_route():
    """K1's fused Levinson (the kernel's tail, here its plain version) and
    the raw-autocorrelation mode followed by the torch Levinson agree at
    order 40 and 40 cepstra."""
    fe = text.PackedFrontend(8000, _order40(tcfg), "cpu")
    sig, lens = _signals([8192, 5000], 8192, seed=4)
    T = tcfg.n_frames(8192, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(torch.from_numpy(lens), T)
    fused = gpu_frontend.packed_from_signals_fft_reference(
        torch.from_numpy(sig), nv, fe.fft, fe.dct, fe.floor, fe.frame_shift,
        True)
    ceps, r = gpu_frontend.packed_from_signals_fft_reference(
        torch.from_numpy(sig), nv, fe.fft, fe.dct, fe.floor, fe.frame_shift,
        True, fuse_lpc=False)
    assert fused.shape == (2, T, 80) and r.shape == (2, T, 41)
    torch.testing.assert_close(fused[..., :40], ceps)
    m = (torch.arange(T) < nv[:, None])[..., None]
    unfused = torch.where(m, text.levinson.lpc_from_autocorr(r), 0.0)
    torch.testing.assert_close(fused[..., 40:], unfused)


# -- the FFT tile's operator at the new shapes -------------------------------

class _TileShapes:
    """srt_fft_operator_shape in Python (csrc/rfft_tile.cuh): a power of two
    in [64, 16384]; 72, 128, 256 or 512 columns; rows of bins 0..N/2 padded
    to the operator chunk (rfft::ck), while the block's shared memory holds
    the tile. From N = 8192 on the tile stages no whole twiddle table and
    takes 4 (N = 8192) or 2 (N = 16384) frames."""

    MAX_SMEM = 232448

    @staticmethod
    def chunk(n, opl):
        if n >= 8192:
            return 8 if opl > 32 else 16
        if n >= 4096:
            return 4 if opl > 32 else 8 if opl > 16 else 16
        if n >= 2048:
            return 8 if opl > 32 else 16 if opl > 16 else 32
        return 16

    @classmethod
    def smem_bytes(cls, n, opl):
        ft = 2 if n >= 16384 else 4 if n >= 8192 else 16 if n >= 4096 else 32
        warps = 2 if n >= 16384 else 4 if n >= 4096 else 8
        nop = 8 * opl
        big = n >= 8192
        slots = n // 2 + (32 if big else n // 64)
        col = (16 + n // 64 - 32 if big else n // 4 - 32 if n >= 2048
               else 0)
        ys = -(-ft * max(n // 2 + 1, nop) // 4) * 4
        return 4 * ((0 if big else n) + 2 * warps * slots + ys
                    + cls.chunk(n, opl) * nop + 2 * col)

    def srt_fft_operator_shape(self, n_fft, nout, rows, cols, chunks):
        if n_fft < 64 or n_fft > 16384 or n_fft & (n_fft - 1):
            return -1
        opl = (9 if nout <= 72 else 16 if nout <= 128 else 32 if nout <= 256
               else 64)
        if self.smem_bytes(n_fft, opl) > self.MAX_SMEM:
            return -1
        ck = self.chunk(n_fft, opl)
        chunks._obj.value = max(1, -(-nout // 512))
        rows._obj.value = -(-(n_fft // 2 + 1) // ck) * ck * chunks._obj.value
        cols._obj.value = 8 * opl
        return 0


@pytest.mark.parametrize("n_fft,nmel,nac,shape", [
    (4096, 50, 16, (2064, 72)),
    (4096, 128, 16, (2056, 256)),
    (2048, 128, 16, (1040, 256)),
    (512, 128, 16, (272, 256)),
    (512, 50, 41, (272, 128)),
    (8192, 26, 16, (4112, 72)),
    (8192, 128, 16, (4112, 256)),
    (16384, 26, 16, (8208, 72)),
    (16384, 100, 16, (8208, 128)),
    (512, 250, 16, (272, 512)),
    (2048, 250, 16, (1032, 512)),
    (4096, 250, 16, (2052, 512)),
    (8192, 400, 16, (4104, 512)),
    (16384, 496, 16, (8200, 512)),
], ids=["4096", "4096_144_outputs", "2048_144_outputs", "512_144_outputs",
        "512_order40", "8192", "8192_144_outputs", "16384",
        "16384_116_outputs", "512_266_outputs", "2048_266_outputs",
        "4096_266_outputs", "8192_416_outputs", "16384_512_outputs"])
def test_packed_operator_at_the_widened_shapes(n_fft, nmel, nac, shape):
    """The FFT kernels' packed operator at the shapes the tile took on:
    [mel | acorr | 0] on rows 0..n_fft/2, zero rows and columns after; every
    geometry fits a block's 227 KB (the largest, N = 4096, 231,232 bytes;
    from N = 8192 on at most 215,440)."""
    lib = _TileShapes()
    nb = n_fft // 2 + 1
    mel = torch.rand(nb + 3, nmel, dtype=torch.float32)
    acorr = torch.rand(nb + 3, nac, dtype=torch.float32)
    op = gpu_frontend._packed_operator(lib, mel, acorr, n_fft)
    assert tuple(op.shape) == shape
    assert torch.equal(op[:nb, :nmel], mel[:nb])
    assert torch.equal(op[:nb, nmel:nmel + nac], acorr[:nb])
    assert (op[nb:] == 0).all() and (op[:, nmel + nac:] == 0).all()
    assert max(lib.smem_bytes(4096, o) for o in (9, 16, 32, 64)) == 231232
    assert max(lib.smem_bytes(n, o) for n in (8192, 16384)
               for o in (9, 16, 32, 64)) == 215440


def test_the_tile_refuses_only_32768_and_more_than_512_outputs():
    """What the FFT tile's operator refuses: 32768 points and more, which
    the wrappers send to the four-step route (csrc/rfft_big.cuh) instead.
    More than 512 mel + autocorrelation outputs are no longer refused: the
    operator stacks one 512-column operator per chunk of outputs, chunk c
    holding outputs [512 c, 512 c + 512), each on the bin rows of an
    operator of at most 512; every power of two from 64 to 16384 takes
    every width."""
    lib = _TileShapes()
    mel, acorr = torch.rand(16385, 50), torch.rand(16385, 16)
    with pytest.raises(ValueError, match=r"power of two in \[64, 16384\]"):
        gpu_frontend._packed_operator(lib, mel, acorr, 32768)
    wide = torch.rand(2049, 600)
    op = gpu_frontend._packed_operator(lib, wide, acorr, 4096)
    R = op.shape[0] // 2
    assert op.shape == (2 * 2052, 512)
    assert torch.equal(op[:2049], wide[:, :512])
    assert torch.equal(op[R:R + 2049, :88], wide[:, 512:])
    assert torch.equal(op[R:R + 2049, 88:104], acorr[:2049])
    assert (op[2049:R] == 0).all() and (op[R + 2049:] == 0).all()
    assert (op[R:, 104:] == 0).all()
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        for nmel in (50, 100, 200, 496, 600):
            op = gpu_frontend._packed_operator(lib, mel[:, :nmel], acorr, n)
            assert op.shape[0] >= n // 2 + 1, (n, nmel)


# -- 8192- and 16384-point FFTs through the extractor -------------------------

def _fft(n):
    return lambda c: c.FeatureConfig(mfcc=c.MfccConfig(fft_size=n))


@pytest.mark.parametrize("impl", ["dense", "fft"])
@pytest.mark.parametrize("mode", ["packed", "full"])
def test_96k_fft_size_8192_matches_jax(mode, impl, monkeypatch):
    """96 kHz with fft_size 8192: the packed route (frames of 3072 samples,
    an 8192-point FFT in K1) and the full route (K5 at 8192 points) against
    the JAX extractor on the same route, through extract_batch, a ragged
    batch of four short utterances (the bound of the 4096-point test)."""
    monkeypatch.setenv("SRTPU_FRONTEND", mode)
    fe = text.frontend(96000, _fft(8192)(tcfg), "cpu")
    assert fe.n_fft == 8192 and fe.frame_len == 3072
    got, want, mask, wmask = _extract_both(96000, _fft(8192), mode, impl,
                                           monkeypatch, L=20480)
    np.testing.assert_array_equal(mask, wmask)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert mask.sum() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def test_192k_fft_size_16384_through_mix_feature_matches_jax(monkeypatch):
    """192 kHz with fft_size 16384 on the packed route (frames of 6144
    samples, a 16384-point FFT in K1), the FFT route's plain version
    against the JAX extractor through mix_feature, one short utterance (the
    JAX package's dense operator alone is 6144 x 12288 here)."""
    _fft_route(monkeypatch)
    fe = text.frontend(192000, _fft(16384)(tcfg), "cpu")
    assert isinstance(fe, text.PackedFrontend) and fe.n_fft == 16384
    sig = synth.synth_utterance("bob", 0.2, seed=5, fs=192000)
    got = text.mix_feature(192000, sig, _fft(16384)(tcfg), device="cpu")
    want = np.asarray(jext.mix_feature(192000, sig, _fft(16384)(jcfg)))
    assert got.shape == want.shape and got.shape[0] > 5
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def test_192k_fft_size_8192_takes_the_full_route_and_matches_jax(
        monkeypatch):
    """192 kHz at fft_size 8192 < 2 * frame_len: the default route is the
    full spectrum at 8192 points (K5), the FFT route's plain version against
    the JAX extractor through mix_feature."""
    _fft_route(monkeypatch)
    fe = text.frontend(192000, _fft(8192)(tcfg), "cpu")
    assert isinstance(fe, text.FullFrontend) and fe.n_fft == 8192
    sig = synth.synth_utterance("alice", 0.2, seed=6, fs=192000)
    got = text.mix_feature(192000, sig, _fft(8192)(tcfg), device="cpu")
    want = np.asarray(jext.mix_feature(192000, sig, _fft(8192)(jcfg)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def _wide(c):
    return c.FeatureConfig(mfcc=c.MfccConfig(fft_size=4096, n_filters=250))


@pytest.mark.parametrize("impl", ["dense", "fft"])
@pytest.mark.parametrize("mode", ["packed", "full"])
def test_266_outputs_match_jax(mode, impl, monkeypatch):
    """250 mel filters with LPC order 15 at 48 kHz, fft_size 4096: 266 mel +
    autocorrelation outputs, past the 256 the tile took before (the fourth
    operator width takes 512)."""
    got, want, mask, wmask = _extract_both(48000, _wide, mode, impl,
                                           monkeypatch, L=16384)
    np.testing.assert_array_equal(mask, wmask)
    assert got.shape[-1] == 28
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


# -- no grid limit in the wrappers ------------------------------------------

class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return t.as_subclass(_CudaTyped)


class _FakeLib(_TileShapes):
    """The kernels' library as the wrappers call it, recording each launch's
    arguments instead of launching."""

    def __init__(self):
        self.calls = {}

    def _record(self, name):
        def launch(*args):
            self.calls[name] = args
            return 0
        return launch

    def __getattr__(self, name):
        if name.startswith("srt_") and name.endswith(("_frontend",
                                                      "_loglik")):
            return self._record(name)
        raise AttributeError(name)

    @staticmethod
    def srt_component_row(d):
        return 2 * (-(-d // 4) * 4) + 4

    @staticmethod
    def srt_fft_wide_floats(nframes, nout):
        return 0

    @staticmethod
    def srt_bank_warp_frames(d):
        return 64

    @staticmethod
    def srt_bank_tensor_row(d):
        """csrc/gmm_score.cu's tensor route: 2d <= 256."""
        return 128 * -(-2 * d // 8) + 8 if 1 <= d <= 128 else -1


def test_the_wrappers_take_a_batch_and_a_bank_past_65535(monkeypatch):
    """K1 and K2 with 70,000 utterances and K3 with 70,000 speakers go to
    their C entry points whole (each launches once per 65535 inside it),
    where a ValueError refused them before; the library is a stand-in that
    records the calls, the tensors CPU tensors that report the card."""
    import contextlib
    import types
    from speaker_recognition_tpu_torch import _build
    from speaker_recognition_tpu_torch.models.gmm import GmmBank
    from speaker_recognition_tpu_torch.ops import gpu_gmm

    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(gpu_gmm, "_stream", lambda plan: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    B = 70000
    fft = gpu_frontend.FftRoute(64, _cuda(torch.rand(32)), 0.97, False,
                                _cuda(torch.rand(33, 4)),
                                _cuda(torch.rand(33, 3)))
    feat = gpu_frontend.packed_from_signals(
        _cuda(torch.zeros(B, 32)), _cuda(torch.ones(B, dtype=torch.int32)),
        None, None, _cuda(torch.rand(4, 2)), None, 1e-35, 16, True, fft=fft)
    assert feat.shape == (B, 1, 4)
    assert lib.calls["srt_packed_frontend"][7] == B
    bank = GmmBank(_cuda(torch.rand(4, 3 * 2)), _cuda(torch.rand(3 * 2)), 3,
                   2)
    out = gpu_gmm.batch_bank_avg_loglik(
        bank, _cuda(torch.zeros(B, 1, 2)),
        _cuda(torch.ones(B, 1, dtype=torch.bool)))
    assert out.shape == (B, 3)
    assert lib.calls["srt_bank_avg_loglik"][5] == B
    big = GmmBank(_cuda(torch.rand(4, B)), _cuda(torch.rand(B)), B, 1)
    out = gpu_gmm.bank_avg_loglik(big, _cuda(torch.zeros(3, 2)),
                                  _cuda(torch.ones(3, dtype=torch.bool)))
    assert out.shape == (B,)
    assert lib.calls["srt_bank_sum_loglik"][6] == B


# -- the limits lifted last: N >= 32768, more than 512 outputs, K6's bf16 ----

def _fft_size(n, **mf):
    return lambda c: c.FeatureConfig(mfcc=c.MfccConfig(fft_size=n, **mf))


def _long_frames(c):
    """1 s frames at 8.2 kHz (8200 samples: past 8192, a 32768-point FFT on
    the packed route) with fft_size 32768, MFCC and LPC alike."""
    return c.FeatureConfig(
        mfcc=c.MfccConfig(win_length_ms=1000.0, win_shift_ms=500.0,
                          fft_size=32768),
        lpc=c.LpcConfig(win_length_ms=1000.0, win_shift_ms=500.0))


def test_32768_point_fft_on_the_packed_route_matches_jax(monkeypatch):
    """Frames longer than 8192 samples take a 32768-point FFT on the packed
    route (K1's four-step route on the card). The port's frontend builds no
    dense operators there, and its CPU route is the FFT route's plain
    version; against the JAX extractor's full-spectrum route at the same
    fft_size (the same function while fft_size >= 2 * frame_len; the JAX
    packed route's dense operator alone would be 8200 x 16400)."""
    fs, L = 8200, 8200 * 4
    fe = text.frontend(fs, _long_frames(tcfg), "cpu")
    assert isinstance(fe, text.PackedFrontend) and fe.n_fft == 32768
    assert fe.D is None and fe.W is None and fe.A is None
    sig, lens = _signals([L, int(0.7 * L), 9000], L, seed=11)
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), fs,
                                   _long_frames(tcfg))
    monkeypatch.setenv("SRTPU_FRONTEND", "full")
    want, wmask = jext._feature_fn(fs, _long_frames(jcfg), L, "float32",
                                   "off", "f32", "full", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert mask.numpy().sum() >= 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)


@pytest.mark.parametrize("impl", ["dense", "fft"])
@pytest.mark.parametrize("n_fft", [32768, 65536])
def test_fft_size_32768_and_65536_on_the_full_route_match_jax(
        n_fft, impl, monkeypatch):
    """fft_size 32768 and 65536 on the full route (K5's four-step route on
    the card), both plain versions against the JAX extractor, a ragged
    batch at 16 kHz (the dense C and S are 512 x 32769 at 65536)."""
    got, want, mask, wmask = _extract_both(16000, _fft_size(n_fft), "full",
                                           impl, monkeypatch, L=12288)
    np.testing.assert_array_equal(mask, wmask)
    assert np.isfinite(got).all() and mask.sum() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def _wide616(c):
    """600 mel filters + LPC-15 (616 outputs) at 8 kHz with 200 ms frames
    and fft_size 4096 (chip_smoke.py's WIDE616: none of the filters is
    empty, and the FFT route's operator is mel itself)."""
    return c.FeatureConfig(
        mfcc=c.MfccConfig(win_length_ms=200.0, win_shift_ms=100.0,
                          fft_size=4096, n_filters=600),
        lpc=c.LpcConfig(win_length_ms=200.0, win_shift_ms=100.0))


@pytest.mark.parametrize("mode", ["packed", "full"])
def test_616_outputs_match_jax(mode, monkeypatch):
    """616 outputs (past the tile's 512): the FFT route's plain versions
    (what the chunked tile computes on the card) against the JAX
    extractor's full route. The filters are two bins wide at low
    frequencies, where a dense route's cancellation would decide the
    comparison (chip_smoke.py phase 16), so the JAX side takes the full
    spectrum's bins as they are."""
    _fft_route(monkeypatch)
    monkeypatch.setenv("SRTPU_FRONTEND", mode)
    L = 16384
    sig, lens = _signals([L, 9000, 4000], L, seed=5)
    fe = text.frontend(8000, _wide616(tcfg), "cpu")
    assert fe.n_fft == 4096 and fe.dct.shape[0] == 600
    got, mask = text.extract_batch(torch.from_numpy(sig),
                                   torch.from_numpy(lens), 8000,
                                   _wide616(tcfg))
    monkeypatch.setenv("SRTPU_FRONTEND", "full")
    want, wmask = jext._feature_fn(8000, _wide616(jcfg), L, "float32", "off",
                                   "f32", "full", "default")(
        jnp.asarray(sig), jnp.asarray(lens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert np.isfinite(np.asarray(want)).all() and mask.numpy().sum() > 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-2)


def _empty_filters(c):
    """600 mel filters at 48 kHz with fft_size 4096 and 32 ms frames: nine
    filters hold no bin of the 4096-point spectrum, and the low ones are
    two bins wide."""
    return c.FeatureConfig(mfcc=c.MfccConfig(fft_size=4096, n_filters=600))


def test_empty_filters_follow_the_float64_reference(monkeypatch):
    """Where filters are empty or two bins wide, the f32 routes of the JAX
    package part: its default packed route gets those filters' energy from
    the dense W = H . mel by cancellation (3.2e-2 from its own float64
    route on cepstra here), its XLA full route takes log(0) (non-finite
    cepstra), and its Pallas full kernel (interpret mode) floors the mel
    energy as the port does. The port's FFT route, what K1 and K5 compute
    on the card, is held to the float64 reference and to that kernel at
    the MFCC tolerance; the JAX default route is the farther of the two
    from the float64 reference."""
    fs, L = 48000, 16384
    fe = text.frontend(fs, _empty_filters(tcfg), "cpu")
    assert fe.n_fft == 4096 and int((fe.fft_mel.sum(0) == 0).sum()) == 9
    sig, lens = _signals([L, 10000, 4000], L, seed=5)

    def jax_route(mode, pallas, dtype="float32"):
        monkeypatch.setenv("SRTPU_FRONTEND", mode)
        out, m = jext._feature_fn(fs, _empty_filters(jcfg), L, dtype,
                                  pallas, "f32", mode, "default")(
            jnp.asarray(sig.astype(dtype)), jnp.asarray(lens))
        return np.asarray(out), np.asarray(m)

    ref, mask = jax_route("packed", "off", "float64")
    default, _ = jax_route("packed", "off")
    xla_full, _ = jax_route("full", "off")
    k5, _ = jax_route("full", "interpret")
    _fft_route(monkeypatch)
    monkeypatch.setenv("SRTPU_FRONTEND", "packed")
    got, gmask = text.extract_batch(torch.from_numpy(sig),
                                    torch.from_numpy(lens), fs,
                                    _empty_filters(tcfg))
    got = got.numpy()
    np.testing.assert_array_equal(gmask.numpy(), mask)
    assert not np.isfinite(xla_full[mask]).all()
    for want in (ref, k5):
        np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-3)
    port_off = np.abs(got[mask] - ref[mask]).max()
    assert np.abs(default[mask] - ref[mask]).max() > 10 * port_off


@pytest.mark.parametrize("fs,mf", [(8000, dict(n_filters=128)),
                                   (48000, dict(fft_size=4096))],
                         ids=["144_outputs", "48k_fft4096"])
def test_bf16_monolith_past_its_old_limits_matches_jax(fs, mf):
    """K6's bf16 route at the shapes its dense tile refused before (more
    than 128 outputs; 48 kHz frames with fft_size 4096): the port's plain
    version against pallas_predict.fused_bank_predict(mm_bf16=True) in
    interpret mode, which takes both (tests/test_torch_fused.py's
    tolerance)."""
    from speaker_recognition_tpu.models import gmm as jgmm
    from speaker_recognition_tpu.ops import pallas_predict
    from speaker_recognition_tpu_torch.models import gmm as tgmm
    from speaker_recognition_tpu_torch.ops import gpu_predict

    fe = text.PackedFrontend(fs, tcfg.FeatureConfig(
        mfcc=tcfg.MfccConfig(**mf)), "cpu")
    rows = 16
    L = rows * fe.frame_shift
    sig, _ = _signals([L, L], L, seed=2)
    nv = np.array([rows - 1, rows // 2], np.int32)
    rng = np.random.RandomState(1)
    d = 28
    bank = (rng.dirichlet(np.ones(4), size=2).astype(np.float32),
            rng.randn(2, 4, d).astype(np.float32),
            (0.5 + rng.rand(2, 4, d)).astype(np.float32))
    want = pallas_predict.fused_bank_predict(
        jnp.asarray(sig), jnp.asarray(nv),
        jgmm.GmmParams(*(jnp.asarray(a) for a in bank)), fe.frame_shift,
        fe.D.numpy(), fe.W.numpy(), fe.dct.numpy(), fe.floor, fe.A.numpy(),
        interpret=True, mm_bf16=True)
    got = gpu_predict.fused_bank_predict(
        torch.from_numpy(sig), torch.from_numpy(nv),
        tgmm.GmmBank.from_numpy(*bank, device="cpu"), fe.frame_shift, fe.D,
        fe.W, fe.dct, fe.floor, fe.A, mm_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert (got.numpy().argmax(-1) == np.asarray(want).argmax(-1)).all()
