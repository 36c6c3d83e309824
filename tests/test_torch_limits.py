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
wrappers no longer refuse a batch or a bank past the grid's 65535."""

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
               fft=None, fuse_lpc=True):
        return gpu_frontend.packed_from_signals_fft_reference(
            signals, n_valid, fft, dct, floor, fshift, cmvn, fuse_lpc)

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

    def srt_fft_operator_shape(self, n_fft, nout, rows, cols):
        if n_fft < 64 or n_fft > 16384 or n_fft & (n_fft - 1):
            return -1
        opl = (9 if nout <= 72 else 16 if nout <= 128 else 32 if nout <= 256
               else 64 if nout <= 512 else 0)
        if opl == 0 or self.smem_bytes(n_fft, opl) > self.MAX_SMEM:
            return -1
        ck = self.chunk(n_fft, opl)
        rows._obj.value = -(-(n_fft // 2 + 1) // ck) * ck
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
    """What the FFT tile still refuses, with the wrapper's message: 32768
    points and more (fft_size >= 32768 on the full route, or frames longer
    than 8192 samples on the packed route) and more than 512 mel +
    autocorrelation outputs; every power of two from 64 to 16384 takes
    every width up to 512 outputs."""
    lib = _TileShapes()
    mel, acorr = torch.rand(16385, 50), torch.rand(16385, 16)
    with pytest.raises(ValueError, match="32768 or more"):
        gpu_frontend._packed_operator(lib, mel, acorr, 32768)
    with pytest.raises(ValueError, match="at most 512 outputs"):
        gpu_frontend._packed_operator(lib, torch.rand(2049, 500), acorr,
                                      4096)
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        for nmel in (50, 100, 200, 496):
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
    def srt_bank_warp_frames(d):
        return 64


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
    assert lib.calls["srt_packed_frontend"][6] == B
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
