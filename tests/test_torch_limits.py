"""The shapes the frontend kernels' tile was widened to, against the JAX
package on the same numpy inputs: a 4096-point FFT (44.1 and 48 kHz with
fft_size 4096, on the packed route, which takes K1, and on the full route,
which takes K5), 128 mel filters with LPC (144 mel + autocorrelation
outputs), and LPC order 40 with 40 cepstra (the Levinson and the CMVN past
32 columns). Each runs through the CPU's plain versions (the dense
operators) and through the FFT route's plain versions, which compute what
the kernels compute on the card; the FFT tile's operator layout at the new
shapes is checked against a model of csrc/rfft_tile.cuh."""

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
    in [64, 4096]; 72, 128 or 256 columns; rows of bins 0..N/2 padded to the
    operator chunk (16; 32 at N = 2048 below 256 columns; 8 at N = 4096 for
    256 columns), while the block's shared memory holds the tile."""

    @staticmethod
    def chunk(n, opl):
        if n >= 4096:
            return 8 if opl > 16 else 16
        return (16 if opl > 16 else 32) if n >= 2048 else 16

    @classmethod
    def smem_bytes(cls, n, opl):
        ft, warps = (16, 4) if n >= 4096 else (32, 8)
        nop = 8 * opl
        col = n // 4 - 32 if n >= 2048 else 0
        return 4 * (n + 2 * warps * (n // 2 + n // 64)
                    + ft * max(n // 2 + 1, nop) + cls.chunk(n, opl) * nop
                    + 2 * col)

    def srt_fft_operator_shape(self, n_fft, nout, rows, cols):
        if n_fft < 64 or n_fft > 4096 or n_fft & (n_fft - 1):
            return -1
        opl = 9 if nout <= 72 else 16 if nout <= 128 else 32 if nout <= 256 \
            else 0
        if opl == 0 or self.smem_bytes(n_fft, opl) > 232448:
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
], ids=["4096", "4096_144_outputs", "2048_144_outputs", "512_144_outputs",
        "512_order40"])
def test_packed_operator_at_the_widened_shapes(n_fft, nmel, nac, shape):
    """The FFT kernels' packed operator at the shapes the tile took on:
    [mel | acorr | 0] on rows 0..n_fft/2, zero rows and columns after; every
    geometry fits a block's 227 KB (the largest, N = 4096, 231,232 bytes)."""
    lib = _TileShapes()
    nb = n_fft // 2 + 1
    mel = torch.rand(nb + 3, nmel, dtype=torch.float32)
    acorr = torch.rand(nb + 3, nac, dtype=torch.float32)
    op = gpu_frontend._packed_operator(lib, mel, acorr, n_fft)
    assert tuple(op.shape) == shape
    assert torch.equal(op[:nb, :nmel], mel[:nb])
    assert torch.equal(op[:nb, nmel:nmel + nac], acorr[:nb])
    assert (op[nb:] == 0).all() and (op[:, nmel + nac:] == 0).all()
    assert max(lib.smem_bytes(4096, o) for o in (9, 16, 32)) == 231232


def test_the_tile_refuses_only_8192_and_more_than_256_outputs():
    """What the FFT tile still refuses, with the wrapper's message: 8192
    points (fft_size 8192 on the full route, or frames longer than 2048
    samples on the packed route, as at 96 kHz) and more than 256 mel +
    autocorrelation outputs."""
    lib = _TileShapes()
    mel, acorr = torch.rand(4097, 50), torch.rand(4097, 16)
    with pytest.raises(ValueError, match="8192"):
        gpu_frontend._packed_operator(lib, mel, acorr, 8192)
    with pytest.raises(ValueError, match="at most 256 outputs"):
        gpu_frontend._packed_operator(lib, torch.rand(2049, 250), acorr,
                                      4096)
