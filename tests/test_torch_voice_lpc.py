"""K1's LPC on near-singular frames (chip_smoke.py phase 20): how far the
JAX package's own f32 routes part from its float64 route on the same voice.

Phase 20 holds K1 (CMVN off) on the sequence-sharded path's 60 s voice
(testdata/synth.voices, formant poles up to radius 0.97) against the
float64 route by two numbers: the cepstra's max |d| and the frames whose
LPC parts past LPC_ATOL / LPC_RTOL. Here the same two numbers are read on
the CPU for the JAX package's f32 routes, the Pallas signal kernel in
interpret mode and the XLA packed extractor, on the first MAX_UTT_ROWS rows
of that voice (the longest utterance the JAX package serves through its
kernel), beside the port's two f32 plain versions. And K1's in-kernel
Levinson (csrc/packed_tile.cuh levinson_in_place, the recursion in its
order in f32) is run in numpy on the FFT route's f32 autocorrelation,
beside the same recursion in float64: both part on nearly as many frames
(within 5%), so the recursion's precision decides little there; the f32
autocorrelation does.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_voice_lpc.py -q -s
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.ops import pallas_frontend  # noqa: E402
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, n_frames)
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402

FS, FSHIFT, FLEN = 8000, 128, 256
# chip_smoke.py's LPC bounds and phase 20's factor
LPC_ATOL, LPC_RTOL = 1e-2, 1e-3
VOICE_FACTOR = 2.0
# one near-singular frame parts past the bounds in a share of this size or
# more on every f32 route (16-29% measured on this voice)
PARTED_SHARE = 0.1


@pytest.fixture(scope="module")
def voice():
    """Phase 20's voice, cut to pallas_frontend.MAX_UTT_ROWS rows: [1, Lp]
    signals, [1] valid frames, the float64 route's features (CMVN off)."""
    sig = synth.voice_utterance(synth.voices(1, seed=2000)[0], 60.0, 2001)
    rows = pallas_frontend.MAX_UTT_ROWS
    x = np.zeros((1, rows * FSHIFT), np.float32)
    x[0] = sig[:rows * FSHIFT]
    T = n_frames(x.shape[1], FLEN, FSHIFT)
    nv = torch.tensor([T], dtype=torch.int32)
    fe64 = text.PackedFrontend(FS, FeatureConfig(), "cpu", torch.float64)
    f64 = gpu_frontend.packed_from_signals_reference(
        torch.from_numpy(x).double(), nv, fe64.D, fe64.W, fe64.dct, fe64.A,
        fe64.floor, FSHIFT, False)[0]
    return x, nv, f64


def _parted(got, f64) -> tuple:
    """Phase 20's two numbers: (cepstra max |d|, frames whose LPC parts
    past the bounds) of [T, 28] features against the float64 route's."""
    dv = (torch.as_tensor(np.asarray(got, np.float64)) - f64).abs()
    bad = ((dv[:, 13:] > LPC_ATOL)
           & (dv[:, 13:] > LPC_RTOL * f64[:, 13:].abs())).any(1)
    return float(dv[:, :13].max()), int(bad.sum())


def _levinson(r, order):
    """csrc/packed_tile.cuh levinson_in_place in numpy at r's dtype: the
    recursion in K1's order, a symmetric pair of coefficients a step,
    non-finite coefficients zeroed."""
    dt = r.dtype.type
    a = np.zeros(order, r.dtype)
    e = r[0]
    for i in range(1, order + 1):
        s = r[i]
        for j in range(1, i):
            s = dt(s + dt(a[j - 1] * r[i - j]))
        k = dt(-s / e)
        j, m = 1, i - 1
        while j <= m:
            lo, hi = a[j - 1], a[m - 1]
            a[j - 1] = dt(lo + dt(k * hi))
            if j < m:
                a[m - 1] = dt(hi + dt(k * lo))
            j, m = j + 1, m - 1
        a[i - 1] = k
        e = dt(e * dt(1 - dt(k * k)))
    return np.where(np.isfinite(a), a, 0)


def test_jax_f32_routes_part_from_float64_as_the_ports(voice):
    """The near-singular frames part every f32 route from float64, the
    JAX package's own: its Pallas K1 and its XLA packed extractor part on
    at least PARTED_SHARE of the frames, and the port's f32 plain versions
    part on at most VOICE_FACTOR times as many as the farther JAX route
    (phase 20 holds K1 on the card to the plain versions in turn)."""
    x, nv, f64 = voice
    T = f64.shape[0]
    fe = text.PackedFrontend(FS, FeatureConfig(), "cpu")
    ceps, lpc = pallas_frontend.packed_from_signals(
        jnp.asarray(x, jnp.float32), FSHIFT, fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor, fe.A.numpy(), interpret=True,
        n_valid=jnp.asarray(nv.numpy()), cmvn=False, fuse_lpc=True)
    cfg = jcfg.FeatureConfig(mfcc=jcfg.MfccConfig(cmvn=False))
    xla, _ = jext._feature_fn(FS, cfg, x.shape[1], "float32", "off", "f32")(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(np.array([x.shape[1]], np.int32)))
    s = torch.from_numpy(x)
    parted = {
        "JAX Pallas K1": _parted(np.concatenate(
            [np.asarray(ceps)[0], np.asarray(lpc)[0]], -1), f64),
        "JAX XLA packed": _parted(np.asarray(xla)[0], f64),
        "port dense": _parted(gpu_frontend.packed_from_signals_reference(
            s, nv, fe.D, fe.W, fe.dct, fe.A, fe.floor, FSHIFT, False)[0],
            f64),
        "port FFT route": _parted(
            gpu_frontend.packed_from_signals_fft_reference(
                s, nv, fe.fft, fe.dct, fe.floor, FSHIFT, False)[0], f64)}
    for name, (d_ceps, frames) in parted.items():
        print(f"{name} f32 (CMVN off) vs the float64 route, {T} frames: "
              f"cepstra max|d| {d_ceps:.3e}, frames past the LPC tolerance "
              f"{frames} ({frames / T:.1%})")
    jax_most = max(parted["JAX Pallas K1"][1], parted["JAX XLA packed"][1])
    for name in ("JAX Pallas K1", "JAX XLA packed"):
        assert parted[name][1] >= PARTED_SHARE * T, name
    for name in ("port dense", "port FFT route"):
        assert parted[name][1] <= VOICE_FACTOR * jax_most, name


# the share by which a float64 recursion may change the parted frames
RECURSION_SHARE = 0.05


def test_levinson_precision_decides_little_on_the_voice(voice):
    """K1's recursion in f32 and the same recursion in float64, each on the
    FFT route's f32 autocorrelation, part from float64 on nearly as many
    frames (699 and 704 of 2,559 measured): the f32 autocorrelation, not
    the recursion, decides them, so a float64 recursion in K1 would not
    bring it nearer."""
    x, nv, f64 = voice
    fe = text.PackedFrontend(FS, FeatureConfig(), "cpu")
    ceps, r = gpu_frontend.packed_from_signals_fft_reference(
        torch.from_numpy(x), nv, fe.fft, fe.dct, fe.floor, FSHIFT, False,
        fuse_lpc=False)
    ceps, r = ceps[0].numpy(), r[0].numpy()
    counts = {}
    for dt in (np.float32, np.float64):
        lpc = np.stack([_levinson(row.astype(dt), r.shape[1] - 1)
                        for row in r])
        counts[dt.__name__] = _parted(np.concatenate([ceps, lpc], -1), f64)
        print(f"FFT route's f32 autocorrelation, K1's recursion in "
              f"{dt.__name__}: frames past the LPC tolerance "
              f"{counts[dt.__name__][1]} of {len(r)}")
    c32, c64 = counts["float32"][1], counts["float64"][1]
    assert c32 > 0 and abs(c32 - c64) <= RECURSION_SHARE * c32
