"""Three public helpers of the JAX package that the port now has, each held
to the JAX function on the same inputs: ops/levinson.autocorrelation and
lpc_from_frames, features/extract.diff_feature, and utils/native_io.
load_library."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.features import extract as jext  # noqa: E402
from speaker_recognition_tpu.ops import levinson as jlev  # noqa: E402
from speaker_recognition_tpu.utils import native_io as jio  # noqa: E402
from speaker_recognition_tpu_torch.features import (  # noqa: E402
    extract as text)
from speaker_recognition_tpu_torch.ops import levinson as tlev  # noqa: E402
from speaker_recognition_tpu_torch.utils import native_io as tio  # noqa: E402

# f32: the same sums of 256 products in another order; f64: a few ulps
TOL = {np.float32: 2e-5, np.float64: 1e-12}


def _frames(dt, seed=0):
    """Windowed noise frames [3, 5, 256], one of them all zero (its LPC
    is 0/0, zeroed)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 5, 256) * np.hamming(256)
    x[1, 2] = 0.0
    return x.astype(dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_autocorrelation_and_lpc_from_frames_match_jax(dt):
    x = _frames(dt)
    r = tlev.autocorrelation(torch.from_numpy(x), 15)
    want_r = np.asarray(jlev.autocorrelation(jnp.asarray(x), 15))
    assert r.shape == (3, 5, 16) and r.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(r.numpy(), want_r, rtol=TOL[dt],
                               atol=TOL[dt] * np.abs(want_r).max())
    a = tlev.lpc_from_frames(torch.from_numpy(x), 15)
    want = np.asarray(jlev.lpc_from_frames(jnp.asarray(x), 15))
    assert a.shape == (3, 5, 15) and (a[1, 2] == 0).all()
    np.testing.assert_allclose(a.numpy(), want, rtol=50 * TOL[dt],
                               atol=50 * TOL[dt])


@pytest.mark.parametrize("nd", [1, 2])
def test_diff_feature_matches_jax(nd):
    f = np.random.RandomState(1).randn(40, 7)
    np.testing.assert_array_equal(text.diff_feature(f, nd),
                                  jext.diff_feature(f, nd))
    with pytest.raises(ValueError, match="nd"):
        text.diff_feature(f, 3)


def test_load_library_matches_jax(monkeypatch):
    """Public, loaded once and shared by read_wav and load_batch; both
    packages build or find the same native library (or neither can), and
    with build_if_missing=False a missing library is None, not a build."""
    got, want = tio.load_library(), jio.load_library()
    assert (got is None) == (want is None)
    if got is not None:
        assert got._name == want._name
        for fn in ("wavio_read", "wavio_load_batch", "wavio_remove_silence"):
            assert getattr(got, fn).restype == getattr(want, fn).restype
    assert tio.load_library() is got
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_lib_tried", False)
    monkeypatch.setattr(tio, "_LIB_PATH", "/nonexistent/libwavio.so")
    assert tio.load_library(build_if_missing=False) is None
