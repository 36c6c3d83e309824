"""speaker_recognition_tpu_torch bank scoring (models/gmm, ops/gpu_gmm)
against the JAX package: the wide Pallas scoring kernel in interpret mode
and models/gmm.batch_bank_avg_loglik, on the same numpy inputs."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.ops import pallas_gmm  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_gmm  # noqa: E402


def _bank_np(S, K, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _feats(B, T, d, n_valid, seed, shift=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, d) + shift).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(n_valid)[:, None]
    return np.where(mask[..., None], x, 0).astype(np.float32), mask


def _both(bank_np, x, mask):
    jbank = jgmm.GmmParams(*(jnp.asarray(a) for a in bank_np))
    tbank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    got = gpu_gmm.batch_bank_avg_loglik(tbank, torch.from_numpy(x),
                                        torch.from_numpy(mask)).numpy()
    return jbank, got


@pytest.mark.parametrize("S,K,d,n_valid", [
    (3, 8, 28, [50, 37, 1, 0]),
    (2, 4, 13, [20, 20]),
    (1, 8, 56, [9, 30, 30]),
], ids=["bench_dim", "mfcc_only_dim", "deltas_dim"])
def test_matches_pallas_wide_kernel(S, K, d, n_valid):
    bank = _bank_np(S, K, d, seed=S * 10 + K)
    x, mask = _feats(len(n_valid), 50 if d == 28 else 30, d, n_valid, seed=d)
    jbank, got = _both(bank, x, mask)
    want = np.asarray(pallas_gmm.batch_bank_avg_loglik(
        jbank, jnp.asarray(x), jnp.asarray(mask), interpret=True))
    assert got.shape == (len(n_valid), S)
    # tests/test_pallas_gmm.py:27
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_matches_xla_wide_program():
    bank = _bank_np(3, 8, 28, seed=4)
    x, mask = _feats(4, 40, 28, [40, 12, 3, 0], seed=5)
    jbank, got = _both(bank, x, mask)
    want = np.asarray(jgmm.batch_bank_avg_loglik(
        jbank, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (got[3] == 0).all()  # no valid frame: 0 / max(0, 1)


def test_bank_operators_match():
    bank = _bank_np(2, 4, 6, seed=7)
    op, cw = tgmm.bank_operators(tgmm.GmmParams(*bank))
    jop, jcw = jgmm.bank_operators(jgmm.GmmParams(
        *(jnp.asarray(a, jnp.float64) for a in bank)))
    np.testing.assert_allclose(op, np.asarray(jop), rtol=1e-12)
    np.testing.assert_allclose(cw, np.asarray(jcw), rtol=1e-12)
    stacked = tgmm.stack_params([tgmm.GmmParams(*(a[i] for a in bank))
                                 for i in range(2)])
    for a, b in zip(stacked, bank):
        np.testing.assert_array_equal(a, b)


def test_underflow_floor():
    """A frame far from every component scores log(1e-15), as in
    models/gmm.per_frame_loglik (gmm.cc:482-492)."""
    bank = _bank_np(2, 4, 3, seed=8)
    x = np.full((1, 2, 3), 1e3, np.float32)
    mask = np.ones((1, 2), bool)
    jbank, got = _both(bank, x, mask)
    np.testing.assert_allclose(got, math.log(1e-15), rtol=1e-6)
    want = np.asarray(jgmm.batch_bank_avg_loglik(
        jbank, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_argmax_decisions_match():
    bank = _bank_np(3, 8, 20, seed=9)
    x = np.stack([np.random.RandomState(i).randn(60, 20) + bank[1][i, 0]
                  for i in range(3)]).astype(np.float32)
    mask = np.ones((3, 60), bool)
    jbank, got = _both(bank, x, mask)
    want = np.asarray(jgmm.batch_bank_avg_loglik(
        jbank, jnp.asarray(x), jnp.asarray(mask)))
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert list(got.argmax(-1)) == [0, 1, 2]


class _CudaTyped(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_request_raises_without_cuda():
    """On a CUDA tensor the wrapper launches its kernel or raises; it
    never runs the plain version."""
    bank_np = _bank_np(2, 4, 5, seed=1)
    x, mask = _feats(2, 10, 5, [10, 4], seed=2)
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    bank.op, bank.cw = cuda(bank.op), cuda(bank.cw)
    before = gpu_gmm.LAUNCHES
    with pytest.raises(RuntimeError):
        gpu_gmm.batch_bank_avg_loglik(bank, cuda(torch.from_numpy(x)),
                                      cuda(torch.from_numpy(mask)))
    assert gpu_gmm.LAUNCHES == before
    with pytest.raises(TypeError, match="mask"):
        gpu_gmm.batch_bank_avg_loglik(
            bank, cuda(torch.from_numpy(x)),
            cuda(torch.from_numpy(mask.astype(np.float32))))


def test_bank_shape_checks():
    w, m, s = _bank_np(2, 4, 5, seed=3)
    bank = tgmm.GmmBank.from_numpy(w, m, s, device="cpu")
    assert (bank.n_speakers, bank.n_mixtures, bank.dim) == (2, 4, 5)
    assert tuple(bank.op.shape) == (10, 8) and bank.op.dtype == torch.float32
    with pytest.raises(ValueError):
        tgmm.GmmBank(bank.op, bank.cw, 3, 4)
