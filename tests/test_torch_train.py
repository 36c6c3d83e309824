"""speaker_recognition_tpu_torch's EM training (models/gmm, tools/ubm)
against the JAX package and the float64 oracle of tests/oracles.py, on the
same numpy inputs. torch's generator cannot give jax.random's numbers, so
parity is "equal EM from an identical init" (fit_from_params on both
sides); the port's own init is held to determinism and its definition."""

import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
import oracles  # noqa: E402

from speaker_recognition_tpu.config import GmmConfig as JGmmConfig  # noqa: E402
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.tools import ubm as jubm  # noqa: E402
from speaker_recognition_tpu_torch.config import GmmConfig  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.tools import ubm as tubm  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization  # noqa: E402

# float64 on both sides: the EM products are summed in other orders by
# torch and XLA, ~1e-15 per step; 1e-9 relative leaves room for the
# amplification of a few dozen iterations.
F64_RTOL = 1e-9


def make_data(n, d, K, seed):
    rng = np.random.RandomState(seed)
    true_means = rng.randn(K, d) * 3
    true_sigmas = 0.5 + rng.rand(K, d)
    comps = rng.randint(0, K, size=n)
    return true_means[comps] + rng.randn(n, d) * true_sigmas[comps]


def rand_params(S, K, d, seed):
    rng = np.random.RandomState(seed)
    w = rng.rand(S, K) + 0.1
    w /= w.sum(axis=-1, keepdims=True)
    return w, rng.randn(S, K, d), 0.5 + rng.rand(S, K, d)


def padded_bank(lengths, d, K, seed, T=None):
    """[S, T, d] speakers of the given valid lengths, zero-padded."""
    T = T or max(lengths)
    X = np.zeros((len(lengths), T, d))
    mask = np.zeros((len(lengths), T), bool)
    for s, n in enumerate(lengths):
        X[s, :n] = make_data(n, d, K, seed + s) * (1 + 0.5 * s)
        mask[s, :n] = True
    return X, mask


def t64(*arrays):
    return [torch.as_tensor(a, dtype=torch.float64) if a.dtype != bool
            else torch.as_tensor(a) for a in arrays]


def tparams(w, mu, sg):
    return tgmm.GmmParams(*t64(w, mu, sg))


def assert_params_close(got, want, rtol=F64_RTOL, atol=1e-12):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def test_one_em_step_matches_oracle():
    X = make_data(400, 6, 3, seed=5)
    w, mu, sg = rand_params(1, 4, 6, seed=6)
    stats = tgmm.sufficient_stats(tparams(w, mu, sg),
                                  *t64(X[None], np.ones((1, 400), bool)))
    new = tgmm.m_step(stats, GmmConfig(n_mixtures=4))
    ref_w, ref_mu, ref_sg, _, ref_Nk = oracles.oracle_gmm_em_iteration(
        X, w[0], mu[0], sg[0])
    # the tolerances of tests/test_gmm.py:63-66 (same oracle, float64)
    np.testing.assert_allclose(stats.N_k[0].numpy(), ref_Nk, rtol=1e-8)
    np.testing.assert_allclose(new.weights[0].numpy(), ref_w, rtol=1e-8)
    np.testing.assert_allclose(new.means[0].numpy(), ref_mu, rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(new.sigmas[0].numpy(), ref_sg, rtol=1e-6,
                               atol=1e-9)


def test_density_matches_jax():
    X = make_data(60, 5, 3, seed=1)
    w, mu, sg = rand_params(2, 3, 5, seed=2)
    Xf = np.concatenate([X[:30], np.full((30, 5), 60.0)])  # floor frames
    for s in range(2):
        jp = jgmm.GmmParams(*(jnp.asarray(a[s]) for a in (w, mu, sg)))
        want_lg = np.asarray(jgmm.log_gaussians(jnp.asarray(Xf), jp.means,
                                                jp.sigmas))
        want_pf = np.asarray(jgmm.per_frame_loglik(jp, jnp.asarray(Xf)))
        got_lg = tgmm.log_gaussians(*t64(Xf, mu[s], sg[s])).numpy()
        got_pf = tgmm.per_frame_loglik(tparams(w[s], mu[s], sg[s]),
                                       *t64(Xf)).numpy()
        np.testing.assert_allclose(got_lg, want_lg, rtol=1e-12)
        np.testing.assert_allclose(got_pf, want_pf, rtol=1e-12)
        assert (got_pf[30:] == np.log(1e-15)).all()  # the floor engaged
    # the speaker axis gives each speaker its own density
    batched = tgmm.per_frame_loglik(tparams(w, mu, sg), *t64(Xf)).numpy()
    np.testing.assert_allclose(batched[1], got_pf, rtol=1e-12)


@pytest.mark.parametrize("threshold,n_iter", [(0.01, 200), (1e-6, 200),
                                              (0.0, 15)],
                         ids=["default_threshold", "tight", "fixed_count"])
def test_fit_from_params_matches_jax(threshold, n_iter):
    X, mask = padded_bank([300], 5, 3, seed=10)
    w, mu, sg = rand_params(1, 3, 5, seed=11)
    cfg = dict(n_mixtures=3, n_iterations=n_iter, threshold=threshold)
    got, ll = tgmm.fit_from_params(*t64(X, mask), tparams(w, mu, sg),
                                   GmmConfig(**cfg))
    want, jll = jgmm.fit_from_params(
        jnp.asarray(X[0]), jnp.asarray(mask[0]),
        jgmm.GmmParams(*(jnp.asarray(a[0]) for a in (w, mu, sg))),
        JGmmConfig(**cfg))
    assert_params_close([a[0] for a in got], want)
    np.testing.assert_allclose(ll[0].item(), float(jll), rtol=F64_RTOL)


def test_fit_from_ubm_matches_jax():
    X, mask = padded_bank([250, 140], 4, 3, seed=20)
    w, mu, sg = rand_params(1, 3, 4, seed=21)
    cfg = dict(n_mixtures=3, n_iterations=40)
    got, ll = tgmm.fit_from_ubm(*t64(X, mask),
                                tparams(w[0], mu[0], sg[0]), GmmConfig(**cfg))
    jcfg = JGmmConfig(**cfg)
    ubm = jgmm.GmmParams(*(jnp.asarray(a[0]) for a in (w, mu, sg)))
    want, jll = jax.vmap(lambda x, m: jgmm.fit_from_ubm(x, m, ubm, jcfg))(
        jnp.asarray(X), jnp.asarray(mask))
    assert_params_close(got, want)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=F64_RTOL)
    # MAP moves the means only
    for s in range(2):
        np.testing.assert_array_equal(got.weights[s].numpy(), w[0])
        np.testing.assert_array_equal(got.sigmas[s].numpy(), sg[0])


def test_bank_freezes_converged_speakers_like_vmap():
    """Speakers of unequal length converge at different iterations; each
    must keep the parameters of its own convergence, as under
    jax.vmap(fit_from_params), not step on until the slowest is done."""
    X, mask = padded_bank([300, 180, 90], 5, 3, seed=30)
    w, mu, sg = rand_params(3, 4, 5, seed=31)
    cfg = dict(n_mixtures=4, n_iterations=200, threshold=1e-4)
    log = {}
    got, ll = tgmm.fit_from_params(*t64(X, mask), tparams(w, mu, sg),
                                   GmmConfig(**cfg), log)
    jcfg = JGmmConfig(**cfg)
    want, jll = jax.vmap(
        lambda x, m, a, b, c: jgmm.fit_from_params(
            x, m, jgmm.GmmParams(a, b, c), jcfg))(
        *(jnp.asarray(a) for a in (X, mask, w, mu, sg)))
    assert_params_close(got, want)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=F64_RTOL)
    assert 0 < log["iterations"] < 200
    assert log["host_syncs"] == log["iterations"] // 2
    # each speaker stopped on its own: its serial fit runs fewer
    # iterations than the bank loop for at least one speaker
    own = []
    for s in range(3):
        one = {}
        tgmm.fit_from_params(*t64(X[s:s + 1], mask[s:s + 1]),
                             tparams(w[s:s + 1], mu[s:s + 1], sg[s:s + 1]),
                             GmmConfig(**cfg), one)
        own.append(one["iterations"])
    assert max(own) == log["iterations"] and min(own) < log["iterations"]
    # and a bank stepping every speaker to the end gives other parameters
    fixed, _ = tgmm.fit_from_params(
        *t64(X, mask), tparams(w, mu, sg),
        GmmConfig(n_mixtures=4, n_iterations=log["iterations"],
                  threshold=0.0))
    s_fast = int(np.argmin(own))
    assert not np.allclose(fixed.means[s_fast].numpy(),
                           got.means[s_fast].numpy(), rtol=1e-6)


def test_padding_does_not_change_training():
    X, mask = padded_bank([300], 5, 3, seed=40)
    Xp, maskp = padded_bank([300], 5, 3, seed=40, T=450)
    w, mu, sg = rand_params(1, 3, 5, seed=41)
    p = tparams(w, mu, sg)
    s1 = tgmm.sufficient_stats(p, *t64(X, mask))
    s2 = tgmm.sufficient_stats(p, *t64(Xp, maskp))
    for a, b in zip(s1, s2):  # tests/test_gmm.py:68-78
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)
    cfg = GmmConfig(n_mixtures=3, n_iterations=20)
    f1, _ = tgmm.fit(*t64(X, mask), cfg, seed=3)
    f2, _ = tgmm.fit(*t64(Xp, maskp), cfg, seed=3)
    assert_params_close(f1, f2, rtol=1e-7, atol=1e-9)


def test_m_step_floors_at_zero_count():
    """A component with no responsibility: N_k = 0 -> min_nk, weights
    renormalized, sigma floored at sqrt(min_covar) (gmm.cc:396-437,
    502-513), as the JAX m_step does on the same statistics."""
    rng = np.random.RandomState(50)
    N_k = np.array([[5.0, 0.0, 3.0]])
    F_k = rng.randn(1, 3, 4) * N_k[..., None]
    S_k = (F_k ** 2 / np.maximum(N_k[..., None], 1e-300)
           + np.abs(rng.randn(1, 3, 4)) * N_k[..., None])
    S_k[0, 2, 0] = F_k[0, 2, 0] ** 2 / 3.0  # zero variance in one dimension
    n = np.array([8.0])
    cfg = dict(n_mixtures=3)
    got = tgmm.m_step(tgmm.EmStats(*t64(n, N_k, F_k, S_k)), GmmConfig(**cfg))
    want = jgmm.m_step(jgmm.EmStats(*(jnp.asarray(a[0])
                                      for a in (n, N_k, F_k, S_k))),
                       JGmmConfig(**cfg))
    assert_params_close([a[0] for a in got], want, rtol=1e-12)
    w = got.weights[0].numpy()
    assert w[1] > 0 and np.isclose(w.sum(), 1.0)
    np.testing.assert_array_equal(got.means[0, 1].numpy(), 0.0)
    assert (got.sigmas[0, 1].numpy() == np.sqrt(1e-3)).all()
    assert got.sigmas[0, 2, 0].item() == np.sqrt(1e-3)


def test_init_params_definition_and_determinism():
    X, mask = padded_bank([120, 45], 3, 2, seed=60)
    Xt, mt = t64(X, mask)
    p1 = tgmm.init_params(Xt, mt, 8, seed=7)
    p2 = tgmm.init_params(Xt, mt, 8, seed=7)
    p3 = tgmm.init_params(Xt, mt, 8, seed=8)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    assert not torch.equal(p1.means, p3.means)
    for s, n in enumerate([120, 45]):
        rows = {tuple(r) for r in X[s, :n]}
        assert all(tuple(m) in rows for m in p1.means[s].numpy())
        np.testing.assert_allclose(
            p1.sigmas[s].numpy(),
            np.broadcast_to(X[s, :n].std(axis=0, ddof=1), (8, 3)),
            rtol=1e-12)
    np.testing.assert_array_equal(p1.weights.numpy(), 1.0 / 8)
    # speaker s draws from its own generator: the same with other speakers
    alone = tgmm.init_params(Xt[1:], mt[1:], 8, seed=7)
    assert not torch.equal(alone.means[0], p1.means[1])  # index 0 vs 1
    first = tgmm.init_params(Xt[:1], mt[:1], 8, seed=7)
    assert torch.equal(first.means[0], p1.means[0])


def test_adapt_speakers_matches_jax():
    rng = np.random.RandomState(70)
    w, mu, sg = rand_params(1, 3, 4, seed=71)
    ubm = tgmm.GmmParams(w[0], mu[0], sg[0])
    feats = {"a": make_data(120, 4, 3, 72), "b": make_data(80, 4, 3, 73)
             + rng.randn(4)}
    cfg = dict(n_mixtures=3, n_iterations=25)
    labels, got = tubm.adapt_speakers(ubm, feats, GmmConfig(**cfg),
                                      dtype="float64", device="cpu")
    jlabels, want = jubm.adapt_speakers(jgmm.GmmParams(*ubm), feats,
                                        JGmmConfig(**cfg), dtype="float64")
    assert labels == jlabels == ["a", "b"]
    assert_params_close(got, want)


def test_train_ubm_checkpoint_resumes_like_jax(tmp_path):
    """The checkpointed segment loop from one shared checkpoint file: both
    packages resume from it and take the same EM segments."""
    X = make_data(300, 4, 3, seed=80)
    w, mu, sg = rand_params(1, 3, 4, seed=81)
    text = serialization.dumps_reference_gmm(tgmm.GmmParams(w[0], mu[0],
                                                            sg[0]))
    paths = []
    for name in ("port.txt", "jax.txt"):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            f.write(text)
    kw = dict(n_mixtures=3, n_iterations=30, threshold=1e-10,
              dtype="float64", checkpoint_every=10)
    got = tubm.train_ubm([X[:200], X[200:]], checkpoint_path=paths[0],
                         device="cpu", **kw)
    want = jubm.train_ubm([X[:200], X[200:]], checkpoint_path=paths[1], **kw)
    # the checkpoint's 17 significant digits round-trip float64 exactly
    assert_params_close(got, want)
    with open(paths[0]) as f:
        assert_params_close(serialization.load_reference_gmm(f), got,
                            rtol=0, atol=0)
    # over a one-process mesh (gloo), from the same shared checkpoint, the
    # same EM segments
    from speaker_recognition_tpu_torch.parallel import mesh, multihost
    paths.append(str(tmp_path / "mesh.txt"))
    with open(paths[-1], "w") as f:
        f.write(text)
    dist = multihost.initialize(None, 1, 0, device="cpu")
    try:
        sharded = tubm.train_ubm([X[:200], X[200:]], checkpoint_path=paths[-1],
                                 mesh=mesh.make_mesh(1, 1, device="cpu"),
                                 device="cpu", **kw)
    finally:
        dist.destroy_process_group()
    assert_params_close(sharded, got, rtol=0, atol=0)


def test_train_ubm_runs_the_port_init():
    X = make_data(400, 3, 2, seed=90)
    kw = dict(n_mixtures=2, n_iterations=50, threshold=1e-8,
              dtype="float64", device="cpu")
    u1 = tubm.train_ubm([X], seed=4, **kw)
    u2 = tubm.train_ubm([X[:150], X[150:]], seed=4, **kw)
    assert_params_close(u1, u2, rtol=0, atol=0)
    assert u1.weights.shape == (2,) and u1.means.shape == (2, 3)
    # equal to EM from the port's own init, one speaker of index 0
    Xt, mt = t64(X[None], np.ones((1, 400), bool))
    p0 = tgmm.init_params(Xt, mt, 2, seed=4)
    ref, _ = tgmm.fit_from_params(Xt, mt, p0, GmmConfig(
        n_mixtures=2, n_iterations=50, threshold=1e-8))
    assert_params_close(u1, [a[0] for a in ref], rtol=0, atol=0)
    buf = io.StringIO()
    serialization.dump_reference_gmm(u1, buf)
    assert buf.getvalue().startswith("2\n")
