"""speaker_recognition_tpu_torch.models.kmeans against
speaker_recognition_tpu.models.kmeans on the same seeded numpy inputs.

Lloyd's from an identical init is held to the JAX package's centroids and
cost; seeding draws from torch generators, which cannot equal jax.random,
so k-means++ and k-means|| are held to it by distribution: every seed is a
valid data point, and each seed's inertia is within INERTIA_FACTOR of the
JAX package's median over 8 keys."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.config import (  # noqa: E402
    GmmConfig as JGmmConfig)
from speaker_recognition_tpu.models import kmeans as jk  # noqa: E402
from speaker_recognition_tpu.models.gmmset import (  # noqa: E402
    GMMSet as JGMMSet)
from speaker_recognition_tpu_torch.config import GmmConfig  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.models import kmeans as tk  # noqa: E402
from speaker_recognition_tpu_torch.models.gmmset import GMMSet  # noqa: E402

# f32 distances and centroid sums in another order: ~1e-6 relative
DIST_RTOL, CENTROID_ATOL, COST_RTOL = 1e-5, 1e-4, 1e-5
INERTIA_FACTOR = 1.5
SEEDS = range(8)


def _blobs(K=6, per=100, d=5, seed=0, spread=0.3):
    rng = np.random.RandomState(seed)
    mu = rng.randn(K, d) * 5
    X = np.concatenate([m + spread * rng.randn(per, d) for m in mu])
    return X.astype(np.float32)


def _mask(n, n_pad):
    return np.arange(n) < n - n_pad


def test_pairwise_dist2_matches_jax():
    rng = np.random.RandomState(1)
    X = rng.randn(300, 28).astype(np.float32) * 3
    C = rng.randn(17, 28).astype(np.float32) * 3
    want = np.asarray(jk.pairwise_dist2(jnp.asarray(X), jnp.asarray(C)))
    got = tk.pairwise_dist2(torch.from_numpy(X), torch.from_numpy(C))
    assert got.dtype == torch.float32 and got.shape == (300, 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=DIST_RTOL,
                               atol=DIST_RTOL * np.abs(want).max())
    # batched over speakers
    got3 = tk.pairwise_dist2(torch.from_numpy(np.stack([X, X])),
                             torch.from_numpy(np.stack([C, C])))
    np.testing.assert_array_equal(got3[0].numpy(), got3[1].numpy())


def test_no_tf32_inside(monkeypatch):
    """Every matmul of the k-means functions runs at full precision (no
    TF32, float32 matmul precision "highest"), whatever the caller set;
    the caller's setting comes back afterwards."""
    seen = []
    matmul = torch.Tensor.__matmul__

    def recording(a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return matmul(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", recording)
    X = torch.from_numpy(_blobs())
    mask = torch.ones(len(X), dtype=torch.bool)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tk.lloyd(X, mask, X[:6])
        tk.kmeanspp(X, mask, 6)
        tk.kmeansii(X, mask, 6)
        tk.kmeansii_device(X, mask, 6)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and set(seen) == {(False, "highest")}


@pytest.mark.parametrize("kw", [{}, {"n_iter": 3}, {"weights": True},
                                {"tol": 50.0}],
                         ids=["converge", "n_iter", "weighted", "tol"])
def test_lloyd_matches_jax_from_identical_init(kw):
    """Centroids and cost equal the JAX package's from the same initial
    centroids (given as numpy), under each stopping rule; the masked tail
    takes no part."""
    X = _blobs()
    n = len(X)
    mask = _mask(n, 20)
    rng = np.random.RandomState(2)
    C0 = X[rng.choice(n - 20, 6, replace=False)]
    w = rng.rand(n).astype(np.float32) if kw.get("weights") else None
    jkw = {k: v for k, v in kw.items() if k != "weights"}
    Cj, cj = jk.lloyd(jnp.asarray(X), jnp.asarray(mask), jnp.asarray(C0),
                      weights=None if w is None else jnp.asarray(w), **jkw)
    log = {}
    Ct, ct = tk.lloyd(torch.from_numpy(X), torch.from_numpy(mask), C0,
                      weights=None if w is None else torch.from_numpy(w),
                      log=log, **jkw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj),
                               atol=CENTROID_ATOL)
    assert float(ct) == pytest.approx(float(cj), rel=COST_RTOL)
    n_iter = kw.get("n_iter", 200)
    assert 1 <= log["iterations"] <= n_iter
    assert log["host_syncs"] <= log["iterations"] // tk.SYNC_EVERY
    if kw.get("tol"):  # stopped at the first flag read: 8 passes, the
        # last six frozen, the JAX package's two
        assert log["iterations"] == tk.SYNC_EVERY


def test_lloyd_batched_is_per_speaker():
    """Over a speaker axis, each speaker stops by its own rules: its
    result is that of its own call (vmap semantics; frozen speakers keep
    their carry)."""
    Xs = [_blobs(seed=s, spread=0.2 + 0.4 * s) for s in range(3)]
    C0s = [x[::97][:6] for x in Xs]
    mask = np.ones(len(Xs[0]), bool)
    logs = [{} for _ in Xs]
    one = [tk.lloyd(torch.from_numpy(x), torch.from_numpy(mask), c,
                    log=lg) for x, c, lg in zip(Xs, C0s, logs)]
    blog = {}
    C, cost = tk.lloyd(torch.from_numpy(np.stack(Xs)),
                       torch.from_numpy(np.stack([mask] * 3)),
                       np.stack(C0s), log=blog)
    for s, (Cs, cs) in enumerate(one):
        np.testing.assert_allclose(C[s].numpy(), Cs.numpy(), atol=1e-5)
        assert float(cost[s]) == pytest.approx(float(cs), rel=1e-6)
    assert max(lg["iterations"] for lg in logs) <= blog["iterations"]


def _seed_rows_are_data(seeds, X, mask):
    """Every row of seeds [S, r, d] is a valid row of X [S, n, d]."""
    for s in range(seeds.shape[0]):
        valid = X[s][mask[s]]
        assert bool((seeds[s][:, None] == valid[None]).all(-1).any(-1).all())


def test_pp_seed_draws_valid_points():
    X = torch.from_numpy(np.stack([_blobs(seed=0), _blobs(seed=1)]))
    mask = torch.from_numpy(np.stack([_mask(600, 50), _mask(600, 0)]))
    u = torch.rand(2, 6, generator=torch.Generator().manual_seed(0))
    C = tk._pp_seed(X, mask.to(X.dtype), u)
    assert C.shape == (2, 6, 5)
    _seed_rows_are_data(C, X, mask)


def _jax_inertias(fn, X, mask, K):
    return [float(fn(jnp.asarray(X), jnp.asarray(mask), K,
                     jax.random.PRNGKey(s))[1]) for s in SEEDS]


@pytest.mark.parametrize("n,K,n_pad", [(600, 6, 20), (186, 32, 3),
                                       (40, 32, 3)],
                         ids=["blobs", "short_3s", "n_near_K"])
def test_kmeansii_device_by_distribution(n, K, n_pad, monkeypatch):
    """Over 8 seeds (one batched call: speaker s draws from
    speaker_generator(0, s)) every seed of the buffer is a valid data
    point and each inertia lies within INERTIA_FACTOR of the JAX
    package's median over 8 keys; short enrollments (cap > n: 186 frames
    of a 3 s utterance at K = 32, and n barely above K) included."""
    rng = np.random.RandomState(4)
    X = _blobs(per=100)[:n] if K == 6 else \
        rng.randn(n, 28).astype(np.float32)
    mask = _mask(n, n_pad)
    want = np.median(_jax_inertias(jk.kmeansii_device, X, mask, K))
    seen = []
    pp_seed = tk._pp_seed

    def capture(S, w, u):
        seen.append(S)
        return pp_seed(S, w, u)

    monkeypatch.setattr(tk, "_pp_seed", capture)
    Xt = torch.from_numpy(np.stack([X] * len(SEEDS)))
    mt = torch.from_numpy(np.stack([mask] * len(SEEDS)))
    log = {}
    C, inertia = tk.kmeansii_device(Xt, mt, K, log=log)
    assert C.shape == (len(SEEDS), K, X.shape[1])
    assert torch.isfinite(C).all()
    cap = int(2 * K) + 1 + int(4 * np.ceil(2 * K))
    assert seen[0].shape == (len(SEEDS), cap, X.shape[1])
    _seed_rows_are_data(seen[0], Xt, mt)
    ratio = inertia.numpy() / want
    assert (ratio <= INERTIA_FACTOR).all(), ratio
    assert log["iterations"] >= 2 and log["host_syncs"] >= 0


@pytest.mark.parametrize("name", ["kmeanspp", "kmeansii"])
def test_host_seeding_by_distribution(name):
    """The median inertia over 8 seeds is within INERTIA_FACTOR of the
    JAX package's over 8 keys: kmeanspp against its kmeanspp, the
    host-orchestrated kmeansii against its kmeansii_device, the same
    algorithm (its kmeansii traces a program per call, ~4 s each). Both
    packages' host k-means|| end in a poor local optimum for some seeds;
    the device version, which serves training, is held seed by seed
    above."""
    X = _blobs()
    mask = _mask(len(X), 20)
    ref = jk.kmeanspp if name == "kmeanspp" else jk.kmeansii_device
    want = np.median(_jax_inertias(ref, X, mask, 6))
    got = [float(getattr(tk, name)(torch.from_numpy(X),
                                   torch.from_numpy(mask), 6, seed=s)[1])
           for s in SEEDS]
    assert np.median(got) <= INERTIA_FACTOR * want, (got, want)
    assert np.median(got) >= want / INERTIA_FACTOR, (got, want)


def test_seeding_is_deterministic_across_calls():
    X = torch.from_numpy(np.stack([_blobs(seed=3)] * 2))
    mask = torch.ones(X.shape[:2], dtype=torch.bool)
    a = tk.kmeansii_device(X, mask, 6, seed=7)
    b = tk.kmeansii_device(X, mask, 6, seed=7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_done_flag_reads_change_no_result(monkeypatch):
    """kmeansii_device stops its rounds, and lloyd its iterations, once
    every speaker is done; with the flag reads made to say "not done"
    every round and iteration runs, and the result is bitwise the same
    (a done speaker's state is frozen). The rounds read the flags at most
    max_rounds - 1 times, all logged."""
    X = torch.from_numpy(np.stack([_blobs(seed=s, spread=0.2 + 0.3 * s)
                                   for s in range(3)]))
    mask = torch.from_numpy(np.stack([_mask(600, n) for n in (0, 40, 7)]))
    log = {}
    early = tk.kmeansii_device(X, mask, 6, seed=5, log=log)
    assert 1 <= log["rounds"] < 12
    assert log["host_syncs"] <= (log["rounds"]
                                 + log["iterations"] // tk.SYNC_EVERY)
    monkeypatch.setattr(tk, "bool", lambda _: False, raising=False)
    full_log = {}
    full = tk.kmeansii_device(X, mask, 6, seed=5, log=full_log)
    assert full_log["rounds"] == 12
    assert full_log["iterations"] == 2 * 200
    assert all(torch.equal(a, b) for a, b in zip(early, full))


def test_gmmset_kmeans_init_matches_jax_end_to_end():
    """GMMSet.train with init_with_kmeans trains a bank in one batched
    program in both packages; both label every speaker's held-out frames
    alike, and EM starts from the k-means|| means (fit_with_init)."""
    rng = np.random.RandomState(0)
    cfg = dict(n_mixtures=4, n_iterations=20, init_with_kmeans=True)
    jg = JGMMSet(gmm_order=4, config=JGmmConfig(**cfg), dtype="float32")
    tg = GMMSet(gmm_order=4, config=GmmConfig(**cfg), dtype="float32",
                device="cpu")
    held = {}
    for s in range(3):
        mu = rng.randn(4, 6) * 4
        X = np.concatenate([m + 0.3 * rng.randn(150, 6) for m in mu])
        jg.fit_new(X, f"s{s}")
        tg.fit_new(X, f"s{s}")
        held[f"s{s}"] = X[rng.permutation(len(X))[:80]]
    jg.train(seed=0)
    tg.train(seed=0)
    assert tg.params.means.shape == (3, 4, 6)
    for k in ("iterations", "host_syncs", "kmeans_rounds",
              "kmeans_iterations", "kmeans_host_syncs"):
        assert tg.train_log[k] >= (1 if "iterations" in k else 0), k
    for label, X in held.items():
        assert tg.predict_one(X) == jg.predict_one(X) == label


def test_fit_with_init_without_kmeans_is_fit():
    rng = np.random.RandomState(1)
    X = torch.from_numpy(rng.randn(2, 120, 4))
    mask = torch.ones(2, 120, dtype=torch.bool)
    cfg = GmmConfig(n_mixtures=3, n_iterations=6)
    a, la = tgmm.fit_with_init(X, mask, cfg, seed=3)
    b, lb = tgmm.fit(X, mask, cfg, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(la, lb)
