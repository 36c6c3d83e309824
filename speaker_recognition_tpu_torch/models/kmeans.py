"""k-means for GMM initialization: Lloyd's, k-means++, k-means||, as in
speaker_recognition_tpu/models/kmeans.py (the reference's thread-pool
solvers, src/gmm/src/kmeans.cc, kmeans++.cc, kmeansII.cc).

The JAX package writes these in plain XLA (no Pallas kernel), and the port
in plain torch: the hot operation is the point-to-centroid distance

    dist2[i, j] = |x_i|^2 - 2 x_i . c_j + |c_j|^2,

one matmul, and the centroid sums another. Both run at full float32
precision: no TF32 (`full_precision`), because a single-pass product's
error on the cross term floors small distances and distorts the D^2
sampling weights (PARITY.md N3: one seed in five collapsed k-means||
seeding on a TPU at single-pass precision).

Batching over speakers. The JAX package vmaps the seeding and Lloyd's over
a speaker bank; here the functions take a leading speaker axis written out
(X [S, n, d], mask [S, n]), as models/gmm's EM does. Under vmap a
speaker whose while_loop is done keeps its carry while the others
iterate; `lloyd` does the same with a per-speaker done flag and
torch.where, and reads the flags on the host once every SYNC_EVERY
iterations, so its result is the vmapped loop's exactly (a frozen
speaker's extra iterations change nothing) with a bounded number of host
syncs. `kmeansii_device` keeps the JAX package's fixed-size seed buffer and
sort-based gathers, so the whole seeding runs on the device with no
`nonzero`.

Randomness. Speaker s draws from models/gmm.speaker_generator(seed, s), a
CPU generator, never the global one: its uniforms are drawn up front on
the host and moved to the device once, so a seed gives the same draws on
the CPU and the card. They cannot equal jax.random's; the tests hold the
seeding to the JAX package by its distribution.

Semantics mirrored from the reference: Lloyd's runs at most 200
iterations, keeps the best-cost centroids and stops when the cost moves by
less than 1e-6 or exceeds 1.5x the best (kmeans.cc:150-246); an empty
cluster keeps its centroid. k-means++ is D^2-weighted sequential seeding
(kmeans++.cc:102-227). k-means|| oversamples by l = 2K a round until more
than 2K seeds (kmeansII.cc:82-171), weights the seeds by the points they
claim, reclusters them with weighted k-means++ and runs Lloyd's on the
data.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .gmm import speaker_generator

__all__ = ["full_precision", "pairwise_dist2", "lloyd", "kmeanspp",
           "kmeansii", "kmeansii_device", "SYNC_EVERY"]

# lloyd reads its per-speaker done flags on the host once per this many
# iterations (at most 25 reads in 200 iterations)
SYNC_EVERY = 8


@contextlib.contextmanager
def full_precision():
    """Full float32 matmuls on the card inside (cuBLAS without TF32, the
    float32 matmul precision "highest"); the caller's setting comes back
    on exit. Only the legacy flag is touched: torch refuses to read its
    precision flags once the legacy and the newer API were mixed."""
    cuda = torch.backends.cuda.matmul
    tf32 = cuda.allow_tf32
    cuda.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32 = tf32


def pairwise_dist2(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[..., n, d], [..., K, d] -> [..., n, K] squared euclidean distances
    (one matmul, at full precision)."""
    with full_precision():
        x2 = (X * X).sum(dim=-1, keepdim=True)
        c2 = (C * C).sum(dim=-1)
        xc = X @ C.transpose(-1, -2)
    return torch.clamp_min(x2 - 2.0 * xc + c2.unsqueeze(-2), 0.0)


def _rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X [S, n, d] at indices idx [S, r] -> [S, r, d]."""
    return torch.gather(X, 1, idx.unsqueeze(-1).expand(-1, -1, X.shape[-1]))


def _draw(seed: int, S: int, sizes, dtype, device):
    """Speaker s's uniforms from speaker_generator(seed, s), split into
    [S, size] blocks in the order of `sizes`, on `device`."""
    u = torch.stack([torch.rand(sum(sizes), generator=speaker_generator(
        seed, s), dtype=dtype) for s in range(S)]).to(device)
    return torch.split(u, list(sizes), dim=1)


def _masked_full(mask: torch.Tensor, value: float, dtype) -> torch.Tensor:
    """`value` where mask, else 0, in `dtype`."""
    return torch.zeros(mask.shape, dtype=dtype,
                       device=mask.device).masked_fill_(mask, value)


def _log_add(log: dict | None, iterations: int, syncs: int):
    if log is not None:
        log["iterations"] = log.get("iterations", 0) + iterations
        log["host_syncs"] = log.get("host_syncs", 0) + syncs


def _batched(X, *rest):
    """(X, *rest) with a leading speaker axis, and whether it was added."""
    if X.dim() == 2:
        return True, X[None], *(None if a is None else a[None]
                                for a in rest)
    return False, X, *rest


def lloyd(X: torch.Tensor, mask: torch.Tensor, centroids0,
          n_iter: int = 200, tol: float = 1e-6,
          terminate_cost_factor: float = 1.5,
          weights: torch.Tensor | None = None, log: dict | None = None):
    """Lloyd's iteration with the reference's stopping rules, per speaker:
    X [S, n, d] (or [n, d]), mask [S, n], centroids0 [S, K, d] (a tensor
    or numpy, e.g. the JAX package's) -> (best centroids [S, K, d], best
    cost [S]). The mask keeps padded frames out of the cost and the
    updates; `weights` [S, n] scale both (the weighted variant,
    kmeans.cc:108-146, which the k-means|| recluster needs). `log`, if
    given, accumulates the iterations and the host syncs."""
    C = torch.as_tensor(centroids0, dtype=X.dtype, device=X.device)
    squeeze, X, mask, C, weights = _batched(X, mask, C, weights)
    S, K = C.shape[:2]
    dt = X.dtype
    m = mask.to(dt)
    if weights is not None:
        m = m * weights.to(dt)
    big = torch.finfo(dt).max
    best_C = C
    best_cost = torch.full((S,), big, dtype=dt, device=X.device)
    last_cost = best_cost
    done = torch.zeros(S, dtype=torch.bool, device=X.device)
    ks = torch.arange(K, device=X.device)
    it = syncs = 0
    with full_precision():
        while it < n_iter:
            dmin, belong = pairwise_dist2(X, C).min(dim=-1)
            cost = (dmin * m).sum(dim=-1)
            improved = cost < best_cost
            new_best_C = torch.where(improved[:, None, None], C, best_C)
            new_best = torch.where(improved, cost, best_cost)
            stop = (((last_cost - cost).abs() < tol)
                    | (cost > new_best * terminate_cost_factor))
            onehot = (belong.unsqueeze(-1) == ks).to(dt) * m.unsqueeze(-1)
            counts = onehot.sum(dim=-2)
            sums = onehot.transpose(-1, -2) @ X
            new_C = torch.where(counts.unsqueeze(-1) > 0,
                                sums / torch.clamp_min(counts, 1.0)
                                .unsqueeze(-1), C)
            # a done speaker keeps its carry, as under vmap
            active = ~done
            a3 = active[:, None, None]
            C = torch.where(a3, new_C, C)
            best_C = torch.where(a3, new_best_C, best_C)
            best_cost = torch.where(active, new_best, best_cost)
            last_cost = torch.where(active, cost, last_cost)
            done = done | (active & stop)
            it += 1
            if it % SYNC_EVERY == 0 and it < n_iter:
                syncs += 1
                if bool(done.all()):
                    break
    _log_add(log, it, syncs)
    if squeeze:
        return best_C[0], best_cost[0]
    return best_C, best_cost


def _pp_seed(X: torch.Tensor, sample_w: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """D^2-weighted sequential seeding of K = u.shape[1] centroids per
    speaker, shared by the k-means++ variants: X [S, n, d], sample_w
    [S, n] (a point's extra sampling mass: 1, its weight, or 0 for
    padding), u [S, K] uniforms -> [S, K, d]."""
    S, n, d = X.shape
    K = u.shape[1]
    dt = X.dtype

    def pick(w, uk):
        total = w.sum(dim=-1, keepdim=True)
        idx = torch.searchsorted(torch.cumsum(w, dim=-1), uk[:, None] * total)
        return _rows(X, idx.clamp(0, n - 1))

    C = X.new_zeros((S, K, d))
    C[:, :1] = pick(sample_w, u[:, 0])
    dist = torch.full((S, n), torch.finfo(dt).max, dtype=dt, device=X.device)
    for k in range(1, K):
        dist = torch.minimum(dist, pairwise_dist2(X, C[:, k - 1:k])[..., 0])
        C[:, k:k + 1] = pick(dist * sample_w, u[:, k])
    return C


def kmeanspp(X: torch.Tensor, mask: torch.Tensor, K: int, seed: int = 0,
             weights: torch.Tensor | None = None, log: dict | None = None):
    """k-means++ seeding + Lloyd's per speaker (KMeansppSolver::cluster /
    _weighted; the weighted variant also weights the refinement,
    kmeans++.cc:211-214): X [S, n, d] (or [n, d]) -> (centroids, cost)."""
    squeeze, X, mask, weights = _batched(X, mask, weights)
    sample_w = mask.to(X.dtype)
    if weights is not None:
        sample_w = sample_w * weights
    (u,) = _draw(seed, X.shape[0], [K], X.dtype, X.device)
    C, cost = lloyd(X, mask, _pp_seed(X, sample_w, u), weights=weights,
                    log=log)
    return (C[0], cost[0]) if squeeze else (C, cost)


def kmeansii(X: torch.Tensor, mask: torch.Tensor, K: int, seed: int = 0,
             oversampling_factor: float = 2.0, size_factor: float = 2.0):
    """k-means|| of one utterance X [n, d] (KMeansIISolver::cluster,
    kmeansII.cc:82-171), its sampling rounds orchestrated on the host
    around device distance computations; draws from speaker_generator(
    seed, 0). -> (centroids [K, d], cost)."""
    g = speaker_generator(seed, 0)
    n = X.shape[0]
    dt = X.dtype
    mask_np = mask.cpu().numpy().astype(bool)
    valid_idx = np.nonzero(mask_np)[0]

    def uniform_valid():
        return int(valid_idx[int(torch.randint(len(valid_idx), (),
                                               generator=g))])

    seeds = [uniform_valid()]
    dist = _masked_full(mask, torch.finfo(dt).max, dt)
    last_size = 0
    while True:
        newC = X[torch.as_tensor(seeds[last_size:], device=X.device)]
        dist = torch.minimum(dist, pairwise_dist2(X, newC).amin(dim=-1))
        if len(seeds) > size_factor * K:
            break
        dsum = float(torch.where(mask, dist, 0.0).sum())
        last_size = len(seeds)
        u = torch.rand(n, generator=g, dtype=dt).numpy()
        p = (dist.cpu().numpy() * oversampling_factor * K
             / max(dsum, 1e-300))
        seeds.extend(int(i) for i in np.nonzero((u < p) & mask_np)[0])
        if len(seeds) == last_size:
            break
    # top up with uniformly drawn valid points if undersampled
    while len(seeds) <= size_factor * K:
        seeds.append(uniform_valid())

    S = X[torch.as_tensor(seeds, device=X.device)]
    # weight each seed by the number of valid points it claims
    belong = pairwise_dist2(X, S).argmin(dim=-1)
    w = torch.zeros(len(seeds), dtype=dt, device=X.device).index_put_(
        (belong,), mask.to(dt), accumulate=True)
    u = torch.rand(K, generator=g, dtype=dt).to(X.device)
    C0 = _pp_seed(S[None], w[None], u[None])
    C, _ = lloyd(S[None], torch.ones(1, len(seeds), dtype=torch.bool,
                                     device=X.device), C0, weights=w[None])
    return lloyd(X, mask, C[0])


def kmeansii_device(X: torch.Tensor, mask: torch.Tensor, K: int,
                    seed: int = 0, oversampling_factor: float = 2.0,
                    size_factor: float = 2.0, max_rounds: int = 12,
                    log: dict | None = None):
    """k-means|| of every speaker at once, on the device: X [S, n, d] (or
    [n, d]), mask [S, n] -> (centroids [S, K, d], cost [S]).

    The algorithm of kmeansII.cc:82-171 (per-round Bernoulli inclusion
    with p = min(1, l*K*d2_i / sum d2), stop when more than size_factor*K
    seeds or a round adds none, weight seeds by claimed cluster size,
    weighted k-means++ recluster, Lloyd's on the data), with the seed set
    carried as a membership mask and fixed buffers, as the JAX package
    does: a round adds at most R_MAX = 4 ceil(l) seeds (l = l*K expected),
    at most max_rounds rounds run, and the seeds gather into a buffer of
    cap = floor(size_factor*K) + 1 + R_MAX rows whose unused slots take
    uniformly drawn valid points (the reference's top-up). A speaker that
    is done keeps its state through the remaining rounds, so reading the
    done flags after each round and stopping once every speaker is done
    changes no result (at most max_rounds - 1 host syncs). `log`
    accumulates the rounds run, Lloyd's iterations and the host syncs of
    both."""
    squeeze, X, mask = _batched(X, mask)
    S, n, d = X.shape
    dt = X.dtype
    dev = X.device
    maskf = mask.to(dt)
    big = torch.finfo(dt).max
    l = oversampling_factor * K
    r_max = int(4 * np.ceil(l))
    cap = int(np.floor(size_factor * K)) + 1 + r_max  # seed buffer bound
    u0, u_rounds, u_fill, u_pp = _draw(
        seed, S, [1, max_rounds * n, cap, K], dt, dev)
    u_rounds = u_rounds.view(S, max_rounds, n)
    ar = torch.arange(n, device=dev)

    with full_precision():
        # first seed: uniform over the valid points
        cum = torch.cumsum(maskf, dim=-1)
        first = torch.searchsorted(cum, u0 * maskf.sum(dim=-1, keepdim=True))
        first = first.clamp(0, n - 1)                           # [S, 1]
        is_seed = torch.zeros((S, n), dtype=torch.bool, device=dev)
        is_seed.scatter_(1, first, True)
        dist = _masked_full(mask, big, dt)
        dist = torch.minimum(dist, pairwise_dist2(X, _rows(X, first))[..., 0])
        count = torch.ones(S, dtype=torch.int64, device=dev)
        done = torch.zeros(S, dtype=torch.bool, device=dev)
        rounds = syncs = 0
        for i in range(max_rounds):
            dsum = torch.clamp_min(torch.where(mask, dist, 0.0).sum(dim=-1),
                                   1e-30)
            p = dist * (l / dsum)[:, None]
            chosen = ((u_rounds[:, i] < p) & mask & ~is_seed
                      & ~done[:, None])
            # at most r_max chosen indices into a fixed buffer, n = pad
            order = torch.where(chosen, ar, n)
            idx = torch.sort(order, dim=-1).values[:, :r_max]
            valid = idx < n
            d2 = pairwise_dist2(X, _rows(X, idx.clamp(0, n - 1)))
            d2 = torch.where(valid[:, None, :], d2, big)
            new_dist = torch.minimum(dist, d2.amin(dim=-1))
            n_new = valid.sum(dim=-1)
            # a point joins iff its index made the first r_max chosen
            last = torch.where(valid, idx, -1).amax(dim=-1)
            added = chosen & (order <= last[:, None])
            new_count = count + n_new
            keep = ~done
            is_seed = torch.where(keep[:, None], is_seed | added, is_seed)
            dist = torch.where(keep[:, None], new_dist, dist)
            count = torch.where(keep, new_count, count)
            done = done | (new_count > size_factor * K) | (n_new == 0)
            # the rounds left change no frozen speaker: stop when all are
            rounds = i + 1
            if rounds < max_rounds:
                syncs += 1
                if bool(done.all()):
                    break

        # the seeds into the [cap] buffer; pad slots (index n) become
        # uniformly drawn valid points (kmeansII.cc:139-146). Fewer frames
        # than the buffer (a short enrollment: n < ~2K + 4 ceil(l)) pad it
        # explicitly.
        sidx = torch.sort(torch.where(is_seed, ar, n), dim=-1).values[:, :cap]
        if cap > n:
            sidx = torch.nn.functional.pad(sidx, (0, cap - n), value=n)
        rand_idx = torch.searchsorted(
            cum, u_fill * maskf.sum(dim=-1, keepdim=True)).clamp(0, n - 1)
        sidx = torch.where(sidx >= n, rand_idx, sidx.clamp(0, n - 1))
        seeds = _rows(X, sidx)                                  # [S, cap, d]
        # weight each seed by the number of valid points it claims (sums
        # of ones: exact in any order)
        belong = pairwise_dist2(X, seeds).argmin(dim=-1)
        w = torch.zeros((S, cap), dtype=dt, device=dev).scatter_add_(
            1, belong, maskf)
        C0 = _pp_seed(seeds, w, u_pp)
        C, _ = lloyd(seeds, torch.ones((S, cap), dtype=torch.bool,
                                       device=dev), C0, weights=w, log=log)
        C, cost = lloyd(X, mask, C, log=log)
    _log_add(log, 0, syncs)
    if log is not None:
        log["rounds"] = log.get("rounds", 0) + rounds
    return (C[0], cost[0]) if squeeze else (C, cost)
