"""Data-sharded EM and bank-sharded scoring over a ('data', 'bank') device
mesh, as in speaker_recognition_tpu/parallel/mesh.py, on
torch.distributed: NCCL for a mesh of CUDA devices and gloo for a mesh of
CPU processes, chosen from the device with no fallback between them
(parallel/multihost.initialize).

The reference's only concurrency is shared-memory thread pools merging
per-worker partial sums serially (gmm.cc:447-530, kmeans.cc:206-233).
Each of those reductions is associative, so the mapping is direct:

  * EM E-step over frames  -> shard the frame axis over 'data'; the
    per-component sufficient statistics (N_k, F_k, S_k) are summed by an
    all_reduce over the 'data' group;
  * speaker-bank scoring   -> shard the bank's S axis over 'bank'; each
    rank scores its share through ops/gpu_gmm.bank_avg_loglik (K3 on the
    card) and the [S] scores are all_gathered for the argmax.

The functions take the global arrays on every rank, as the JAX package's
take global arrays, and each rank computes on its own shard; the results
are the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import GmmConfig
from ..models import gmm
from ..ops import gpu_gmm

__all__ = ["make_mesh", "sharded_em_step", "sharded_fit",
           "sharded_bank_scores", "pad_frames_for_mesh", "mesh_device",
           "shard_index"]


def make_mesh(data: int | None = None, bank: int = 1,
              device: torch.device | str = "cuda") -> DeviceMesh:
    """A ('data', 'bank') mesh over the process group, which
    parallel/multihost.initialize starts; by default every process on
    'data'. CUDA meshes use NCCL, CPU meshes gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize() first")
    world = dist.get_world_size()
    if data is None:
        data = world // bank
    if data * bank != world:
        raise ValueError(f"mesh {data} x {bank} != {world} processes")
    return init_device_mesh(torch.device(device).type, (data, bank),
                            mesh_dim_names=("data", "bank"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def pad_frames_for_mesh(X: np.ndarray, mask: np.ndarray, n_shards: int):
    """Pad the frame axis to a multiple of n_shards (mask marks padding)."""
    n = X.shape[0]
    pn = -(-n // n_shards) * n_shards
    if pn != n:
        X = np.concatenate([X, np.zeros((pn - n,) + X.shape[1:], X.dtype)],
                           axis=0)
        mask = np.concatenate([mask, np.zeros(pn - n, bool)])
    return X, mask


def shard_index(mesh: DeviceMesh, dims) -> tuple[int, int]:
    """(this rank's index, the number of shards) over the mesh dims, the
    first dim the slowest."""
    idx, n = 0, 1
    for d in dims:
        size = mesh.size(mesh.mesh_dim_names.index(d))
        idx, n = idx * size + mesh.get_local_rank(d), n * size
    return idx, n


def _host(a) -> np.ndarray:
    """A numpy array or a tensor on any device, as numpy."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _shard_frames(mesh: DeviceMesh, X, mask, dims=("data", "bank")):
    """This rank's contiguous block of the frames [n, d] (and mask [n]) as
    numpy, the frame axis padded to a multiple of the shards over
    `dims`."""
    idx, n = shard_index(mesh, dims)
    X, mask = pad_frames_for_mesh(_host(X), _host(mask).astype(bool), n)
    per = X.shape[0] // n
    return X[idx * per:(idx + 1) * per], mask[idx * per:(idx + 1) * per]


def _sum_over(mesh: DeviceMesh, dims):
    """A reduce hook (models/gmm.fit_from_params): a list of tensors summed
    over the shards of `dims`, one all_reduce a dim on one flat buffer."""
    groups = [mesh.get_group(d) for d in dims]

    def reduce(tensors: list) -> list:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        for g in groups:
            dist.all_reduce(flat, group=g)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out
    return reduce


def _as_tensor(a, dt, dev) -> torch.Tensor:
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a),
                           dtype=dt, device=dev)


def sharded_em_step(mesh: DeviceMesh, cfg: GmmConfig):
    """One EM iteration with the frames sharded over 'data' and the three
    sufficient statistics all_reduced across it; the parameters
    replicate. Returns fn(params, X, mask) -> new params (a GmmParams of
    one GMM: weights [K], means and sigmas [K, d]); X [n, d] global."""
    dev, f32 = mesh_device(mesh), torch.float32
    reduce = _sum_over(mesh, ("data",))

    def step(params, X, mask):
        Xl, ml = _shard_frames(mesh, X, mask, ("data",))
        p = gmm.GmmParams(*(_as_tensor(a, f32, dev)[None] for a in params))
        stats = gmm.sufficient_stats(p, _as_tensor(Xl, f32, dev)[None],
                                     torch.as_tensor(ml, device=dev)[None])
        new = gmm.m_step(gmm.EmStats(*reduce(list(stats))), cfg)
        return gmm.GmmParams(*(a[0] for a in new))
    return step


def sharded_bank_scores(mesh: DeviceMesh):
    """Utterance-vs-bank scoring with the bank sharded over 'bank': each
    rank scores its share of the speakers through ops/gpu_gmm.
    bank_avg_loglik (K3 on the card, its plain version on the CPU) and the
    shares are all_gathered. Returns fn(bank, X, mask) -> [S] f32 on every
    rank; bank a GmmParams [S, K], [S, K, d] with S a multiple of the
    'bank' size."""
    dev = mesh_device(mesh)
    group = mesh.get_group("bank")
    me, n = shard_index(mesh, ("bank",))

    def score(bank, X, mask):
        w, m, s = (_host(a) for a in bank)
        S = w.shape[0]
        if S % n:
            raise ValueError(f"{S} speakers do not split over {n} 'bank' "
                             "shards")
        share = slice(me * (S // n), (me + 1) * (S // n))
        local = gpu_gmm.bank_avg_loglik(
            gmm.GmmBank.from_numpy(w[share], m[share], s[share], dev),
            _as_tensor(X, torch.float32, dev).contiguous(),
            _as_tensor(mask, torch.bool, dev))
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts)
    return score


def sharded_fit(mesh: DeviceMesh, cfg: GmmConfig, dtype="float32"):
    """Full EM fit (models/gmm.fit) with the frame axis sharded over the
    whole mesh ('data' then 'bank'): the init from the global frames on
    every rank (the same draw everywhere), then the port's EM loop on this
    rank's shard with the statistics and log-likelihoods summed over the
    shards; the convergence logic stays replicated. Returns fn(X, mask,
    seed=0, params0=None) -> (GmmParams of one GMM, log-likelihood); X
    [n, d] global, params0 a GMM to start from in place of the init."""
    dev, dt = mesh_device(mesh), getattr(torch, dtype)
    reduce = _sum_over(mesh, ("data", "bank"))

    def run(X, mask, seed: int = 0, params0=None):
        if params0 is None:
            params0 = gmm.init_params(_as_tensor(X, dt, dev)[None],
                                      _as_tensor(mask, torch.bool, dev)[None],
                                      cfg.n_mixtures, seed)
        else:
            params0 = gmm.GmmParams(*(_as_tensor(a, dt, dev)[None]
                                      for a in params0))
        Xl, ml = _shard_frames(mesh, X, mask)
        params, ll = gmm.fit_from_params(
            _as_tensor(Xl, dt, dev)[None],
            torch.as_tensor(ml, device=dev)[None], params0, cfg,
            reduce=reduce)
        return gmm.GmmParams(*(a[0] for a in params)), ll[0]
    return run
