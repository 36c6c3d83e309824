"""The driver hooks of the repo's __graft_entry__.py, for the port:
`entry` returns the flagship forward step, batched utterance-vs-bank
scoring on extracted features (the bank-scoring kernel K2 on the card),
and its arguments; `dryrun_multichip` runs one sharded training step over
the process group (parallel/multihost.initialize, or parallel/launch for
several processes on localhost):

  1. a data-parallel EM iteration of a UBM, the sufficient statistics
     all_reduced over 'data' (mesh.sharded_em_step);
  2. MAP adaptation of the speakers, each rank adapting its share over
     'bank', the bank all_gathered;
  3. bank-sharded scoring (K3 on the card) with the argmax of the
     gathered scores;
  4. a full EM fit with the frames sharded over the whole mesh
     (mesh.sharded_fit).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import GmmConfig
from ..models import gmm
from ..ops import gpu_gmm

__all__ = ["entry", "dryrun_multichip"]


def entry(device: torch.device | str = "cuda"):
    """(forward, args): forward(bank_w, bank_m, bank_s, feats, mask) ->
    (argmax [B], scores [B, S]) for a 16-speaker GMM-32 bank at d = 28 and
    8 utterances of 512 frames."""
    S, K, d = 16, 32, 28
    B, T = 8, 512
    rng = np.random.RandomState(0)
    w = np.full((S, K), 1.0 / K, np.float32)
    m = rng.randn(S, K, d).astype(np.float32)
    s = (0.5 + rng.rand(S, K, d)).astype(np.float32)
    feats = torch.as_tensor(rng.randn(B, T, d).astype(np.float32),
                            device=device)
    mask = torch.ones((B, T), dtype=torch.bool, device=device)

    def forward(bank_w, bank_m, bank_s, feats, mask):
        bank = gmm.GmmBank.from_numpy(bank_w, bank_m, bank_s, feats.device)
        scores = gpu_gmm.batch_bank_avg_loglik(bank, feats, mask)
        return scores.argmax(dim=-1), scores

    return forward, (w, m, s, feats, mask)


def dryrun_multichip(n_devices: int,
                     device: torch.device | str = "cuda") -> dict:
    """One sharded training step over the n_devices processes of the
    group, on a ('data', 'bank') mesh with 2 shards of the speakers when
    n_devices is even, else 1, as the JAX package's. The
    problem's size does not depend on the mesh: 4 speakers, GMM-8 at
    d = 12, 64 frames. Returns the results on this rank (numpy)."""
    from . import mesh as pmesh

    if dist.get_world_size() != n_devices:
        raise ValueError(f"{dist.get_world_size()} processes, expected "
                         f"{n_devices}")
    bank_ax = 2 if n_devices % 2 == 0 else 1
    mesh = pmesh.make_mesh(data=n_devices // bank_ax, bank=bank_ax,
                           device=device)
    dev = pmesh.mesh_device(mesh)
    cfg = GmmConfig(n_mixtures=8)
    d, S, n_frames = 12, 4, 64
    rng = np.random.RandomState(0)
    ubm0 = gmm.GmmParams(
        np.full((cfg.n_mixtures,), 1.0 / cfg.n_mixtures, np.float32),
        rng.randn(cfg.n_mixtures, d).astype(np.float32),
        (0.5 + rng.rand(cfg.n_mixtures, d)).astype(np.float32))

    # 1. data-parallel UBM EM iteration
    X = rng.randn(n_frames, d).astype(np.float32)
    mask = np.ones(n_frames, bool)
    ubm = pmesh.sharded_em_step(mesh, cfg)(ubm0, X, mask)

    # 2. MAP adaptation, speakers sharded over 'bank', then gathered
    spk_X = rng.randn(S, 64, d).astype(np.float32)
    me, n = pmesh.shard_index(mesh, ("bank",))
    share = slice(me * (S // n), (me + 1) * (S // n))
    local, _ = gmm.fit_from_ubm(
        torch.as_tensor(spk_X[share], device=dev),
        torch.ones((S // n, 64), dtype=torch.bool, device=dev), ubm, cfg)
    group = mesh.get_group("bank")
    bank_params = []
    for a in local:
        parts = [torch.empty_like(a) for _ in range(n)]
        dist.all_gather(parts, a.contiguous(), group=group)
        bank_params.append(torch.cat(parts))

    # 3. bank-sharded scoring, the argmax of the gathered scores
    test_X = rng.randn(48, d).astype(np.float32)
    scores = pmesh.sharded_bank_scores(mesh)(
        gmm.GmmParams(*bank_params), test_X, np.ones(48, bool))

    # 4. a full EM fit over the whole mesh
    params, ll = pmesh.sharded_fit(mesh, GmmConfig(n_mixtures=4,
                                                   n_iterations=3))(X, mask)
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"ubm_means": host(ubm.means), "ubm_weights": host(ubm.weights),
            "bank_means": host(bank_params[1]), "scores": host(scores),
            "argmax": int(scores.argmax()), "fit_means": host(params.means),
            "fit_ll": float(ll)}
