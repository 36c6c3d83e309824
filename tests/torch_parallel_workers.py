"""What each process of tests/test_torch_parallel.py's gloo runs compute,
through speaker_recognition_tpu_torch.parallel.launch: the port's
multi-device programs on inputs made from seeds, returned as numpy. This
module imports neither jax nor the JAX package, so that the processes stay
light."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from speaker_recognition_tpu_torch.config import (FeatureConfig, GmmConfig,
                                                  LpcConfig, MfccConfig,
                                                  bob_mfcc_config)
from speaker_recognition_tpu_torch.parallel import entry, seqshard
from speaker_recognition_tpu_torch.parallel import mesh as pmesh
from speaker_recognition_tpu_torch.tools import ubm

CFG = GmmConfig(n_mixtures=4, n_iterations=20)
# one long utterance per case: (fs, config, samples); each length is a
# ragged number of frame shifts, and 48 kHz takes the full-spectrum route
SEQ_CASES = {
    "bob_mfcc_config": (16000, FeatureConfig(mfcc=bob_mfcc_config()),
                        2 * 16000 + 123),
    "lpcc": (8000, FeatureConfig(lpc=LpcConfig(n_lpcc=16)), 2 * 8000 + 77),
    "deltas": (8000, FeatureConfig(n_deltas=2), 2 * 8000 + 5),
    "ragged_full_route": (48000, FeatureConfig(mfcc=MfccConfig(
        n_filters=40)), 48000 + 555),
}


def frames(n=203, d=6, K=4, seed=0):
    """[n, d] float32 frames from K clusters (n odd: the shards pad)."""
    rng = np.random.RandomState(seed)
    mu = rng.randn(K, d) * 2
    return (mu[rng.randint(0, K, n)] + rng.randn(n, d)).astype(np.float32)


def gmm_params(K=4, d=6, seed=1):
    rng = np.random.RandomState(seed)
    w = rng.rand(K) + 0.1
    return ((w / w.sum()).astype(np.float32),
            rng.randn(K, d).astype(np.float32),
            (0.5 + rng.rand(K, d)).astype(np.float32))


def bank_params(S=4, K=4, d=6, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def em_mask(n=203):
    return np.arange(n) < 180


def signal(fs, n, seed=3):
    """A voiced-ish test signal at int16 scale: harmonics and noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    f0 = 110 + 30 * np.sin(2 * np.pi * 0.7 * t)
    x = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / fs) / k
            for k in range(1, 8))
    return (3000 * x + 300 * rng.randn(n)).astype(np.float64)


def _np(p):
    return [a.detach().cpu().numpy() for a in p]


def run_all(tmp: str, device: str = "cpu") -> dict:
    """Every multi-device program of the port on this rank."""
    n = dist.get_world_size()
    out = {}
    data_mesh = pmesh.make_mesh(data=n, bank=1, device=device)
    X = frames()
    out["em_step"] = _np(pmesh.sharded_em_step(data_mesh, CFG)(
        gmm_params(), X, em_mask()))
    params, ll = pmesh.sharded_fit(data_mesh, CFG)(X, np.ones(len(X), bool),
                                                   0)
    out["fit"], out["fit_ll"] = _np(params), float(ll)
    bank_mesh = pmesh.make_mesh(data=1, bank=n, device=device)
    Xt = frames(50, seed=5)
    out["scores"] = pmesh.sharded_bank_scores(bank_mesh)(
        bank_params(), Xt, np.arange(50) < 41).cpu().numpy()
    parts = [X[:120], X[120:]]
    out["ubm"] = list(ubm.train_ubm(parts, n_mixtures=4, n_iterations=12,
                                    mesh=data_mesh, device=device))
    ckpt = os.path.join(tmp, f"ubm_ckpt_{n}.txt")
    out["ubm_ckpt"] = list(ubm.train_ubm(
        parts, n_mixtures=4, n_iterations=12, checkpoint_path=ckpt,
        checkpoint_every=4, mesh=data_mesh, device=device))
    dist.barrier()
    out["ubm_ckpt_file"] = os.path.exists(ckpt)
    out["dryrun"] = entry.dryrun_multichip(n, device)
    out["seq"] = {name: seqshard.sharded_mix_feature(
        data_mesh, fs, signal(fs, L), cfg)
        for name, (fs, cfg, L) in SEQ_CASES.items()}
    out["rank"] = dist.get_rank()
    out["threads"] = torch.get_num_threads()
    return out


def group() -> tuple:
    """(rank, world size, the all_reduce sum of the ranks): the group is
    up and its collectives run."""
    import torch.distributed as dist

    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), float(t)


def sleep(seconds: float):
    """A rank that outlives any test's timeout."""
    time.sleep(seconds)
