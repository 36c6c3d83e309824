"""Binary RBM with CD-k, and a DBN (stack of RBMs), as in
speaker_recognition_tpu/models/rbm.py.

Batched matmul CD-k in place of the reference's per-sample loops
(src/nn/src/rbm.cc, include/{rbm,dbn}.hh), with its details:
  * the hidden statistics use the probabilities p, not the sampled states
    ("NOTE: here use p for smaller noise", rbm.cc:68-82), while the
    <v h'> products use the sampled states;
  * plain SGD, no momentum or decay (rbm.cc:100-120);
  * sampling h ~ Bernoulli(sigmoid(w'v + b)) (rbm.cc:139-150);
  * a DBN trains layer by layer; fit_last_layer trains only the top RBM on
    the previous layers' hidden activations (dbn.hh:12-20).

Draws: the init comes from a generator on the computation's device seeded
from (seed, 0), step i's uniform noise from one seeded from (seed, 1 + i)
(`step_generator`), so a draw depends on the step and not on what ran
before it. The card and the CPU draw different numbers from one seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["RbmParams", "RbmTrainConfig", "fit", "transform", "Dbn",
           "cd_step", "step_generator", "sub_seed"]


class RbmParams(NamedTuple):
    vb: torch.Tensor   # [nv]
    hb: torch.Tensor   # [nh]
    w: torch.Tensor    # [nv, nh]


class RbmTrainConfig(NamedTuple):
    learning_rate: float = 0.1
    n_epochs: int = 50
    batch_size: int = 100
    cd_k: int = 1


def step_generator(seed: int, step: int,
                   device: torch.device | str = "cuda") -> torch.Generator:
    """The generator of draw `step` under `seed` on `device`: seeded from
    SeedSequence([seed, step]) (0 is the init's draw, 1 + i step i's)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def sub_seed(seed: int, *keys: int) -> int:
    """A seed of its own for a part of a run (a DBN layer, an MLP's
    init), derived from (seed, *keys)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


def _hidden(params: RbmParams, V, U):
    p = torch.sigmoid(V @ params.w + params.hb)
    return p, (U < p).to(p.dtype)


def _visible(params: RbmParams, H, U):
    p = torch.sigmoid(H @ params.w.T + params.vb)
    return (U < p).to(p.dtype)


def cd_step(params: RbmParams, batch: torch.Tensor, noise,
            cfg: RbmTrainConfig) -> RbmParams:
    """One minibatch CD-k update given its uniform noise: 2 cd_k + 1
    tensors, the hidden sample's [B, nh], then per Gibbs step the
    visible's [B, nv] and the hidden's [B, nh]."""
    B = batch.shape[0]
    V = batch
    p0, H = _hidden(params, V, noise[0])
    v0, h0 = V.mean(0), p0.mean(0)
    w0 = V.T @ H / B
    pk = p0
    for j in range(cfg.cd_k):
        V = _visible(params, H, noise[1 + 2 * j])
        pk, H = _hidden(params, V, noise[2 + 2 * j])
    vk, hk = V.mean(0), pk.mean(0)
    wk = V.T @ H / B
    lr = cfg.learning_rate
    return RbmParams(params.vb + lr * (v0 - vk), params.hb + lr * (h0 - hk),
                     params.w + lr * (w0 - wk))


def _step_noise(seed: int, step: int, B: int, nv: int, nh: int, cd_k: int,
                dtype, device):
    g = step_generator(seed, 1 + step, device)
    shapes = [(B, nh)] + [(B, nv), (B, nh)] * cd_k
    return [torch.rand(s, generator=g, dtype=dtype, device=device)
            for s in shapes]


def fit(X, nh: int, cfg: RbmTrainConfig, seed: int = 0,
        device: torch.device | str = "cuda") -> RbmParams:
    """Train an RBM on [n, nv] binary data: n // batch_size minibatches an
    epoch (at least one), wrapping around modulo n."""
    X = torch.as_tensor(X, device=device)
    n, nv = X.shape
    dev, dt = X.device, X.dtype
    g = step_generator(seed, 0, dev)
    params = RbmParams(
        vb=torch.zeros(nv, dtype=dt, device=dev),
        hb=torch.zeros(nh, dtype=dt, device=dev),
        w=0.01 * torch.randn(nv, nh, generator=g, dtype=dt, device=dev))
    batches = max(n // cfg.batch_size, 1)
    offsets = torch.arange(cfg.batch_size, device=dev)
    for i in range(cfg.n_epochs * batches):
        idx = ((i % batches) * cfg.batch_size + offsets) % n
        noise = _step_noise(seed, i, cfg.batch_size, nv, nh, cfg.cd_k, dt,
                            dev)
        params = cd_step(params, X[idx], noise, cfg)
    return params


def transform(params: RbmParams, X: torch.Tensor) -> torch.Tensor:
    """Deterministic hidden activations (a layer's output in a DBN)."""
    return torch.sigmoid(X @ params.w + params.hb)


class Dbn:
    """A stack of RBMs trained greedily layer by layer (dbn.hh:12-20).
    Layer i of a fit draws under sub_seed(seed, i)."""

    def __init__(self):
        self.layers: list[RbmParams] = []
        self.sizes: list[int] = []

    def add_layer(self, nh: int):
        self.sizes.append(nh)

    def propagate(self, X: torch.Tensor,
                  upto: int | None = None) -> torch.Tensor:
        for p in self.layers[:upto]:
            X = transform(p, X)
        return X

    def fit(self, X, cfg: RbmTrainConfig, seed: int = 0,
            device: torch.device | str = "cuda"):
        """Train every configured layer bottom-up."""
        X = torch.as_tensor(X, device=device)
        self.layers = []
        for i, nh in enumerate(self.sizes):
            self.layers.append(fit(self.propagate(X), nh, cfg,
                                   sub_seed(seed, i), X.device))
        return self

    def fit_last_layer(self, X, cfg: RbmTrainConfig, seed: int = 0,
                       device: torch.device | str = "cuda"):
        """Train only the top RBM on the penultimate representation
        (DBN::fit_last_layer)."""
        X = torch.as_tensor(X, device=device)
        top = len(self.layers) - 1 if self.layers else 0
        H = self.propagate(X, upto=top)
        layer = fit(H, self.sizes[top], cfg, seed, X.device)
        if self.layers:
            self.layers[-1] = layer
        else:
            self.layers.append(layer)
        return self
