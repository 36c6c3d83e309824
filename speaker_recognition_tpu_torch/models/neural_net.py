"""Backprop MLP classifier with optional DBN pretraining, as in
speaker_recognition_tpu/models/neural_net.py.

The reference's NeuralNet/Neuron/NeuralNetLayer stack
(src/nn/src/include/neural-net.hh:22-120, neural-net.cc) with the
per-neuron weight loops as layer matmuls; `fit_dbn` seeds the hidden
layers from a greedily pretrained DBN (neural-net.hh:96-108) before the
supervised fine-tuning. The output layer is one logistic unit per class
with squared error against one-hot targets, and the class is the argmax
output unit. The gradient of a minibatch step comes from torch.autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rbm as rbm_mod

__all__ = ["NeuralNet", "MlpParams", "forward", "loss", "sgd_step"]


class MlpParams(NamedTuple):
    weights: tuple  # per layer: [n_in, n_out]
    biases: tuple   # per layer: [n_out]


def forward(params: MlpParams, X: torch.Tensor) -> torch.Tensor:
    """The sigmoid layers' output [B, n_classes]."""
    h = X
    for W, b in zip(params.weights, params.biases):
        h = torch.sigmoid(h @ W + b)
    return h


def loss(params: MlpParams, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Half the mean over the batch of the squared error to targets Y."""
    return 0.5 * ((forward(params, X) - Y) ** 2).sum(dim=-1).mean()


def sgd_step(params: MlpParams, X: torch.Tensor, Y: torch.Tensor,
             lr: float) -> MlpParams:
    """One minibatch step: params - lr * grad(loss)."""
    leaves = [p.detach().requires_grad_(True)
              for p in (*params.weights, *params.biases)]
    n = len(params.weights)
    grads = torch.autograd.grad(
        loss(MlpParams(tuple(leaves[:n]), tuple(leaves[n:])), X, Y), leaves)
    new = [p.detach() - lr * g for p, g in zip(leaves, grads)]
    return MlpParams(tuple(new[:n]), tuple(new[n:]))


class NeuralNet:
    """add_layer/fit/fit_dbn/predict mirror neural-net.hh's surface. The
    init draws 0.1 * N(0, 1) weights from sub_seed(seed, 0), the DBN
    pretraining runs under sub_seed(seed, 1)."""

    def __init__(self, n_iter: int = 100, learning_rate: float = 0.1,
                 batch_size: int = 32, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.n_iter = n_iter
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.hidden_sizes: list[int] = []
        self.params: MlpParams | None = None
        self.seed = seed
        self.device = torch.device(device)
        self.n_classes = 0

    def add_layer(self, size: int):
        self.hidden_sizes.append(size)

    def _init_params(self, n_in: int, n_out: int, init_hidden=None):
        sizes = [n_in] + self.hidden_sizes + [n_out]
        g = rbm_mod.step_generator(rbm_mod.sub_seed(self.seed, 0), 0,
                                   self.device)
        Ws, bs = [], []
        for i in range(len(sizes) - 1):
            if init_hidden is not None and i < len(init_hidden):
                W, b = init_hidden[i]
            else:
                W = 0.1 * torch.randn(sizes[i], sizes[i + 1], generator=g,
                                      device=self.device)
                b = torch.zeros(sizes[i + 1])
            Ws.append(torch.as_tensor(W, dtype=torch.float32,
                                      device=self.device))
            bs.append(torch.as_tensor(b, dtype=torch.float32,
                                      device=self.device))
        return MlpParams(tuple(Ws), tuple(bs))

    def fit(self, X, y, init_hidden=None):
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32,
                            device=self.device)
        y = np.asarray(y, np.int64)
        self.n_classes = int(y.max()) + 1
        Y = torch.as_tensor(np.eye(self.n_classes, dtype=np.float32)[y],
                            device=self.device)
        params = self._init_params(X.shape[1], self.n_classes, init_hidden)
        n = len(y)
        steps = self.n_iter * max(n // self.batch_size, 1)
        offsets = torch.arange(self.batch_size, device=self.device)
        for i in range(steps):
            idx = (i * self.batch_size + offsets) % n
            params = sgd_step(params, X[idx], Y[idx], self.learning_rate)
        self.params = params
        return self

    def fit_dbn(self, X, y, rbm_cfg: rbm_mod.RbmTrainConfig | None = None):
        """Greedy RBM pretraining of the hidden layers, then supervised
        fine-tuning (neural-net.hh:96-108 fit_dbn/from_dbn)."""
        rbm_cfg = rbm_cfg or rbm_mod.RbmTrainConfig(n_epochs=20)
        dbn = rbm_mod.Dbn()
        for s in self.hidden_sizes:
            dbn.add_layer(s)
        dbn.fit(torch.as_tensor(np.asarray(X), dtype=torch.float32,
                                device=self.device), rbm_cfg,
                rbm_mod.sub_seed(self.seed, 1), self.device)
        return self.fit(X, y, init_hidden=[(p.w, p.hb) for p in dbn.layers])

    def predict_proba(self, X) -> np.ndarray:
        assert self.params is not None
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32,
                            device=self.device)
        return forward(self.params, X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=-1)
