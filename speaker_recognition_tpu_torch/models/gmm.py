"""Diagonal-covariance GMM: EM training, MAP adaptation and bank scoring.

Mirrors speaker_recognition_tpu/models/gmm.py. Training functions take a
leading speaker axis written out where the JAX package vmaps: frames
X [S, T, d], mask [S, T], parameters weights [S, K], means/sigmas
[S, K, d]; they run in the dtype of X (float64 on the CPU for the oracle,
float32 on the card). The density is two matmuls over all frames,

    logp[t, k] = x_t^2 @ A[:, k] + x_t @ B[:, k] + c[k] + log w_k,

and the E-step statistics three more; the M-step carries the reference's
floors (N_k = 0 -> 1e-6, sigma >= sqrt(min_covar)) and the convergence
check runs on the summed log-likelihood on odd iterations (gmm.cc:614-652).

For scoring, a bank folds into one operator

    logp[t, (s,k)] = [x_t^2 | x_t] @ op + cw,
    op = [-1/(2 sigma^2) | mu/sigma^2]^T,
    cw = -1/2 sum_d mu^2/sigma^2 - sum_d log(sqrt(2 pi) sigma) + log w,

followed by a per-speaker logsumexp over the K components, the reference's
underflow floor (gmm.cc:482-492) and a masked sum or mean. `GmmBank` holds
(op, cw) on a device; `batch_bank_avg_loglik` and `bank_sum_loglik` here
are the plain torch versions that ops/gpu_gmm's kernels are held to.

Both take the JAX kernels' `precision` (ops/pallas_gmm.py:100, :211):
"f32", or "bf16", which feeds the matmul bf16 operands with f32
accumulation: op's terms and x rounded to bf16 (nearest even), and x^2
rounded as each JAX kernel rounds it. The batched kernel squares the
rounded x and rounds the square (pallas_gmm.py:176-177, x * x in the
operand dtype); the serial one squares x in f32 and rounds once
(:136-139). cw stays f32. A product of two bf16 values is exact in f32, so
the plain versions round the operands and multiply in f32.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import GmmConfig

LOG_SQRT_2_PI = 0.5 * math.log(2.0 * math.pi)
# log-space equivalent of the reference's linear-space 1e-15 floor, which
# engages only when the sum of w_k N(x) underflows double precision
_UNDERFLOW_LOG = -745.0
# the scoring operands' precisions (the JAX kernels' `precision`)
PRECISIONS = ("f32", "bf16")
# cw of the components the tensor-core kernels' layouts pad a speaker with:
# beside any real component exp(PAD_CW - m) is exactly 0, and unlike -inf
# it never meets another -inf in the online logsumexp (-inf - -inf is NaN)
PAD_CW = -1e30


class GmmParams(NamedTuple):
    """weights [..., K], means [..., K, d], sigmas [..., K, d], as numpy
    arrays or torch tensors; leading axes, if any, are a speaker bank."""

    weights: np.ndarray
    means: np.ndarray
    sigmas: np.ndarray

    @property
    def n_mixtures(self) -> int:
        return self.weights.shape[-1]


def stack_params(params_list) -> GmmParams:
    """Stack per-speaker GmmParams into a bank with a leading S axis."""
    return GmmParams(*(np.stack([np.asarray(getattr(p, f))
                                 for p in params_list])
                       for f in GmmParams._fields))


def bank_operators(bank: GmmParams):
    """Fold a bank into its joint-log-density operator, in float64:
    (op [2d, S*K], cw [S*K])."""
    w = np.asarray(bank.weights, np.float64)
    mu = np.asarray(bank.means, np.float64)
    sig = np.asarray(bank.sigmas, np.float64)
    S, K = w.shape
    d = mu.shape[-1]
    inv_var = 1.0 / (sig * sig)
    op = np.concatenate([-0.5 * inv_var, mu * inv_var],
                        axis=-1).reshape(S * K, 2 * d).T
    cw = (-0.5 * np.sum(mu ** 2 * inv_var, axis=-1)
          - np.sum(LOG_SQRT_2_PI + np.log(sig), axis=-1)
          + np.log(w)).reshape(S * K)
    return op, cw


class GmmBank(nn.Module):
    """A speaker bank of S GMMs with K components each, as the buffers
    op [2d, S*K] and cw [S*K] (float32) on one device."""

    def __init__(self, op: torch.Tensor, cw: torch.Tensor, n_speakers: int,
                 n_mixtures: int):
        super().__init__()
        if op.shape[1] != n_speakers * n_mixtures or op.shape[0] % 2:
            raise ValueError(f"op {tuple(op.shape)} does not fit "
                             f"S={n_speakers}, K={n_mixtures}")
        self.register_buffer("op", op.contiguous())
        self.register_buffer("cw", cw.contiguous())
        self.n_speakers = n_speakers
        self.n_mixtures = n_mixtures
        # (the (op, cw) state it was built from, the value) of the caches
        # below, scoring plans by precision: rebuilt after op or cw is
        # replaced or written to
        self._comp: tuple | None = None
        self._mma: tuple | None = None
        self._tf32: tuple | None = None
        self._plans: dict = {}

    @property
    def dim(self) -> int:
        return self.op.shape[0] // 2

    def _state(self) -> tuple:
        op, cw = self._buffers["op"], self._buffers["cw"]
        return (op, op._version, cw, cw._version)

    def _fresh(self, cached: tuple | None) -> bool:
        """Whether a cache entry was built from the current op and cw (a
        serial decision asks on every call: the buffers are read once)."""
        if cached is None:
            return False
        op, cw = self._buffers["op"], self._buffers["cw"]
        c_op, c_op_v, c_cw, c_cw_v = cached[0]
        return (c_op is op and c_op_v == op._version
                and c_cw is cw and c_cw_v == cw._version)

    def component_operator(self, row: int) -> torch.Tensor:
        """(op, cw) component by component, [S, K, row]: the d quadratic
        terms zero-padded to dp = (row - 4)/2, the d linear terms likewise,
        then cw and zeros. The scoring kernels' layout (csrc/gmm_lse.cuh),
        built once per bank and row, and again after op or cw changes."""
        if not self._fresh(self._comp) or self._comp[1].shape[-1] != row:
            d, dp = self.dim, (row - 4) // 2
            comp = self.op.new_zeros((self.n_speakers * self.n_mixtures, row))
            comp[:, :d] = self.op[:d].T
            comp[:, dp:dp + d] = self.op[d:].T
            comp[:, 2 * dp] = self.cw
            self._comp = (self._state(), comp.reshape(
                self.n_speakers, self.n_mixtures, row))
        return self._comp[1]

    def mma_operator(self, row: int, kp: int) -> torch.Tensor:
        """The bf16 scoring kernels' layout (csrc/gmm_mma.cuh), [S, kp, row]
        bfloat16: a component's row holds its d quadratic terms a =
        -1/(2 sigma^2), then its d linear terms b = mu/sigma^2 (op's, rounded
        to bf16, nearest even), zeros up to dk = row - 8 (2d rounded up to
        a multiple of 16: the MMA's depth), then cw as the bits of an f32
        and zeros (the row's 16-byte tail). Each speaker's K components are
        padded to kp (a multiple of 8: the MMA's width) with zero terms and
        cw = PAD_CW, which add nothing to its logsumexp. Built once per bank
        and layout, and again after op or cw changes."""
        if (not self._fresh(self._mma)
                or self._mma[1].shape[1:] != (kp, row)):
            d, dk = self.dim, row - 8
            S, K = self.n_speakers, self.n_mixtures
            rows = torch.zeros((S, kp, row), dtype=torch.bfloat16,
                               device=self.op.device)
            rows[:, :K, :2 * d] = self.op.T.reshape(S, K, 2 * d).to(
                torch.bfloat16)
            cw = self.cw.new_full((S, kp), PAD_CW, dtype=torch.float32)
            cw[:, :K] = self.cw.reshape(S, K)
            rows.view(torch.float32)[..., dk // 2] = cw
            self._mma = (self._state(), rows)
        return self._mma[1]

    def tf32_operator(self, row: int, kp: int) -> torch.Tensor:
        """The batched f32 kernel's tensor-route layout (csrc/gmm_score.cu),
        [S, kp / 8, row] float32, one row an n8 tile of 8 components: op's
        terms [a | b] zero-padded to the depth 8 nks, nks = (row - 8) / 128
        k-steps of mma.sync m16n8k8, split as hi = round_tf32(v) and lo =
        round_tf32(v - hi); per k-step ks, lane 4 g + t holds (hi(b0),
        hi(b1), lo(b0), lo(b1)), b0 = component g's term 8 ks + t and b1
        its term 8 ks + t + 4; the row's last 8 floats are its components'
        cw. Each speaker's K components are padded to kp (a multiple of 8)
        with zero terms and cw = PAD_CW. Built once per bank and layout,
        and again after op or cw changes."""
        if (not self._fresh(self._tf32)
                or self._tf32[1].shape[1:] != (kp // 8, row)):
            nks = (row - 8) // 128
            d, S, K = self.dim, self.n_speakers, self.n_mixtures
            terms = self.op.new_zeros((S, kp, 8 * nks))
            terms[:, :K, :2 * d] = self.op.T.reshape(S, K, 2 * d)
            hi = round_tf32(terms)
            # [S, tile, g, ks, half, t] -> [S, tile, ks, g, t, half], depth
            # 8 ks + 4 half + t of component 8 tile + g
            frag = [v.view(S, kp // 8, 8, nks, 2, 4).permute(0, 1, 3, 2, 5, 4)
                    for v in (hi, round_tf32(terms - hi))]
            cw = self.cw.new_full((S, kp), PAD_CW)
            cw[:, :K] = self.cw.reshape(S, K)
            self._tf32 = (self._state(), torch.cat(
                [torch.cat(frag, -1).reshape(S, kp // 8, 128 * nks),
                 cw.view(S, kp // 8, 8)], -1))
        return self._tf32[1]

    def scoring_plan(self, make: Callable[["GmmBank", str], object],
                     precision: str = "f32"):
        """What the scoring kernels' wrappers keep of this bank between
        calls (ops/gpu_gmm: the component rows, their pointer, the device,
        the launch shape for d), one plan a precision: make(self,
        precision), cached like component_operator and rebuilt when op or
        cw changes."""
        plan = self._plans.get(precision)
        if not self._fresh(plan):
            plan = self._plans[precision] = (self._state(),
                                             make(self, precision))
        return plan[1]

    @classmethod
    def from_numpy(cls, weights, means, sigmas, device: torch.device | str,
                   dtype: torch.dtype = torch.float32) -> "GmmBank":
        """From a bank's arrays (weights [S, K], means/sigmas [S, K, d]),
        e.g. the GmmParams of either package's session. The kernels take
        float32; a float64 bank serves the plain versions on the CPU or
        the card (ops/gpu_gmm.batch_scores, serial_scores)."""
        params = GmmParams(np.asarray(weights), np.asarray(means),
                           np.asarray(sigmas))
        S, K = params.weights.shape
        op, cw = bank_operators(params)
        to = dict(dtype=dtype, device=device)
        return cls(torch.as_tensor(op, **to), torch.as_tensor(cw, **to), S, K)


def _floored_lse(logp: torch.Tensor, min_prob_sum: float) -> torch.Tensor:
    """logsumexp over the last axis with the reference's underflow floor."""
    lse = torch.logsumexp(logp, dim=-1)
    return torch.where(lse > _UNDERFLOW_LOG, lse,
                       torch.full_like(lse, math.log(min_prob_sum)))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (nearest even), in t's dtype again: a product
    of two such values is exact in f32."""
    return t.to(torch.bfloat16).to(t.dtype)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32 as cvt.rna.tf32.f32 rounds it: the low 13
    bits cleared, to nearest, ties away from zero (the hi of a three-term
    split, csrc/tf32_mma.cuh; the lo is the rounded t - hi)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _operands(bank: GmmBank, X: torch.Tensor, precision: str,
              square_rounded: bool):
    """([..., 2d] [x^2 | x], op) as the matmul of `precision` takes them
    (see the module's docstring); square_rounded: x^2 from the rounded x
    (the batched kernel) rather than from x (the serial one)."""
    if precision == "f32":
        return torch.cat([X * X, X], dim=-1), bank.op
    if precision != "bf16":
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    xb = round_bf16(X)
    x2 = round_bf16(xb * xb) if square_rounded else round_bf16(X * X)
    return torch.cat([x2, xb], dim=-1), round_bf16(bank.op)


def batch_bank_avg_loglik(bank: GmmBank, feats: torch.Tensor,
                          mask: torch.Tensor, min_prob_sum: float = 1e-15,
                          precision: str = "f32") -> torch.Tensor:
    """[B, T, d] features, [B, T] mask -> [B, S] masked per-frame average
    log-likelihoods (src/testbench/gmmset.py:96-100), plain torch, with
    the batched JAX kernel's operands at `precision`."""
    B, T, d = feats.shape
    S, K = bank.n_speakers, bank.n_mixtures
    Z, op = _operands(bank, feats, precision, square_rounded=True)
    logp = Z.reshape(B * T, 2 * d) @ op + bank.cw
    lse = _floored_lse(logp.reshape(B, T, S, K), min_prob_sum)
    m = mask.to(feats.dtype)
    n = torch.clamp_min(m.sum(dim=-1), 1.0)
    return torch.einsum("bts,bt->bs", lse, m) / n[:, None]


def bank_sum_loglik(bank: GmmBank, X: torch.Tensor, mask: torch.Tensor,
                    min_prob_sum: float = 1e-15,
                    precision: str = "f32") -> torch.Tensor:
    """One utterance X [n, d] with mask [n] against the bank -> [S] sums of
    floored per-frame log-likelihoods over the valid frames, plain torch,
    with the serial JAX kernel's operands at `precision`."""
    n, d = X.shape
    Z, op = _operands(bank, X, precision, square_rounded=False)
    logp = Z @ op + bank.cw
    lse = _floored_lse(logp.reshape(n, bank.n_speakers, bank.n_mixtures),
                       min_prob_sum)
    return mask.to(X.dtype) @ lse


def bank_avg_loglik(bank: GmmBank, X: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """[S] per-frame average log-likelihoods of one utterance: the quantity
    GMMSet ranks speakers by (src/gui/skgmm.py:33-39: sum/len)."""
    n = torch.clamp_min(mask.to(X.dtype).sum(), 1.0)
    return bank_sum_loglik(bank, X, mask) / n


# --- EM training ------------------------------------------------------------

def log_gaussians(X: torch.Tensor, means: torch.Tensor,
                  sigmas: torch.Tensor) -> torch.Tensor:
    """Per-frame per-component Gaussian log-density as two matmuls:
    X [..., n, d], means/sigmas [..., K, d] -> [..., n, K]
    (Gaussian::log_probability_of, gmm.cc:78-99)."""
    inv_var = 1.0 / (sigmas * sigmas)
    A = (-0.5 * inv_var).transpose(-1, -2)
    B = (means * inv_var).transpose(-1, -2)
    c = (-0.5 * torch.sum(means * means * inv_var, dim=-1)
         - torch.sum(LOG_SQRT_2_PI + torch.log(sigmas), dim=-1))
    return (X * X) @ A + X @ B + c.unsqueeze(-2)


def log_joint(params: GmmParams, X: torch.Tensor) -> torch.Tensor:
    """log(w_k N(x_t; mu_k, sigma_k)): [..., n, K]."""
    return (log_gaussians(X, params.means, params.sigmas)
            + torch.log(params.weights).unsqueeze(-2))


def per_frame_loglik(params: GmmParams, X: torch.Tensor,
                     min_prob_sum: float = 1e-15) -> torch.Tensor:
    """log p(x_t) per frame, [..., n], with the reference's 1e-15 floor
    where the linear-space sum underflows (gmm.cc:229-244, 482-492)."""
    return _floored_lse(log_joint(params, X), min_prob_sum)


def responsibilities(params: GmmParams, X: torch.Tensor) -> torch.Tensor:
    """Posterior gamma[..., t, k] = p(k | x_t), the E-step of
    gmm.cc:439-495, as a stable softmax over the joint log-density."""
    return torch.softmax(log_joint(params, X), dim=-1)


class EmStats(NamedTuple):
    """Masked sufficient statistics per speaker."""

    n: torch.Tensor      # [...]        valid frames
    N_k: torch.Tensor    # [..., K]
    F_k: torch.Tensor    # [..., K, d]  gamma^T x
    S_k: torch.Tensor    # [..., K, d]  gamma^T x^2


def sufficient_stats(params: GmmParams, X: torch.Tensor,
                     mask: torch.Tensor) -> EmStats:
    """E-step statistics over the valid frames of a padded batch."""
    gamma = responsibilities(params, X) * mask.unsqueeze(-1).to(X.dtype)
    gT = gamma.transpose(-1, -2)
    return EmStats(n=mask.to(X.dtype).sum(dim=-1), N_k=gamma.sum(dim=-2),
                   F_k=gT @ X, S_k=gT @ (X * X))


def m_step(stats: EmStats, cfg: GmmConfig) -> GmmParams:
    """Closed-form M-step with the reference's floors (gmm.cc:396-437,
    502-513)."""
    N_k = torch.where(stats.N_k == 0, torch.full_like(stats.N_k, cfg.min_nk),
                      stats.N_k)
    w = N_k / stats.n.unsqueeze(-1)
    w = w / w.sum(dim=-1, keepdim=True)
    means = stats.F_k / N_k.unsqueeze(-1)
    var = stats.S_k / N_k.unsqueeze(-1) - means * means
    sigmas = torch.clamp_min(torch.sqrt(torch.clamp_min(var, 0.0)),
                             cfg.min_sigma)
    return GmmParams(w, means, sigmas)


def map_m_step(stats: EmStats, ubm: GmmParams, cfg: GmmConfig) -> GmmParams:
    """MAP mean re-estimation, weights and sigmas pinned to the UBM:
    alpha_k = N_k/(N_k + r), mean_k = alpha_k E_k[x] + (1-alpha_k) ubm_k
    (gmmubm.cc:53-81). `ubm` is one GMM shared by every speaker."""
    N_k = torch.where(stats.N_k == 0, torch.full_like(stats.N_k, cfg.min_nk),
                      stats.N_k)
    alpha = (N_k / (N_k + cfg.relevance_factor)).unsqueeze(-1)
    means = (alpha * (stats.F_k / N_k.unsqueeze(-1))
             + (1.0 - alpha) * ubm.means)
    return GmmParams(torch.broadcast_to(ubm.weights, N_k.shape), means,
                     torch.broadcast_to(ubm.sigmas, means.shape))


def speaker_generator(seed: int, speaker: int) -> torch.Generator:
    """The CPU generator that draws speaker `speaker`'s init under `seed`,
    so the init is the same whichever device trains."""
    state = np.random.SeedSequence([seed, speaker]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def init_params(X: torch.Tensor, mask: torch.Tensor, K: int,
                seed: int, means: torch.Tensor | None = None) -> GmmParams:
    """Reference init per speaker: K uniformly drawn valid frames as means
    (k-means off) or the given `means` [S, K, d] (k-means' centroids), the
    global data std (ddof=1) as every sigma, uniform weights
    (gmm.cc:306-361). X [S, T, d]; each speaker's valid frames must be a
    contiguous prefix, so an index < n is a valid frame."""
    S, T, d = X.shape
    m = mask.to(X.dtype).unsqueeze(-1)
    n = m.sum(dim=-2)                                      # [S, 1]
    data_mean = (X * m).sum(dim=-2) / n
    ss = ((X - data_mean.unsqueeze(-2)) ** 2 * m).sum(dim=-2) / (n - 1.0)
    sigma0 = torch.sqrt(ss)                                # [S, d]
    if means is None:
        n_valid = mask.sum(dim=-1).cpu()
        idx = torch.stack([
            torch.randint(0, max(int(n_valid[s]), 1), (K,),
                          generator=speaker_generator(seed, s))
            for s in range(S)]).to(X.device)
        means = torch.gather(X, 1, idx.unsqueeze(-1).expand(S, K, d))
    return GmmParams(
        weights=torch.full((S, K), 1.0 / K, dtype=X.dtype, device=X.device),
        means=means,
        sigmas=sigma0.unsqueeze(-2).expand(S, K, d).contiguous())


def total_loglik(params: GmmParams, X: torch.Tensor, mask: torch.Tensor,
                 min_prob_sum: float = 1e-15) -> torch.Tensor:
    """Summed log-likelihood over the valid frames (GMM::
    log_probability_of): [...]."""
    return (per_frame_loglik(params, X, min_prob_sum)
            * mask.to(X.dtype)).sum(dim=-1)


def avg_loglik(params: GmmParams, X: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Per-frame average score (src/gui/skgmm.py:33-39: sum/len)."""
    n = torch.clamp_min(mask.to(X.dtype).sum(dim=-1), 1.0)
    return total_loglik(params, X, mask) / n


def _select(active: torch.Tensor, new: GmmParams,
            old: GmmParams) -> GmmParams:
    """Per speaker: `new` where active, else `old`."""
    return GmmParams(*(torch.where(active.reshape(-1, *[1] * (a.dim() - 1)),
                                   a, b) for a, b in zip(new, old)))


def _no_reduce(tensors: list) -> list:
    return tensors


def _em_loop(X, mask, params0: GmmParams, cfg: GmmConfig,
             step_fn: Callable[[GmmParams], GmmParams],
             log: dict | None = None, reduce=_no_reduce):
    """Iterate `step_fn` over a bank, checking convergence per speaker on
    odd iterations against the summed log-likelihood (gmm.cc:614-652).

    The JAX package vmaps a while_loop: it steps until every speaker is
    done, and a speaker whose own predicate is false keeps its carry. Here
    each speaker carries last_ll and done; a done speaker's parameters are
    frozen. Every speaker still stepping has run exactly `it` iterations,
    so one host counter stands for the vmapped loop's per-speaker i. The
    all-done test reads one flag to the host per check iteration; `log`,
    if given, receives the iteration and host-sync counts. `reduce` sums a
    list of per-shard tensors over the shards of a data-parallel fit
    (parallel/mesh.sharded_fit; the identity by default), here the
    log-likelihood, in step_fn the statistics.
    Returns (params, [S] log-likelihood of the last check)."""
    def loglik(p):
        return reduce([total_loglik(p, X, mask, cfg.min_prob_sum)])[0]

    if cfg.threshold <= 0:
        # early stopping off: a fixed count, no monitoring pass
        params = params0
        for _ in range(cfg.n_iterations):
            params = step_fn(params)
        if log is not None:
            log.update(iterations=cfg.n_iterations, host_syncs=0)
        return params, loglik(params)

    S = X.shape[0]
    last_ll = torch.full((S,), -torch.finfo(X.dtype).max, dtype=X.dtype,
                         device=X.device)
    done = torch.zeros(S, dtype=torch.bool, device=X.device)
    params = params0
    it = syncs = 0
    while it < cfg.n_iterations:
        new = step_fn(params)
        active = ~done
        params = _select(active, new, params)
        it += 1
        if it % cfg.check_every == 0:  # the odd iterations, counting from 0
            ll = loglik(new)
            diff = ll - last_ll
            converged = ((diff.abs() / ll.abs() < cfg.threshold)
                         & (diff < cfg.threshold))
            last_ll = torch.where(active, ll, last_ll)
            done = done | (active & converged)
            syncs += 1
            if bool(done.all()):
                break
    if log is not None:
        log.update(iterations=it, host_syncs=syncs)
    return params, last_ll


def fit(X: torch.Tensor, mask: torch.Tensor, cfg: GmmConfig, seed: int = 0,
        log: dict | None = None):
    """Full EM fit of a bank, one GMM per speaker (GMMTrainerBaseline::
    train, gmm.cc:581-653): X [S, T, d] -> (params, [S] log-likelihood).
    Speaker s draws its init from speaker_generator(seed, s)."""
    params0 = init_params(X, mask, cfg.n_mixtures, seed)
    return fit_from_params(X, mask, params0, cfg, log)


def fit_from_params(X: torch.Tensor, mask: torch.Tensor, params0: GmmParams,
                    cfg: GmmConfig, log: dict | None = None,
                    reduce=_no_reduce):
    """EM from explicit initial parameters [S, ...]; with `reduce`, X is
    one shard of the frames and the statistics and log-likelihoods are
    summed over the shards (see _em_loop)."""
    def step(p):
        return m_step(EmStats(*reduce(list(sufficient_stats(p, X, mask)))),
                      cfg)
    return _em_loop(X, mask, params0, cfg, step, log, reduce)


def fit_with_init(X: torch.Tensor, mask: torch.Tensor, cfg: GmmConfig,
                  seed: int = 0, log: dict | None = None):
    """Full fit of a bank honoring cfg.init_with_kmeans: k-means|| means
    (models/kmeans.kmeansii_device, every speaker at once on the device;
    gmm.cc:330-346), the reference init's weights and sigmas, then EM.
    `log` receives EM's iterations and host syncs, and k-means' as
    kmeans_rounds, kmeans_iterations and kmeans_host_syncs."""
    if not cfg.init_with_kmeans:
        return fit(X, mask, cfg, seed, log)
    from . import kmeans

    klog: dict = {}
    C, _ = kmeans.kmeansii_device(X, mask, cfg.n_mixtures, seed, log=klog)
    params0 = init_params(X, mask, cfg.n_mixtures, seed, C.to(X.dtype))
    params, ll = fit_from_params(X, mask, params0, cfg, log)
    if log is not None:
        log.update(kmeans_rounds=klog["rounds"],
                   kmeans_iterations=klog["iterations"],
                   kmeans_host_syncs=klog["host_syncs"])
    return params, ll


def fit_from_ubm(X: torch.Tensor, mask: torch.Tensor, ubm: GmmParams,
                 cfg: GmmConfig, log: dict | None = None):
    """MAP adaptation of every speaker from one UBM (weights [K], means and
    sigmas [K, d]; GMMUBMTrainerBaseline, gmmubm.cc:25-81). Each speaker
    starts from a copy of the UBM; every iteration re-blends the means."""
    S = X.shape[0]
    params0 = GmmParams(*(a.expand(S, *a.shape) for a in ubm))
    step = lambda p: map_m_step(  # noqa: E731
        sufficient_stats(p, X, mask), ubm, cfg)
    return _em_loop(X, mask, params0, cfg, step, log)


def params_to(params: GmmParams, dtype: torch.dtype,
              device: torch.device | str) -> GmmParams:
    """numpy or torch parameters -> torch tensors of `dtype` on `device`."""
    return GmmParams(*(torch.as_tensor(a, dtype=dtype, device=device)
                       for a in params))


def params_numpy(params: GmmParams) -> GmmParams:
    """torch parameters -> contiguous numpy arrays on the host."""
    return GmmParams(*(a.detach().cpu().contiguous().numpy()
                       for a in params))
