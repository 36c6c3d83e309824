"""Joint Factor Analysis on UBM sufficient statistics, batched in torch.

The counterpart of speaker_recognition_tpu/models/jfa.py (the reference's
MATLAB JFA, src/jfa/*.m). The model

    M_session = m + v' y_speaker + d .* z_speaker + u' x_session

lives over supervectors of dimension D = K*dim, component-major (the first
`dim` entries belong to Gaussian 0, collect_suf_stats.m:20-23). Every
per-session or per-speaker posterior is a batched `torch.linalg.inv` over
[S, nf, nf]; the per-component precision blocks G_c = u_c E_c^-1 u_c' are
one [K, nf, nf] tensor contracted against the counts in one einsum; the
M-steps are batched `torch.linalg.solve`s over [K, nf, nf]; speakers are
grouped by `index_add_`. Everything runs in the dtype and on the device
of the statistics: plain torch, no kernel (the JAX package has none here
either).

Conventions (the reference's, as the JAX package states them):
  * stats: N [n_sessions, K] soft counts; F [n_sessions, D] uncentered
    first-order stats (collect_suf_stats.m:1-24);
  * x/u: Fh = F - Nh .* (m + y v + z .* d); L = I + sum_c G_c N_c;
    x = L^-1 u E^-1 Fh; A_c = sum_j (L_j^-1 + x_j x_j') N_jc;
    C = sum_j x_j' Fh_j; u_c = A_c^-1 C_c (estimate_x_and_u.m:88-140);
  * y/v: the same on per-speaker summed, channel-compensated stats
    (estimate_y_and_v.m:83-139);
  * z/d: closed-form diagonal (estimate_z_and_d.m:80-113);
  * linear scoring: M F_norm' with M = (z .* d + y v) / E and
    channel-compensated, count-normalized F (linear_scoring.m:50-71);
  * random init: randn(nf, D) * sum(E) * 0.001 (sc_train_u_from_files.m:31)
    from an explicit torch.Generator; the train_* functions also take the
    init as a tensor, so that a test can feed the JAX package's draws.

Speaker ids are 0 .. n_speakers - 1, each with a session; n_speakers is
their count (the JAX package's train_* take max() + 1, which counts
phantom speakers for ids with gaps).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import gmm

__all__ = [
    "JfaHyper", "collect_stats", "estimate_x", "estimate_y", "estimate_z",
    "update_u", "update_v", "update_d", "train_u", "train_v", "train_d",
    "linear_scores", "random_init", "hyper_from_numpy", "hyper_numpy",
    "n_speakers",
]


class JfaHyper(NamedTuple):
    """m/E: [D] mean/variance supervectors; v: [nv, D] eigenvoices;
    u: [nu, D] eigenchannels; d: [D] residual diagonal."""

    m: torch.Tensor
    E: torch.Tensor
    v: torch.Tensor
    u: torch.Tensor
    d: torch.Tensor

    @property
    def D(self) -> int:
        return self.m.shape[-1]


def hyper_from_numpy(hyper, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda") -> JfaHyper:
    """Either package's JfaHyper (a NamedTuple of arrays, e.g. the JAX
    package's), or a mapping of its fields (a model npz) -> the port's
    tensors on `device`."""
    fields = hyper._asdict() if hasattr(hyper, "_asdict") else hyper
    return JfaHyper(*(torch.as_tensor(np.asarray(fields[f]), dtype=dtype,
                                      device=device)
                      for f in JfaHyper._fields))


def hyper_numpy(hyper: JfaHyper) -> dict:
    """The port's JfaHyper -> {field: numpy array}, the model npz's layout."""
    return {f: getattr(hyper, f).detach().cpu().numpy()
            for f in JfaHyper._fields}


def n_speakers(spk_ids) -> int:
    """The number of distinct speaker ids, which must be 0 .. n - 1."""
    ids = np.unique(np.asarray(torch.as_tensor(spk_ids).cpu()))
    if len(ids) == 0 or ids[0] != 0 or ids[-1] != len(ids) - 1:
        raise ValueError(f"speaker ids must be 0 .. n-1, each with a "
                         f"session; got {ids[:8].tolist()}...")
    return len(ids)


def collect_stats(ubm: gmm.GmmParams, X: torch.Tensor, mask: torch.Tensor):
    """Baum-Welch stats against the UBM (weights [K], means/sigmas [K, d])
    of utterances X [..., T, d] with mask [..., T]: (N [..., K], F [...,
    K*d]) (collect_suf_stats.m:1-24), through the EM's E-step
    (models/gmm.sufficient_stats)."""
    stats = gmm.sufficient_stats(ubm, X, mask)
    return stats.N_k, stats.F_k.flatten(-2)


def _expand(N: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., K] counts -> [..., K*dim]."""
    return torch.repeat_interleave(N, dim, dim=-1)


def _precision_blocks(mat: torch.Tensor, E: torch.Tensor,
                      K: int) -> torch.Tensor:
    """G_c = mat_c (1/E_c) mat_c^T per component: [K, nf, nf]
    (estimate_x_and_u.m:88-91)."""
    nf, D = mat.shape
    mc = mat.reshape(nf, K, D // K).transpose(0, 1)       # [K, nf, dim]
    Ec = E.reshape(K, D // K)
    return torch.einsum("kad,kd,kbd->kab", mc, 1.0 / Ec, mc)


def _speaker_sums(values: torch.Tensor, spk_ids: torch.Tensor,
                  n_spk: int) -> torch.Tensor:
    """Sum sessions by speaker: [n_spk, ...]."""
    out = values.new_zeros((n_spk, *values.shape[1:]))
    return out.index_add_(0, spk_ids, values)


def _posterior(N: torch.Tensor, G: torch.Tensor, rhs: torch.Tensor):
    """(x, L^-1) with L = I + sum_c N_c G_c per row, x = rhs L^-1."""
    nf = G.shape[-1]
    L = (torch.eye(nf, dtype=G.dtype, device=G.device)
         + torch.einsum("jc,cab->jab", N, G))
    invL = torch.linalg.inv(L)
    return torch.einsum("ja,jab->jb", rhs, invL), invL


def _accumulators(N, invL, x, Fh):
    """A [K, nf, nf] = sum_j N_jc (L_j^-1 + x_j x_j'), C [nf, D] = x' Fh."""
    P = invL + torch.einsum("ja,jb->jab", x, x)
    return torch.einsum("jc,jab->cab", N, P), x.T @ Fh


def estimate_x(F, N, hyper: JfaHyper, y, z, spk_ids, n_components: int):
    """E-step of the channel factors and the u M-step's accumulators:
    (x [n_sessions, nu], A [K, nu, nu], C [nu, D]) (estimate_x_and_u.m:
    96-126, every session at once)."""
    K = n_components
    dim = F.shape[-1] // K
    G = _precision_blocks(hyper.u, hyper.E, K)
    shift = hyper.m + y[spk_ids] @ hyper.v + z[spk_ids] * hyper.d
    Fh = F - _expand(N, dim) * shift
    x, invL = _posterior(N, G, (Fh / hyper.E) @ hyper.u.T)
    return (x, *_accumulators(N, invL, x, Fh))


def update_u(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """u_c = A_c^-1 C_c per component (estimate_x_and_u.m:133-140)."""
    K, nf, _ = A.shape
    D = C.shape[-1]
    Cc = C.reshape(nf, K, D // K).transpose(0, 1)         # [K, nf, dim]
    return torch.linalg.solve(A, Cc).transpose(0, 1).reshape(nf, D)


update_v = update_u  # the same form (estimate_y_and_v.m:131-139)


def estimate_y(F, N, hyper: JfaHyper, x, z, spk_ids, n_components: int,
               n_spk: int):
    """E-step of the speaker factors on per-speaker summed,
    channel-compensated stats and the v M-step's accumulators: (y [n_spk,
    nv], A [K, nv, nv], C [nv, D]) (estimate_y_and_v.m:83-129)."""
    K = n_components
    dim = F.shape[-1] // K
    G = _precision_blocks(hyper.v, hyper.E, K)
    chan = (x @ hyper.u) * _expand(N, dim)
    Fs = _speaker_sums(F - chan, spk_ids, n_spk)
    Nss = _speaker_sums(N, spk_ids, n_spk)
    Fs = Fs - (hyper.m + z * hyper.d) * _expand(Nss, dim)
    y, invL = _posterior(Nss, G, (Fs / hyper.E) @ hyper.v.T)
    return (y, *_accumulators(Nss, invL, y, Fs))


def estimate_z(F, N, hyper: JfaHyper, x, y, spk_ids, n_components: int,
               n_spk: int):
    """E-step of the residual factors and the d M-step's accumulators:
    (z [n_spk, D], a [D], b [D]) (estimate_z_and_d.m:80-106)."""
    dim = F.shape[-1] // n_components
    Nh = _expand(N, dim)
    Fs = _speaker_sums(F - (x @ hyper.u) * Nh, spk_ids, n_spk)
    Ns = _speaker_sums(Nh, spk_ids, n_spk)
    Fs = Fs - (hyper.m + y @ hyper.v) * Ns
    L = 1.0 + Ns / hyper.E * hyper.d ** 2
    z = Fs / hyper.E * hyper.d / L
    return z, ((1.0 / L + z * z) * Ns).sum(dim=0), (z * Fs).sum(dim=0)


def update_d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d = b ./ a (estimate_z_and_d.m:108-113)."""
    return b / a


def random_init(generator: torch.Generator, nf: int,
                E: torch.Tensor) -> torch.Tensor:
    """randn(nf, D) * sum(E) * 0.001 (sc_train_u_from_files.m:31,
    sc_train_v_from_files.m:37), drawn on the generator's device (the CPU
    for a default torch.Generator) and moved to E's."""
    draw = torch.randn((nf, E.shape[-1]), generator=generator,
                       dtype=E.dtype, device=generator.device)
    return draw.to(E.device) * E.sum() * 1e-3


def _init(v0, generator, nf: int, E: torch.Tensor) -> torch.Tensor:
    if v0 is not None:
        return torch.as_tensor(v0, dtype=E.dtype, device=E.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or the init tensor")
    return random_init(generator, nf, E)


def train_v(F, N, m, E, nv: int, spk_ids, n_components: int,
            n_iter: int = 20, generator: torch.Generator | None = None,
            v0=None):
    """Eigenvoice training (sc_train_v_from_files.m): iterate y/v with
    u = 0 and d = 0 from v0, or from random_init(generator, nv, E).
    Returns (v, y)."""
    n_spk = n_speakers(spk_ids)
    D = F.shape[-1]
    hyper = JfaHyper(m=m, E=E, v=_init(v0, generator, nv, E),
                     u=F.new_zeros((1, D)), d=F.new_zeros(D))
    x = F.new_zeros((F.shape[0], 1))
    z = F.new_zeros((n_spk, D))
    y = None
    for _ in range(n_iter):
        y, A, C = estimate_y(F, N, hyper, x, z, spk_ids, n_components, n_spk)
        hyper = hyper._replace(v=update_v(A, C))
    return hyper.v, y


def train_u(F, N, m, E, v, y, nu: int, spk_ids, n_components: int,
            n_iter: int = 20, generator: torch.Generator | None = None,
            u0=None):
    """Eigenchannel training (sc_train_u_from_files.m): y fixed, iterate
    x/u from u0 or random_init(generator, nu, E). Returns (u, x)."""
    n_spk = n_speakers(spk_ids)
    D = F.shape[-1]
    hyper = JfaHyper(m=m, E=E, v=v, u=_init(u0, generator, nu, E),
                     d=F.new_zeros(D))
    z = F.new_zeros((n_spk, D))
    x = None
    for _ in range(n_iter):
        x, A, C = estimate_x(F, N, hyper, y, z, spk_ids, n_components)
        hyper = hyper._replace(u=update_u(A, C))
    return hyper.u, x


def train_d(F, N, m, E, v, u, y, x, spk_ids, n_components: int,
            n_iter: int = 20):
    """Residual-diagonal training (sc_train_d_from_files.m): iterate z/d
    from d = 1. Returns (d, z)."""
    n_spk = n_speakers(spk_ids)
    hyper = JfaHyper(m=m, E=E, v=v, u=u, d=F.new_ones(F.shape[-1]))
    z = None
    for _ in range(n_iter):
        z, a, b = estimate_z(F, N, hyper, x, y, spk_ids, n_components, n_spk)
        hyper = hyper._replace(d=update_d(a, b))
    return hyper.d, z


def linear_scores(F, N, hyper: JfaHyper, y, z, x, n_components: int):
    """Linear scoring (linear_scoring.m:50-71): test stats F [n_test, D],
    N [n_test, K], model factors y [n_models, nv], z [n_models, D], test
    channel factors x [n_test, nu] -> scores [n_models, n_test]."""
    dim = F.shape[-1] // n_components
    M = (z * hyper.d + y @ hyper.v) / hyper.E
    chan = (hyper.m + x @ hyper.u) * _expand(N, dim)
    Fc = (F - chan) / N.sum(dim=-1, keepdim=True)
    return M @ Fc.T
