"""Continuous Restricted Boltzmann Machine (Chen & Murray 2003) with CD-k,
as in speaker_recognition_tpu/models/crbm.py.

The reference's C++ CRBM (src/nn/src/crbm.cc, include/crbm.hh) is the
alternative speaker model, classified by argmin per-speaker reconstruction
error (src/nn/src/main.cc:453-465). It trains one sample at a time over a
thread pool; here a minibatch is two matmuls a CD step, and a speaker bank
trains as batched matmuls over a leading S axis.

Semantics of the reference, kept:
  * hidden unit: h = sig(a_j * (w'v + b_h + sigma*N(0,1)); range) with the
    range-scaled sigmoid lo + (hi-lo)/(1+e^-x) (crbm.cc:26-29,92-102);
    hidden range fixed [0,1], visible range tracked from the data
    (crbm.cc:496-527), no slope factor on the visible side
    (crbm.cc:105-115); noise only when the caller gives it;
  * sigma = 0.2 fixed (crbm.cc:118-123);
  * CD-k statistics: <v h'> at the data and after k (visible, hidden)
    resamples, averaged over the minibatch (crbm.cc:407-466);
  * updates: momentum 0.9, weight decay C = 0.001, lr 0.1; slope update
    delta_a = (<h^2>_0 - <h^2>_inf)/a^2 (crbm.cc:427-448);
  * init: N(0, 0.01) weights and biases, a = 1 (crbm.cc:468-480);
  * reconstruction error: one noise-free up-down pass, squared error
    (crbm.cc:187-200);
  * each speaker's epoch walks ITS OWN frames in minibatches, wrapping
    around modulo its valid count: `for i in 0..n step batch`
    (crbm.cc:398-405), per speaker (main.cc:500-518); at
    speaker_task_config each speaker's batch is all its own frames
    (batch_train_size = X.size(), main.cc:422-439).

Deliberate deviation from the JAX package: its `_fit_segment`
(models/crbm.py:187-199) takes the minibatch walk from the bank's padded
row count and only the update budget from the valid count, so a bank
member's model there depends on the longest speaker in the bank; at
speaker_task_config(padded rows) a shorter speaker's "full batch" wraps
over its frames, counting some twice. Here each speaker's walk, and its
full batch, follow its own valid count, as the reference's do, and
nothing a speaker computes depends on the padding
(tests/test_torch_crbm.py).

Draws: the init comes from a generator on the computation's device seeded
from (seed, 0) and step i's Gaussian noise from one seeded from
(seed, 1 + i) (models/rbm.step_generator), the whole bank's noise of a
step as one tensor [S, batch, .] whose shape does not depend on the
padding. So training in segments from a saved state gives the bits of one
run. The card and the CPU draw different numbers from one seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rbm import step_generator

__all__ = ["CrbmParams", "CrbmTrainConfig", "CrbmTrainState", "fit",
           "fit_bank", "fit_bank_segment", "init_train_state",
           "reconstruction_error", "bank_reconstruction_errors",
           "predict_bank", "SIGMA", "speaker_task_config", "sample_hidden",
           "sample_visible", "init_params", "cd_batch", "step_noise"]

SIGMA = 0.2  # crbm.cc:122


class CrbmParams(NamedTuple):
    """vb [nv], hb [nh], w [nv, nh], a [nh] slopes, vlo/vhi [nv] visible
    range. A leading axis, if any, is a speaker bank."""

    vb: torch.Tensor
    hb: torch.Tensor
    w: torch.Tensor
    a: torch.Tensor
    vlo: torch.Tensor
    vhi: torch.Tensor


class CrbmTrainConfig(NamedTuple):
    """The JAX package's fields, and `full_batch`: each speaker's batch is
    its own valid frames (batch_size is then not read)."""

    learning_rate: float = 0.1   # crbm.hh:62
    n_epochs: int = 100          # crbm.hh:62 nr_epoch_max
    batch_size: int = 100
    cd_k: int = 1
    weight_decay: float = 0.001  # C, crbm.hh:70
    momentum: float = 0.9        # crbm.hh:71
    full_batch: bool = False


def speaker_task_config(n_frames: int) -> CrbmTrainConfig:
    """The reference's speaker-identification trainer settings
    (overall_test_train_crbm, src/nn/src/main.cc:422-439): full-batch
    training (batch_train_size = X.size()) for 2000 epochs at lr 0.1 and
    CD-1, on at most ~1000 frames per speaker. The class defaults are
    crbm.hh's generic ones, under which the minibatch-100 regime diverges
    on speech features for a fraction of speakers
    (experiments/crbm_accuracy.py); pass this config for enrollment
    banks. batch_size is the JAX package's (n_frames, the bank's padded
    row count there); full_batch gives each speaker of a bank its own
    count, as the reference's X.size() does."""
    return CrbmTrainConfig(n_epochs=2000, batch_size=max(int(n_frames), 1),
                           full_batch=True)


class _Velocity(NamedTuple):
    dv: torch.Tensor
    dh: torch.Tensor
    dw: torch.Tensor
    da: torch.Tensor


class CrbmTrainState(NamedTuple):
    """Resumable training state of a bank: the parameters, the momentum
    velocities and the next global step (the reference's periodic model
    save, nr_epoch_save, crbm.cc:370-376). Training in segments from a
    saved state gives the bits of one run with the same seed."""

    params: CrbmParams
    vel: _Velocity
    step: int


def _scaled_sigmoid(x, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(x)


def _row(v: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., 1, n]: a per-unit vector against [..., B, n]."""
    return v.unsqueeze(-2)


def sample_hidden(params: CrbmParams, V: torch.Tensor,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """[..., B, nv] -> [..., B, nh]; noisy when given standard normal
    `noise` of the output's shape (crbm.cc:92-102)."""
    act = V @ params.w + _row(params.hb)
    if noise is not None:
        act = act + SIGMA * noise
    return _scaled_sigmoid(act * _row(params.a), 0.0, 1.0)


def sample_visible(params: CrbmParams, H: torch.Tensor,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """[..., B, nh] -> [..., B, nv] (crbm.cc:105-115; no slope factor)."""
    act = H @ params.w.transpose(-1, -2) + _row(params.vb)
    if noise is not None:
        act = act + SIGMA * noise
    return _scaled_sigmoid(act, _row(params.vlo), _row(params.vhi))


def cd_batch(params: CrbmParams, vel: _Velocity, batch: torch.Tensor, noise,
             cfg: CrbmTrainConfig, valid: torch.Tensor | None = None):
    """One minibatch CD-k + momentum update (train_batch, crbm.cc:381-452)
    of a bank, batch [..., B, nv], given its standard normal noise: 2 cd_k
    + 1 tensors, the hidden sample's [..., B, nh], then per Gibbs step the
    visible's [..., B, nv] and the hidden's. `valid` [..., B] (full-batch
    training): the statistics average over its rows alone. Returns
    (params, velocity)."""
    if valid is None:
        B = batch.shape[-2]
        mean = lambda x: x.mean(-2)  # noqa: E731
        outer = lambda V, H: V.transpose(-1, -2) @ H / B  # noqa: E731
    else:  # the rows' weights 1/n_s (0 past n_s), as products
        w = valid.to(batch.dtype)
        w = (w / w.sum(-1, keepdim=True).clamp_min(1)).unsqueeze(-1)
        wt = w.transpose(-1, -2)                            # [..., 1, B]
        mean = lambda x: (wt @ x).squeeze(-2)  # noqa: E731
        outer = lambda V, H: (V * w).transpose(-1, -2) @ H  # noqa: E731
    V = batch
    H = sample_hidden(params, V, noise[0])
    v0, h0 = mean(V), mean(H)
    h2_0 = mean(H * H)
    w0 = outer(V, H)
    for j in range(cfg.cd_k):
        V = sample_visible(params, H, noise[1 + 2 * j])
        H = sample_hidden(params, V, noise[2 + 2 * j])
    vk, hk = mean(V), mean(H)
    h2_k = mean(H * H)
    wk = outer(V, H)

    lr, C, mom = cfg.learning_rate, cfg.weight_decay, cfg.momentum
    dv = mom * vel.dv + lr * ((v0 - vk) - C * params.vb)
    dh = mom * vel.dh + lr * ((h0 - hk) - C * params.hb)
    dw = mom * vel.dw + lr * ((w0 - wk) - C * params.w)
    da = mom * vel.da + lr * ((h2_0 - h2_k) / (params.a * params.a)
                              - C * params.a)
    new = CrbmParams(params.vb + dv, params.hb + dh, params.w + dw,
                     params.a + da, params.vlo, params.vhi)
    return new, _Velocity(dv, dh, dw, da)


def init_params(seed: int, nh: int, X: torch.Tensor,
                mask: torch.Tensor) -> CrbmParams:
    """N(0, 0.01) init of a bank from the generator of (seed, 0), and the
    visible range from each speaker's valid frames (crbm.cc:468-527).
    X [S, n, nv], mask [S, n]."""
    S, _, nv = X.shape
    dev, dt = X.device, X.dtype
    g = step_generator(seed, 0, dev)
    big = torch.finfo(dt).max
    m = mask.unsqueeze(-1)
    draw = lambda *shape: 0.01 * torch.randn(  # noqa: E731
        shape, generator=g, dtype=dt, device=dev)
    return CrbmParams(
        vb=draw(S, nv), hb=draw(S, nh), w=draw(S, nv, nh),
        a=torch.ones(S, nh, dtype=dt, device=dev),
        vlo=torch.where(m, X, big).amin(dim=-2),
        vhi=torch.where(m, X, -big).amax(dim=-2))


def _bank_inputs(Xs, masks, device):
    """(X [S, n, nv], mask [S, n]) on the device; a speaker's valid frames
    form a contiguous prefix."""
    X = torch.as_tensor(Xs, device=device)
    return X, torch.as_tensor(masks, device=X.device).to(torch.bool)


def init_train_state(seed: int, nh: int, Xs, masks,
                     device: torch.device | str = "cuda") -> CrbmTrainState:
    """A bank's fresh state; the init draws from (seed, 0), so it never
    collides with a step's draw (seed, 1 + step)."""
    X, mask = _bank_inputs(Xs, masks, device)
    params = init_params(seed, nh, X, mask)
    vel = _Velocity(*(torch.zeros_like(p) for p in params[:4]))
    return CrbmTrainState(params, vel, 0)


def step_noise(seed: int, step: int, S: int, B: int, nv: int, nh: int,
               cd_k: int, dtype, device):
    """The bank's standard normal noise of global step `step`, from the
    generator of (seed, 1 + step): the order cd_batch takes."""
    g = step_generator(seed, 1 + step, device)
    shapes = [(S, B, nh)] + [(S, B, nv), (S, B, nh)] * cd_k
    return [torch.randn(s, generator=g, dtype=dtype, device=device)
            for s in shapes]


def _select(live: torch.Tensor, new, old):
    """Per speaker: `new` where live [S], else `old`."""
    return type(old)(*(torch.where(live.view(-1, *[1] * (a.dim() - 1)), a, b)
                       for a, b in zip(new, old)))


def fit_bank_segment(Xs, masks, nh: int, cfg: CrbmTrainConfig, seed: int,
                     state: CrbmTrainState | None, n_epochs: int,
                     total_epochs: int,
                     device: torch.device | str = "cuda") -> CrbmTrainState:
    """Advance a bank's training by n_epochs of a total_epochs-epoch run,
    from `state` (a fresh one when None): Xs [S, n, nv], masks [S, n].

    Speaker s with n_s valid frames walks its own frames in e_s =
    ceil(n_s / batch) minibatches an epoch, wrapping around modulo n_s,
    and applies total_epochs * e_s updates; a segment of n_epochs runs
    n_epochs * max_s e_s global steps, each speaker's later steps masked
    out once its budget is spent. With cfg.full_batch each speaker's
    batch is its n_s frames, once an epoch: the bank's rows up to the
    longest speaker's count, each speaker's statistics over its own rows
    (the step's noise is drawn for that many rows). Segments compose
    exactly: running total_epochs in one segment or many gives
    bit-identical parameters."""
    X, mask = _bank_inputs(Xs, masks, device)
    if state is None:
        state = init_train_state(seed, nh, X, mask, X.device)
    S, _, nv = X.shape
    dev, dt = X.device, X.dtype
    n = mask.sum(dim=-1)                                    # [S]
    if cfg.full_batch:
        B = max(int(n.max()), 1)
        valid = mask[:, :B]
        full = torch.where(valid.unsqueeze(-1), X[:, :B], 0.0)
        epoch = torch.ones_like(n)
    else:
        B, valid = max(cfg.batch_size, 1), None
        epoch = torch.clamp_min((n + B - 1) // B, 1)        # [S]
    budget = total_epochs * epoch
    # every speaker updates while the shortest budget lasts (read once)
    all_live = int(budget.min())
    n_steps = n_epochs * int(epoch.max())
    offsets = torch.arange(B, device=dev)
    nmod = torch.clamp_min(n, 1)[:, None]
    params, vel = state.params, state.vel
    for i in range(n_steps):
        gstep = state.step + i
        if cfg.full_batch:
            batch = full
        else:
            idx = (((gstep % epoch) * B)[:, None] + offsets) % nmod
            batch = torch.gather(X, 1, idx.unsqueeze(-1).expand(S, B, nv))
        noise = step_noise(seed, gstep, S, B, nv, nh, cfg.cd_k, dt, dev)
        new_params, new_vel = cd_batch(params, vel, batch, noise, cfg, valid)
        if gstep < all_live:
            params, vel = new_params, new_vel
        else:
            live = gstep < budget
            params = _select(live, new_params, params)
            vel = _select(live, new_vel, vel)
    return CrbmTrainState(params, vel, state.step + n_steps)


def fit_bank(Xs, masks, nh: int, cfg: CrbmTrainConfig, seed: int = 0,
             device: torch.device | str = "cuda") -> CrbmParams:
    """Train S speakers' CRBMs as one bank: Xs [S, n, nv] (the reference
    fans the speakers out over 8 threads, main.cc:500-518)."""
    return fit_bank_segment(Xs, masks, nh, cfg, seed, None, cfg.n_epochs,
                            cfg.n_epochs, device).params


def fit(X, mask, nh: int, cfg: CrbmTrainConfig, seed: int = 0,
        device: torch.device | str = "cuda") -> CrbmParams:
    """Train one CRBM on [n, nv] frames (the valid ones a contiguous
    prefix) for cfg.n_epochs epochs: a bank of one."""
    X = torch.as_tensor(X, device=device)
    mask = torch.as_tensor(mask, device=X.device)
    bank = fit_bank(X[None], mask[None], nh, cfg, seed, X.device)
    return CrbmParams(*(p[0] for p in bank))


def reconstruction_error(params: CrbmParams, X: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Summed squared reconstruction error over the valid frames of one
    utterance [n, nv] (a bank's params give [S]): one noise-free up-down
    pass (crbm.cc:187-200)."""
    V = sample_visible(params, sample_hidden(params, X))
    err = ((X - V) ** 2).sum(dim=-1)
    return (err * mask.to(X.dtype)).sum(dim=-1)


def bank_reconstruction_errors(bank: CrbmParams, X: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """[S] reconstruction errors of one utterance against every speaker."""
    return reconstruction_error(bank, X, mask)


def predict_bank(bank: CrbmParams, labels, X: torch.Tensor,
                 mask: torch.Tensor):
    """argmin reconstruction-error classification
    (src/nn/src/main.cc:453-465)."""
    errs = bank_reconstruction_errors(bank, X, mask)
    return labels[int(torch.argmin(errs))]
