"""Speaker-bank scoring: CUDA kernels and their plain torch versions.

Batched: `batch_bank_avg_loglik` launches csrc/gmm_score.cu and maps
[B, T, d] features and a [B, T] mask to [B, S] masked per-frame average
log-likelihoods. Serial: `bank_sum_loglik` / `bank_avg_loglik` launch
csrc/gmm_serial.cu (one clustered launch) and map one utterance [n, d]
with mask [n] to [S] sums or averages. All apply the reference's -745 ->
log(1e-15) underflow floor. Each runs its kernel on a CUDA tensor and its
plain version (`*_reference`, from models/gmm) on a CPU tensor; any other
device raises.

Both kernels are bound by FP32 operations (2*d FMAs per frame and
component) and share one inner loop (csrc/gmm_lse.cuh): a lane keeps its
frames in registers, the bank's components arrive as 16-byte rows
(`GmmBank.component_operator`, packed once per bank) that stream through
shared memory in chunks, and the logsumexp runs online across chunks. So
neither the feature dimension nor the number of components has a cap:
past a padded d of 128 the frame stays in device memory (a route chosen
on the shape, no fallback). Neither the batch nor the bank has a cap
either: past the grid's 65535 utterances (batched) or speakers (serial) a
call launches once per 65535. Every sum runs in a fixed order with no
atomics: two calls give the same bits.

`precision="bf16"` (the JAX kernels' argument, ops/pallas_gmm.py:100,
:211; `bank_avg_loglik` has none, as in the JAX package) rounds the
matmul's operands to bf16 and accumulates in f32, x^2 rounded as each JAX
kernel rounds it (models/gmm). On the card it launches the tensor-core
kernels csrc/gmm_score_bf16.cu and csrc/gmm_serial_bf16.cu (mma.sync on
bf16 fragments, csrc/gmm_mma.cuh), counted in BF16_LAUNCHES and
SERIAL_BF16_LAUNCHES, which read the bank as `GmmBank.mma_operator` rows;
the plain versions take the same argument.

A serial decision is microseconds of device work, so the wrappers keep
their host path short: what a call needs of the bank (the rows, their
pointer, the device, the launch shape for d, the library) is a `_Plan`
made once per bank (`GmmBank.scoring_plan`, rebuilt when the bank's
parameters change); a call checks the inputs that guard the raw pointers,
allocates its output (and the batched kernel's scratch) in one tensor and
makes one ctypes call, which selects the device itself.

`batch_scores`, the serving path's call, runs in the `srt.score` span
(utils/profiling.span) and counts what it scores on every route:
SCORED_CALLS calls and SCORED_FRAMES frames, B * T a call for [B, T, d]
features (the frames the kernel's grid covers, padding included), from
the shapes alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..models.gmm import PRECISIONS, GmmBank
from ..models.gmm import (
    bank_sum_loglik as bank_sum_loglik_reference,
    bank_avg_loglik as bank_avg_loglik_reference,
    batch_bank_avg_loglik as batch_bank_avg_loglik_reference)
from ..utils.profiling import span

# kernel launches since the last reset, batched (gmm_score.cu) and serial
# (gmm_serial.cu); the CPU path does not count
LAUNCHES = 0
SERIAL_LAUNCHES = 0
# the same, precision="bf16" (gmm_score_bf16.cu, gmm_serial_bf16.cu)
BF16_LAUNCHES = 0
SERIAL_BF16_LAUNCHES = 0
# calls of batch_scores / serial_scores at float64: the plain versions, on
# the CPU or the card
F64_CALLS = 0
# batch_scores calls and the frames they scored (B * T a call), every route
SCORED_CALLS = 0
SCORED_FRAMES = 0

__all__ = ["BF16_LAUNCHES", "F64_CALLS", "LAUNCHES", "SCORED_CALLS",
           "SCORED_FRAMES", "SERIAL_BF16_LAUNCHES", "SERIAL_LAUNCHES",
           "bank_avg_loglik", "bank_avg_loglik_reference", "bank_sum_loglik",
           "bank_sum_loglik_reference", "batch_bank_avg_loglik",
           "batch_bank_avg_loglik_reference", "batch_scores",
           "serial_scores"]


class _Plan(NamedTuple):
    """What both scoring wrappers keep of a bank on the card, at one
    precision."""

    lib: object             # the kernels' ctypes library
    comp: torch.Tensor      # the component rows (keeps comp_ptr valid):
    comp_ptr: int           # [S, K, row] f32, or [S, kp, row] bf16
    device: torch.device
    index: int              # the device's ordinal
    S: int
    K: int
    d: int
    warp_frames: int        # frames a batched warp tile takes at this d


def _make_plan(bank: GmmBank, precision: str = "f32") -> _Plan:
    dev = bank.op.device
    if dev.type != "cuda":
        raise ValueError(f"the bank is on {dev}, the features on the card")
    _build.check_tensor(bank.op, "bank.op", torch.float32, 2, dev)
    _build.check_tensor(bank.cw, "bank.cw", torch.float32, 1, dev)
    lib = _build.load()
    d = bank.dim
    if precision == "bf16":
        comp = bank.mma_operator(lib.srt_mma_row(d),
                                 lib.srt_mma_components(bank.n_mixtures))
        warp_frames = lib.srt_bank_bf16_warp_frames()
    else:
        comp = bank.component_operator(lib.srt_component_row(d))
        warp_frames = lib.srt_bank_warp_frames(d)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _Plan(lib, comp, comp.data_ptr(), torch.device("cuda", index),
                 index, bank.n_speakers, bank.n_mixtures, d, warp_frames)


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")


def _on_plan_device(t: torch.Tensor, name: str, plan: _Plan):
    """Raise unless t is contiguous on the plan's device (its dtype and
    shape are checked before the plan is made)."""
    if not t.is_contiguous() or t.get_device() != plan.index:
        _build.check_tensor(t, name, t.dtype, t.dim(), plan.device)


def _check_dtype(t: torch.Tensor, name: str, dtype, ndim: int):
    if t.dtype is not dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")


def _stream(plan: _Plan) -> int:
    """The device's current stream as the kernels take it: the raw
    cudaStream_t, which the code torch.compile generates reads the same
    way (a torch.cuda.Stream object costs ~4 us of host a call,
    tools/score_ablation.py)."""
    return torch._C._cuda_getCurrentRawStream(plan.index)


def batch_bank_avg_loglik(bank: GmmBank, feats: torch.Tensor,
                          mask: torch.Tensor,
                          precision: str = "f32") -> torch.Tensor:
    """[B, T, d] f32 features, [B, T] bool mask -> [B, S] f32, the
    matmul's operands at `precision`."""
    _check_precision(precision)
    if feats.device.type == "cpu":
        return batch_bank_avg_loglik_reference(bank, feats, mask,
                                               precision=precision)
    if feats.device.type != "cuda":
        raise ValueError(f"no bank scoring for device {feats.device}")
    _check_dtype(feats, "feats", torch.float32, 3)
    _check_dtype(mask, "mask", torch.bool, 2)
    B, T, d = feats.shape
    if tuple(mask.shape) != (B, T):
        raise ValueError(f"mask {tuple(mask.shape)} must be [{B}, {T}]")
    bf16 = precision == "bf16"
    plan = bank.scoring_plan(_make_plan, precision)
    if plan.d != d:
        raise ValueError(f"bank dim {plan.d} must be {d}")
    _on_plan_device(feats, "feats", plan)
    _on_plan_device(mask, "mask", plan)
    S = plan.S
    # out [B, S], then the kernel's scratch: partial sums [B][NW][S] and
    # valid-frame counts [B][NW]
    nw = max(1, -(-T // plan.warp_frames))
    buf = torch.empty(B * S + B * nw * (S + 1), dtype=torch.float32,
                      device=plan.device)
    out = buf[:B * S].view(B, S)
    if B == 0:
        return out
    ptr = buf.data_ptr()
    launch = (plan.lib.srt_bank_avg_loglik_bf16 if bf16
              else plan.lib.srt_bank_avg_loglik)
    err = launch(feats.data_ptr(), mask.data_ptr(), plan.comp_ptr,
                 ptr + 4 * B * S, ptr, B, T, d, S, plan.K, plan.index,
                 _stream(plan))
    _build.check(err, "bank scoring kernel")
    global LAUNCHES, BF16_LAUNCHES
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def _serial(bank: GmmBank, X: torch.Tensor, mask: torch.Tensor,
            avg: bool, precision: str = "f32") -> torch.Tensor:
    """Launch csrc/gmm_serial.cu (gmm_serial_bf16.cu at bf16) on one
    utterance: [S] sums or averages."""
    _check_dtype(X, "X", torch.float32, 2)
    _check_dtype(mask, "mask", torch.bool, 1)
    n, d = X.shape
    if mask.shape[0] != n:
        raise ValueError(f"mask {tuple(mask.shape)} must be [{n}]")
    bf16 = precision == "bf16"
    plan = bank.scoring_plan(_make_plan, precision)
    if plan.d != d:
        raise ValueError(f"bank dim {plan.d} must be {d}")
    _on_plan_device(X, "X", plan)
    _on_plan_device(mask, "mask", plan)
    out = torch.empty(plan.S, dtype=torch.float32, device=plan.device)
    launch = (plan.lib.srt_bank_sum_loglik_bf16 if bf16
              else plan.lib.srt_bank_sum_loglik)
    err = launch(X.data_ptr(), mask.data_ptr(), plan.comp_ptr,
                 out.data_ptr(), n, d, plan.S, plan.K, int(avg), plan.index,
                 _stream(plan))
    _build.check(err, "serial bank scoring kernel")
    global SERIAL_LAUNCHES, SERIAL_BF16_LAUNCHES
    if bf16:
        SERIAL_BF16_LAUNCHES += 1
    else:
        SERIAL_LAUNCHES += 1
    return out


def bank_sum_loglik(bank: GmmBank, X: torch.Tensor, mask: torch.Tensor,
                    precision: str = "f32") -> torch.Tensor:
    """[n, d] f32 utterance, [n] bool mask -> [S] f32 sums of per-frame
    log-likelihoods over the valid frames, the matmul's operands at
    `precision`."""
    _check_precision(precision)
    if X.device.type == "cpu":
        return bank_sum_loglik_reference(bank, X, mask, precision=precision)
    if X.device.type != "cuda":
        raise ValueError(f"no bank scoring for device {X.device}")
    return _serial(bank, X, mask, avg=False, precision=precision)


def bank_avg_loglik(bank: GmmBank, X: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """[n, d] f32 utterance, [n] bool mask -> [S] f32 per-frame averages,
    sums / max(valid frames, 1): what GMMSet ranks speakers by."""
    if X.device.type == "cpu":
        return bank_avg_loglik_reference(bank, X, mask)
    if X.device.type != "cuda":
        raise ValueError(f"no bank scoring for device {X.device}")
    return _serial(bank, X, mask, avg=True)


def _f64(x: torch.Tensor) -> bool:
    """Whether a call takes the float64 route (and count it). The kernels
    are float32 only, as the JAX package's (its _use_pallas is False for
    f64): float64 runs the plain versions on whatever device the caller
    names, a dtype route chosen in the open."""
    if x.dtype != torch.float64:
        return False
    global F64_CALLS
    F64_CALLS += 1
    return True


def batch_scores(bank: GmmBank, feats: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """[B, S] scores on the route of the features' dtype: the batched
    kernel's wrapper at float32, the plain version at float64; counted in
    SCORED_CALLS and SCORED_FRAMES."""
    global SCORED_CALLS, SCORED_FRAMES
    with span("srt.score"):
        SCORED_CALLS += 1
        SCORED_FRAMES += feats.shape[0] * feats.shape[1]
        if _f64(feats):
            return batch_bank_avg_loglik_reference(bank, feats, mask)
        return batch_bank_avg_loglik(bank, feats, mask)


def serial_scores(bank: GmmBank, X: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """[S] per-frame averages of one utterance on the route of its dtype:
    the serial kernel's wrapper at float32, the plain version at float64."""
    if _f64(X):
        return bank_avg_loglik_reference(bank, X, mask)
    return bank_avg_loglik(bank, X, mask)
