"""Where a scoring wrapper's host time goes, on the card.

    python -m speaker_recognition_tpu_torch.tools.score_ablation

Times, on the host clock (time.perf_counter over many calls, nothing
waiting on the device), the serial wrapper ops/gpu_gmm.bank_avg_loglik (K3,
csrc/gmm_serial.cu) on one 5 s utterance at 8 kHz (311 valid frames of
512, d = 28) against a 5 x 32 bank (4 speakers + UBM), and the batched
wrapper batch_bank_avg_loglik (K2, csrc/gmm_score.cu) on 512 such
utterances against a 4 x 32 bank, and beside each the steps a call is
made of: the checks, the plan, the allocations, the stream, the ctypes
call with its buffers allocated once (the floor), and the steps the
earlier wrapper took on every call (tensor checks, library lookup,
torch.cuda.device, a torch.cuda.Stream object). Each wrapper's result is
held to its plain version first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from .. import _build
from ..models.gmm import GmmBank
from ..ops import gpu_gmm

CALLS = 2000


def host_us(fn, calls=CALLS) -> float:
    """Median over 5 rounds of the host microseconds a call of fn takes."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(rounds))


def random_bank(rng, S, K, d, dev) -> GmmBank:
    return GmmBank.from_numpy(
        rng.dirichlet(np.ones(K), size=S).astype(np.float32),
        rng.randn(S, K, d).astype(np.float32),
        (0.5 + rng.rand(S, K, d)).astype(np.float32), dev)


def steps(name, bank, x, m, wrapper, reference, raw, calls=CALLS):
    """Print wrapper's host time and its steps'; raw() is the ctypes call
    alone. `calls` a round stays below what the launch queue holds, so the
    host never waits for the device."""
    dev = x.device
    rel = ((wrapper(bank, x, m) - reference(bank, x, m)).abs()
           / reference(bank, x, m).abs()).max().item()
    if not rel < 1e-4:
        raise SystemExit(f"{name}: the wrapper disagrees with plain ({rel})")
    plan = bank.scoring_plan(gpu_gmm._make_plan)
    S = plan.S
    parts = {
        "wrapper call": lambda: wrapper(bank, x, m),
        "ctypes call alone (buffers allocated once)": raw,
        "plan lookup (GmmBank.scoring_plan)":
            lambda: bank.scoring_plan(gpu_gmm._make_plan),
        "dtype, shape and device checks of x and mask": lambda: (
            gpu_gmm._check_dtype(x, "x", torch.float32, x.dim()),
            gpu_gmm._check_dtype(m, "mask", torch.bool, m.dim()),
            gpu_gmm._on_plan_device(x, "x", plan),
            gpu_gmm._on_plan_device(m, "mask", plan)),
        "one torch.empty": lambda: torch.empty(
            S, dtype=torch.float32, device=plan.device),
        "current stream (gpu_gmm._stream, the raw cudaStream_t)":
            lambda: gpu_gmm._stream(plan),
        "data_ptr of x and mask": lambda: (x.data_ptr(), m.data_ptr()),
        # what the earlier wrapper did besides, on every call
        "earlier: four _build.check_tensor": lambda: (
            _build.check_tensor(x, "x", torch.float32, x.dim(), dev),
            _build.check_tensor(m, "mask", torch.bool, m.dim(), dev),
            _build.check_tensor(bank.op, "op", torch.float32, 2, dev),
            _build.check_tensor(bank.cw, "cw", torch.float32, 1, dev)),
        "earlier: _build.load() under its lock": _build.load,
        "earlier: component_operator": lambda: bank.component_operator(
            plan.comp.shape[-1]),
        "earlier: with torch.cuda.device(dev)": lambda: _enter(dev),
        "earlier: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    for k, fn in parts.items():
        print(f"score_ablation {name}: {k}: {host_us(fn, calls):.2f} us",
              flush=True)


def _enter(dev):
    with torch.cuda.device(dev):
        pass


def main():
    if not torch.cuda.is_available():
        raise SystemExit("score_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"score_ablation [{card}]: host microseconds a call, median of 5 "
          "rounds", flush=True)
    rng = np.random.RandomState(0)
    lib = _build.load()
    valid, T = 311, 512

    serial_bank = random_bank(rng, 5, 32, 28, dev)
    x = torch.from_numpy(rng.randn(T, 28).astype(np.float32)).to(dev)
    xm = torch.zeros(T, dtype=torch.bool, device=dev)
    xm[:valid] = True
    plan = serial_bank.scoring_plan(gpu_gmm._make_plan)
    out = torch.empty(5, device=dev)
    stream = gpu_gmm._stream(plan)

    def raw_serial():
        return lib.srt_bank_sum_loglik(
            x.data_ptr(), xm.data_ptr(), plan.comp_ptr, out.data_ptr(), T,
            28, 5, 32, 1, 0, stream)
    steps("K3 5 x 32, 311 of 512 frames", serial_bank, x, xm,
          gpu_gmm.bank_avg_loglik, gpu_gmm.bank_avg_loglik_reference,
          raw_serial)

    bank = random_bank(rng, 4, 32, 28, dev)
    feats = torch.from_numpy(rng.randn(512, T, 28).astype(np.float32)).to(dev)
    mask = torch.zeros(512, T, dtype=torch.bool, device=dev)
    mask[:, :valid] = True
    plan2 = bank.scoring_plan(gpu_gmm._make_plan)
    nw = -(-T // plan2.warp_frames)
    buf = torch.empty(512 * 4 + 512 * nw * 5, device=dev)

    def raw_batch():
        return lib.srt_bank_avg_loglik(
            feats.data_ptr(), mask.data_ptr(), plan2.batch_ptr,
            buf.data_ptr() + 4 * 512 * 4, buf.data_ptr(), 512, T, 28, 4, 32,
            0, stream)
    # ~0.1 ms of device time a call: 100 calls (200 launches) a round
    steps("K2 512 x 311, 4 x 32", bank, feats, mask,
          gpu_gmm.batch_bank_avg_loglik,
          gpu_gmm.batch_bank_avg_loglik_reference, raw_batch, calls=100)


if __name__ == "__main__":
    main()
