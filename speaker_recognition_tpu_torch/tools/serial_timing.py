"""Device and host time of the serial bank score (K3) on the card.

    python -m speaker_recognition_tpu_torch.tools.serial_timing [--label L]

Times ops/gpu_gmm.bank_avg_loglik, one serial decision's scoring, at the
serial path's shapes (features padded to GMMSet's 256-frame bucket, d = 28,
random banks and features from seed 0): the bench bank + UBM (5 x 32) on a
5 s utterance at 8 kHz (311 valid frames of 512), an 80 x 256 bank + UBM
on 3 s (186 of 256) and the bench bank + UBM on a 150 s clip (9,374 of
9,472). For each: torch.profiler's device microseconds per launch of each
kernel a call runs, the host's microseconds per call when nothing waits on
the device, and CUDA-event milliseconds per call, after holding the result
to the plain version (1e-4 relative). It uses only GmmBank.from_numpy,
bank_avg_loglik and its plain version, so it runs unchanged in a checkout
of an earlier commit of this package (copy it into that checkout's tools/):
run it there and here in one call to compare two versions on one card.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..models.gmm import GmmBank
from ..ops import gpu_gmm

SHAPES = (  # name, speakers, components, rows, valid rows
    ("bench bank + UBM 5 x 32, 5 s", 5, 32, 512, 311),
    ("80 x 256 bank + UBM, 3 s", 81, 256, 256, 186),
    ("bench bank + UBM 5 x 32, 150 s", 5, 32, 9472, 9374),
)
D = 28


def profile_us(fn, calls=50):
    """({kernel: device us per launch}, launches a call) by torch.profiler
    over `calls` calls after a warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    found = {}

    def ready(prof):
        for ev in prof.key_averages():
            if (ev.device_type == DeviceType.CUDA and ev.count
                    and not ev.key.startswith("ProfilerStep")):
                name = ev.key.replace("(anonymous namespace)::", "").split(
                    "<")[0].split("(")[0].split()[-1]
                found[name] = (ev.device_time_total / ev.count,
                               ev.count / calls)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return found


def host_us(fn, calls=300) -> float:
    """Median over 5 rounds of the host microseconds a call takes."""
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(rounds))


def event_ms(fn, reps=200) -> float:
    """Median over 7 trials of the CUDA-event milliseconds per call."""
    times = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serial_timing needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.RandomState(0)
    for name, S, K, n, valid in SHAPES:
        bank = GmmBank.from_numpy(
            rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, D).astype(np.float32),
            (0.5 + rng.rand(S, K, D)).astype(np.float32), dev)
        x = torch.from_numpy(rng.randn(n, D).astype(np.float32)).to(dev)
        m = torch.arange(n, device=dev) < valid
        fn = lambda: gpu_gmm.bank_avg_loglik(bank, x, m)  # noqa: E731
        want = gpu_gmm.bank_avg_loglik_reference(bank, x, m)
        rel = ((fn() - want).abs() / want.abs()).max().item()
        if not rel < 1e-4:
            raise SystemExit(f"{name}: the kernel disagrees with its plain "
                             f"version (max rel {rel:.3e})")
        kernels = profile_us(fn)
        device = ", ".join(f"{k} {us:.2f} us x {per:g}"
                           for k, (us, per) in kernels.items())
        print(f"serial_timing [{card}] {args.label}: {name}: device "
              f"{device or 'not measured'}; in all "
              f"{sum(us * per for us, per in kernels.values()):.2f} us a "
              f"call; host {host_us(fn):.2f} us a call; events "
              f"{event_ms(fn):.4f} ms a call", flush=True)


if __name__ == "__main__":
    main()
