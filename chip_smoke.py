#!/usr/bin/env python3
"""On-card check of speaker_recognition_tpu_torch: builds the CUDA kernels,
holds each against its plain torch version, drives batched predict through
the CLI on the committed fixture session, and times the kernels.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc. Phases (each prints its numbers; any failure
raises and the exit code is non-zero):
  1. device: card name, nvidia-smi name and power limit, kernel build time
  2. frontend kernel vs plain: 512 x 5 s at 8 kHz; a 150 s clip beside a
     short one; 16 kHz and 22.05 kHz batches; 64 mel filters
  3. bank-scoring kernel vs plain: the 4 x 32 bench bank over 512
     utterances; an 80 x 256 bank over 8
  4. the slice: `cli -t predict` on the fixture wavs, scores_batch against
     the JAX package's scores, both kernels' launch counts
  5. timing (CUDA events, median of 7 trials): end-to-end predict_scores at
     the bench geometry, each kernel and its plain version
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from speaker_recognition_tpu_torch import _build, cli  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath  # noqa: E402
from speaker_recognition_tpu_torch.api.interface import (  # noqa: E402
    ModelInterface)
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, MfccConfig, n_frames)
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    PackedFrontend)
from speaker_recognition_tpu_torch.models.gmm import GmmBank  # noqa: E402
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    gpu_frontend, gpu_gmm)
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402

BENCH_B, BENCH_FS, BENCH_SEC = 512, 8000, 5.0
LENGTH_BUCKET = 4096
# Frontend tolerances, kernel vs plain on the same card. Both are f32, but
# the kernel sums the DFT in 32-row tiles and the mel/autocorrelation in
# 64-column chunks where cuBLAS picks its own split: about 1e-6 relative on
# the power spectrum, so 1e-3 absolute on CMVN'd O(1) cepstra leaves a wide
# margin. LPC comes out of a Levinson recursion that amplifies those
# rounding differences by the conditioning of the autocorrelation, hence
# 1e-2 absolute or 1e-3 relative, whichever is looser.
MFCC_ATOL = 1e-3
LPC_ATOL, LPC_RTOL = 1e-2, 1e-3
# Scoring: both sum 2d products per component in f32 in different orders;
# the [B, S] averages agree to ~1e-6 relative, 1e-4 bounds them.
SCORE_RTOL = 1e-4
# Against the JAX package's CPU scores (different frontend arithmetic on
# another device): the fixture's agreement on the CPU is ~3e-5.
SLICE_RTOL = 1e-3


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def padded(n: int) -> int:
    return -(-n // LENGTH_BUCKET) * LENGTH_BUCKET


def signals_batch(rng, lengths, Lp, dev):
    x = np.zeros((len(lengths), Lp), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = (rng.randn(n) * 3000).astype(np.float32)
    return (torch.from_numpy(x).to(dev),
            torch.as_tensor(np.asarray(lengths, np.int64), device=dev))


def frontend_args(fe: PackedFrontend, sig, lengths):
    """The arguments of gpu_frontend.packed_from_signals for one batch."""
    T = n_frames(sig.shape[1], fe.frame_len, fe.frame_shift)
    return (sig, fe.valid_frames(lengths, T), fe.D, fe.W, fe.dct, fe.A,
            fe.floor, fe.frame_shift, fe.cmvn)


def check_frontend(name, fe: PackedFrontend, sig, lengths) -> float:
    """Kernel vs plain on one batch; returns the max abs error."""
    args = frontend_args(fe, sig, lengths)
    n_valid = args[1]
    mask = torch.arange(n_frames(sig.shape[1], fe.frame_len, fe.frame_shift),
                        device=sig.device) < n_valid[:, None]
    got = gpu_frontend.packed_from_signals(*args)
    want = gpu_frontend.packed_from_signals_reference(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite features")
    if (got[~mask] != 0).any():
        raise AssertionError(f"{name}: frames past n_valid are not zero")
    nc = fe.dct.shape[1]
    m = mask[..., None]
    d_mfcc = ((got[..., :nc] - want[..., :nc]).abs() * m).max().item()
    d_lpc = (got[..., nc:] - want[..., nc:]).abs()
    lpc_bad = ((d_lpc > LPC_ATOL) & (d_lpc > LPC_RTOL * want[..., nc:].abs())
               & m).sum().item()
    d_lpc = (d_lpc * m).max().item()
    print(f"phase 2 {name}: shape {tuple(got.shape)} valid frames "
          f"{int(n_valid.sum())} mfcc max|d| {d_mfcc:.3e} (tol {MFCC_ATOL}) "
          f"lpc max|d| {d_lpc:.3e} (over tol: {lpc_bad})", flush=True)
    if d_mfcc > MFCC_ATOL or lpc_bad:
        raise AssertionError(f"{name}: frontend kernel disagrees with plain")
    return max(d_mfcc, d_lpc)


def random_bank(rng, S, K, d, dev, uniform_weights=False):
    w = (np.full((S, K), 1.0 / K) if uniform_weights
         else rng.dirichlet(np.ones(K), size=S))
    return GmmBank.from_numpy(w.astype(np.float32),
                              rng.randn(S, K, d).astype(np.float32),
                              (0.5 + rng.rand(S, K, d)).astype(np.float32),
                              dev)


def check_scoring(name, bank, feats, mask) -> float:
    got = gpu_gmm.batch_bank_avg_loglik(bank, feats, mask)
    want = gpu_gmm.batch_bank_avg_loglik_reference(bank, feats, mask)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite scores")
    d = (got - want).abs()
    rel = (d / want.abs().clamp_min(1e-30)).max().item()
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    print(f"phase 3 {name}: [B, S] {tuple(got.shape)} max|d| "
          f"{d.max().item():.3e} max rel {rel:.3e} (tol {SCORE_RTOL}) "
          f"argmax identical {same}", flush=True)
    if rel > SCORE_RTOL or not same:
        raise AssertionError(f"{name}: scoring kernel disagrees with plain")
    return d.max().item()


def time_ms(fn, trials=7, reps=3) -> float:
    """Median per-call device time of fn() over `trials` event pairs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(args.seed)

    # 1. device and build
    kind = torch.cuda.get_device_name(0)
    card = smi()
    print(f"phase 1 device: {kind}; nvidia-smi: {card}", flush=True)
    _build.load()
    ptxas = []
    with open(_build.build_log) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling" in ln]
    print(f"phase 1 build: {_build.build_seconds:.1f} s "
          f"({os.path.basename(_build.build_log)[:-4]}.so)", flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    # 2. frontend kernel vs plain
    fcfg = FeatureConfig()
    L = int(BENCH_FS * BENCH_SEC)
    fe8 = PackedFrontend(BENCH_FS, fcfg, dev)
    bench_sig, bench_len = signals_batch(rng, [L] * BENCH_B, padded(L), dev)
    err_fe = check_frontend("bench 512 x 5 s @ 8 kHz", fe8, bench_sig,
                            bench_len)
    long_sig, long_len = signals_batch(
        rng, [150 * BENCH_FS, int(1.5 * BENCH_FS)], padded(150 * BENCH_FS), dev)
    err_fe = max(err_fe, check_frontend("150 s clip + 1.5 s clip", fe8,
                                        long_sig, long_len))
    fe16 = PackedFrontend(16000, fcfg, dev)
    lens16 = [int(16000 * s) for s in (3.0, 2.2, 0.9, 0.01)]
    s16, l16 = signals_batch(rng, lens16, padded(max(lens16)), dev)
    err_fe = max(err_fe, check_frontend(
        f"16 kHz (flen {fe16.frame_len}, fshift {fe16.frame_shift})", fe16,
        s16, l16))
    # frame_len 705, shift 352: no 16-byte frame loads, 64-frame tiles
    fe22 = PackedFrontend(22050, fcfg, dev)
    s22, l22 = signals_batch(rng, [22050, 15000], padded(22050), dev)
    err_fe = max(err_fe, check_frontend(
        f"22.05 kHz (flen {fe22.frame_len}, fshift {fe22.frame_shift})", fe22,
        s22, l22))
    # 64 mel + 16 autocorrelation outputs take the kernel's other tiling
    fe64 = PackedFrontend(BENCH_FS, FeatureConfig(mfcc=MfccConfig(
        n_filters=64)), dev)
    err_fe = max(err_fe, check_frontend(
        "8 kHz, 64 mel filters", fe64, bench_sig[:4], bench_len[:4]))

    # 3. bank-scoring kernel vs plain, on real features
    feats, mask = fe8(bench_sig, bench_len)
    d = fcfg.dim
    bench_bank = random_bank(rng, 4, 32, d, dev, uniform_weights=True)
    err_gmm = check_scoring("bench bank 4 x 32, B=512", bench_bank, feats, mask)
    ubm_bank = random_bank(rng, 80, 256, d, dev)
    err_gmm = max(err_gmm, check_scoring(
        "UBM-scale bank 80 x 256, B=8", ubm_bank, feats[:8].contiguous(),
        mask[:8].contiguous()))

    # 4. the slice through the entry points, on the fixture session
    exp = synth.expected()
    utts = synth.fixture_utterances(exp)
    import scipy.io.wavfile as wavfile
    with tempfile.TemporaryDirectory() as tmp:
        for i, (u, sig) in enumerate(zip(exp["utterances"], utts)):
            wavfile.write(os.path.join(tmp, f"{i:02d}_{u['label']}.wav"),
                          exp["fs"], sig)
        gpu_frontend.LAUNCHES = 0
        gpu_gmm.LAUNCHES = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["-t", "predict", "-i", os.path.join(tmp, "*.wav"),
                      "-m", synth.SESSION, "--device", "cuda"])
        m = ModelInterface.load(synth.SESSION, device=dev)
        scores, valid = m.scores_batch(exp["fs"], utts)
        launches = {"frontend": gpu_frontend.LAUNCHES,
                    "gmm": gpu_gmm.LAUNCHES}
    lines = buf.getvalue().strip().splitlines()
    labels = [ln.rpartition(" -> ")[2] for ln in lines]
    truth = [u["label"] for u in exp["utterances"]]
    want = np.asarray(exp["scores"])
    rel = float(np.max(np.abs(scores - want) / np.abs(want)))
    print(f"phase 4 slice: cli predicted {labels}", flush=True)
    print(f"phase 4 slice: scores {scores.shape} vs JAX max rel {rel:.3e} "
          f"(tol {SLICE_RTOL}); launches {launches}", flush=True)
    if labels != truth:
        raise AssertionError(f"cli labels {labels} != truth {truth}")
    if scores.shape != want.shape or not valid.all() \
            or not np.isfinite(scores).all() or rel > SLICE_RTOL:
        raise AssertionError("slice scores disagree with the JAX package")
    if launches["frontend"] < 1 or launches["gmm"] < 1:
        raise AssertionError(f"the slice missed a kernel: {launches}")

    # 5. timing (informational)
    fe_args = frontend_args(fe8, bench_sig, bench_len)
    t = {
        "predict": time_ms(lambda: fastpath.predict_scores(
            bench_sig, bench_len, bench_bank, BENCH_FS, fcfg)),
        "frontend": time_ms(lambda: gpu_frontend.packed_from_signals(*fe_args)),
        "frontend_plain": time_ms(
            lambda: gpu_frontend.packed_from_signals_reference(*fe_args)),
        "gmm": time_ms(lambda: gpu_gmm.batch_bank_avg_loglik(
            bench_bank, feats, mask)),
        "gmm_plain": time_ms(lambda: gpu_gmm.batch_bank_avg_loglik_reference(
            bench_bank, feats, mask)),
    }
    f8, m8 = feats[:8].contiguous(), mask[:8].contiguous()
    t["gmm_ubm"] = time_ms(lambda: gpu_gmm.batch_bank_avg_loglik(
        ubm_bank, f8, m8))
    t["gmm_ubm_plain"] = time_ms(
        lambda: gpu_gmm.batch_bank_avg_loglik_reference(ubm_bank, f8, m8))
    rate = BENCH_B * BENCH_SEC / (t["predict"] / 1e3)
    print(f"phase 5 [{card}] predict_scores 512 x 5 s, 4 x 32 bank: "
          f"{t['predict']:.3f} ms = {rate:.0f} audio-s/s", flush=True)
    for k in ("frontend", "gmm"):
        print(f"phase 5 [{card}] {k} kernel {t[k]:.3f} ms, plain "
              f"{t[k + '_plain']:.3f} ms (bench geometry)")
    print(f"phase 5 [{card}] gmm kernel 80 x 256 bank, B=8: "
          f"{t['gmm_ubm']:.3f} ms, plain {t['gmm_ubm_plain']:.3f} ms")

    print(card)
    print(json.dumps({"kernels": [
        {"name": "packed_frontend", "route": "cuda",
         "source": "speaker_recognition_tpu_torch/csrc/frontend.cu",
         "replaces": "speaker_recognition_tpu/ops/pallas_frontend.py:231",
         "launches": launches["frontend"], "max_abs_err": err_fe,
         "ms": t["frontend"], "plain_ms": t["frontend_plain"]},
        {"name": "bank_avg_loglik", "route": "cuda",
         "source": "speaker_recognition_tpu_torch/csrc/gmm_score.cu",
         "replaces": "speaker_recognition_tpu/ops/pallas_gmm.py:154",
         "launches": launches["gmm"], "max_abs_err": err_gmm,
         "ms": t["gmm"], "plain_ms": t["gmm_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
