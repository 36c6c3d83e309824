#!/usr/bin/env python3
"""On-card check of speaker_recognition_tpu_torch: builds the CUDA kernels,
holds each against its plain torch version, drives batched predict, then
enrollment and open-set serial scoring through the entry points, and times
the kernels and the paths.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc. Phases (each prints its numbers; any failure
raises and the exit code is non-zero):
  1. device: card name, nvidia-smi name and power limit, kernel build time
  2. frontend kernel vs plain: 512 x 5 s at 8 kHz; a 150 s clip beside a
     short one; 16 kHz and 22.05 kHz batches; 64 mel filters
  3. bank-scoring kernel vs plain: the 4 x 32 bench bank over 512
     utterances; an 80 x 256 bank over 8
  4. slice 1: `cli -t predict` on the fixture wavs, scores_batch against
     the JAX package's scores, both kernels' launch counts
  5. timing (CUDA events, median of 7 trials): end-to-end predict_scores at
     the bench geometry, each kernel and its plain version
  6. serial kernel vs plain: the bench bank + UBM on one 5 s utterance, an
     80 x 256 bank + UBM on 3 s, a 150 s clip, the underflow floor, no
     valid frame, one speaker
  7. slice 2: `cli -t enroll` then `cli -t predict` on CUDA at the default
     config; the same EM from one init on CUDA f32 against CPU f64
  8. the open set: train_ubm, adapt_speakers, calibrate_rejection and
     predict_one_with_rejection on CUDA; launch counts of phases 7-8
  9. timing: the serial kernel and its plain version, predict_with_rejection
     of one 5 s utterance, ModelInterface.train of three speakers
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
import scipy.io.wavfile as wavfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from speaker_recognition_tpu_torch import _build, cli  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath  # noqa: E402
from speaker_recognition_tpu_torch.api.interface import (  # noqa: E402
    ModelInterface)
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, GmmConfig, MfccConfig, n_frames)
from speaker_recognition_tpu_torch.features import extract  # noqa: E402
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    PackedFrontend)
from speaker_recognition_tpu_torch.models import gmm  # noqa: E402
from speaker_recognition_tpu_torch.models.gmm import GmmBank  # noqa: E402
from speaker_recognition_tpu_torch.models.gmmset import (  # noqa: E402
    GMMSet, _pad_frames_bucket, _pad_stack)
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    gpu_frontend, gpu_gmm)
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.tools import ubm as ubm_tools  # noqa: E402

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
# Serial kernel vs plain: per-frame sums of the same products in another
# order, then a sum over frames in chunks; ~4e-7 relative measured.
SERIAL_RTOL = 1e-4
# 20 EM iterations of GMM-32 in f32 on the card against f64 on the CPU
# from one init: f32 vs f64 on the CPU drifts by up to 8e-5 absolute on
# means and sigmas (O(1)) and 1.2e-6 on weights; 1e-3 leaves 12x margin.
EM_ATOL = 1e-3
UBM_ITERATIONS = 100


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


def check_serial(name, bank, x, mask, floor=False):
    """Serial kernel vs plain on one utterance, averages and sums, with a
    bit-equal rerun; returns the max abs error of the averages."""
    before = gpu_gmm.SERIAL_LAUNCHES
    got = gpu_gmm.bank_avg_loglik(bank, x, mask)
    want = gpu_gmm.bank_avg_loglik_reference(bank, x, mask)
    sums = gpu_gmm.bank_sum_loglik(bank, x, mask)
    want_sums = gpu_gmm.bank_sum_loglik_reference(bank, x, mask)
    again = gpu_gmm.bank_avg_loglik(bank, x, mask)
    torch.cuda.synchronize()
    launched = gpu_gmm.SERIAL_LAUNCHES - before
    d = (got - want).abs()
    rel = (d / want.abs().clamp_min(1e-30)).max().item()
    rel_sum = ((sums - want_sums).abs()
               / want_sums.abs().clamp_min(1e-30)).max().item()
    # the floor makes every speaker tie; elsewhere the winner must agree
    ties = want.unique().numel() < want.numel()
    same = ties or int(got.argmax()) == int(want.argmax())
    print(f"phase 6 {name}: S {bank.n_speakers} K {bank.n_mixtures} frames "
          f"{int(mask.sum())}/{mask.numel()} max|d| {d.max().item():.3e} "
          f"max rel {rel:.3e} (sums {rel_sum:.3e}; tol {SERIAL_RTOL}) "
          f"argmax identical {same} rerun bit-equal "
          f"{torch.equal(got, again)} launches {launched}", flush=True)
    if (not torch.isfinite(got).all() or rel > SERIAL_RTOL
            or rel_sum > SERIAL_RTOL or not same or launched != 3
            or not torch.equal(got, again)):
        raise AssertionError(f"{name}: serial kernel disagrees with plain")
    if floor and not torch.allclose(
            want, torch.full_like(want, np.log(1e-15)), rtol=1e-5):
        raise AssertionError(f"{name}: the underflow floor was not hit")
    if not int(mask.sum()) and (got != 0).any():
        raise AssertionError(f"{name}: no valid frame must score 0")
    return d.max().item()


def utterance(feats, n_valid, dev):
    """The first n_valid frames of [T, d] features, bucketed as
    GMMSet._scores pads them: ([Tp, d], [Tp] mask) on dev."""
    x, m = _pad_frames_bucket(feats[:n_valid].cpu().numpy())
    return torch.from_numpy(x).to(dev), torch.from_numpy(m).to(dev)


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

    # 6. serial kernel vs plain, at the serial path's shapes
    err_serial = 0.0
    serial_banks = {"bench": random_bank(rng, 5, 32, d, dev,
                                         uniform_weights=True),
                    "ubm": random_bank(rng, 81, 256, d, dev)}
    x5, m5 = utterance(feats[0], int(mask[0].sum()), dev)  # 311 of 512
    s3, l3 = signals_batch(rng, [3 * BENCH_FS], padded(3 * BENCH_FS), dev)
    f3, k3 = fe8(s3, l3)
    x3, m3 = utterance(f3[0], int(k3[0].sum()), dev)
    lf, lm = fe8(long_sig, long_len)
    x150, m150 = utterance(lf[0], int(lm[0].sum()), dev)
    for name, bank, x, m, fl in (
            ("bench bank 4 x 32 + UBM, 5 s", serial_banks["bench"], x5, m5,
             False),
            ("80 x 256 bank + UBM, 3 s", serial_banks["ubm"], x3, m3, False),
            ("bench bank + UBM, 150 s clip", serial_banks["bench"], x150,
             m150, False),
            ("underflow floor (features x 300)", serial_banks["bench"],
             x5 * 300.0, m5, True),
            ("no valid frame", serial_banks["bench"], x5,
             torch.zeros_like(m5), False),
            ("one speaker", random_bank(rng, 1, 32, d, dev), x5, m5, False)):
        err_serial = max(err_serial, check_serial(name, bank, x, m, fl))

    # 7. slice 2: enroll then predict through the CLI on the card
    train_sigs = {label: [synth.synth_utterance(label, sec, base + i)
                          for sec, base in synth.TRAIN]
                  for i, label in enumerate(synth.SPEAKER_FREQS)}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = synth.write_training_wavs(tmp)
        test_dir = os.path.join(tmp, "test")
        os.makedirs(test_dir)
        for i, (u, sig) in enumerate(zip(exp["utterances"], utts)):
            wavfile.write(os.path.join(test_dir, f"{i:02d}_{u['label']}.wav"),
                          exp["fs"], sig)
        model = os.path.join(tmp, "enrolled.out")
        gpu_frontend.LAUNCHES = 0
        gpu_gmm.LAUNCHES = 0
        gpu_gmm.SERIAL_LAUNCHES = 0
        enroll_out, predict_out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(enroll_out):
            cli.main(["-t", "enroll", "-i", " ".join(dirs), "-m", model,
                      "--device", "cuda"])
        with contextlib.redirect_stdout(predict_out):
            cli.main(["-t", "predict", "-i", os.path.join(test_dir, "*.wav"),
                      "-m", model, "--device", "cuda"])
        enrolled = ModelInterface.load(model, device=dev)
    labels2 = [ln.rpartition(" -> ")[2]
               for ln in predict_out.getvalue().strip().splitlines()]
    print(f"phase 7 enroll: {enroll_out.getvalue().count('File ')} wavs, "
          f"speakers {enrolled.gmmset.y}, bank "
          f"{tuple(enrolled.gmmset.params.means.shape)}", flush=True)
    print(f"phase 7 cli predicted {labels2}", flush=True)
    if labels2 != truth or enrolled.gmmset.y != list(synth.SPEAKER_FREQS):
        raise AssertionError(f"enrolled cli labels {labels2} != {truth}")
    # the same EM from one init: CUDA float32 against CPU float64
    train_feats = {label: [extract.mix_feature(synth.FS, sig, device=dev)
                           for sig in sigs]
                   for label, sigs in train_sigs.items()}
    Xs, ms = _pad_stack([np.concatenate(f) for f in train_feats.values()])
    X64, mk = torch.from_numpy(Xs), torch.from_numpy(ms)
    em_cfg = GmmConfig(n_iterations=20, threshold=0.0)
    p0 = gmm.init_params(X64, mk, em_cfg.n_mixtures, seed=0)
    want_p, want_ll = gmm.fit_from_params(X64, mk, p0, em_cfg)
    got_p, got_ll = gmm.fit_from_params(
        X64.to(dev, torch.float32), mk.to(dev),
        gmm.params_to(p0, torch.float32, dev), em_cfg)
    em_err = {f: float((g.double().cpu() - w).abs().max())
              for f, g, w in zip(gmm.GmmParams._fields, got_p, want_p)}
    ll_rel = float(((got_ll.double().cpu() - want_ll) / want_ll).abs().max())
    print(f"phase 7 EM 20 iterations, GMM-32 x 3 speakers, CUDA f32 vs CPU "
          f"f64: max|d| {em_err} (tol {EM_ATOL}); log-likelihood max rel "
          f"{ll_rel:.3e}", flush=True)
    if max(em_err.values()) > EM_ATOL or ll_rel > 1e-4:
        raise AssertionError("CUDA EM disagrees with the CPU float64 EM")

    # 8. the open set on the card
    ubm = ubm_tools.train_ubm(
        [f for fl in train_feats.values() for f in fl], n_mixtures=32,
        n_iterations=UBM_ITERATIONS, device=dev)
    enrolled_labels, adapted = ubm_tools.adapt_speakers(
        ubm, {label: np.concatenate(train_feats[label])
              for label in ("alice", "bob")}, device=dev)
    gs = GMMSet.from_state(
        {"labels": enrolled_labels, "weights": adapted.weights,
         "means": adapted.means, "sigmas": adapted.sigmas,
         "reject_threshold": 10.0, "ubm_weights": ubm.weights,
         "ubm_means": ubm.means, "ubm_sigmas": ubm.sigmas}, device=dev)
    feature = lambda label, sec, seed: extract.mix_feature(  # noqa: E731
        synth.FS, synth.synth_utterance(label, sec, seed), device=dev)
    dev_genuine = [feature(label, 2.0, 950 + j) for j, label in
                   enumerate(["alice", "bob", "alice", "bob"])]
    dev_imposter = [feature("carol", 2.0, 960 + j) for j in range(4)]
    op = gs.calibrate_rejection(dev_genuine, dev_imposter)
    decisions = [gs.predict_one_with_rejection(feature(label, 3.0, seed))
                 for label, seed in (("alice", 970), ("carol", 971))]
    n_serial = len(dev_genuine) + len(dev_imposter) + len(decisions)
    launches2 = {"frontend": gpu_frontend.LAUNCHES, "gmm": gpu_gmm.LAUNCHES,
                 "serial": gpu_gmm.SERIAL_LAUNCHES}
    print(f"phase 8 UBM GMM-32 ({UBM_ITERATIONS} iterations) + MAP "
          f"{enrolled_labels}: threshold {op['threshold']:.4f} EER "
          f"{op['eer']:.3f}; held-out alice -> {decisions[0]}, carol -> "
          f"{decisions[1]}", flush=True)
    print(f"phase 8 launches over phases 7-8: {launches2} ({n_serial} "
          f"serial decisions)", flush=True)
    if decisions != ["alice", None]:
        raise AssertionError(f"open-set decisions {decisions}")
    if launches2["serial"] < n_serial or launches2["frontend"] < 1:
        raise AssertionError(f"slice 2 missed a kernel: {launches2}")

    # 9. timing of the serial kernel and of the slice's paths
    sb, ub = serial_banks["bench"], serial_banks["ubm"]
    t["serial"] = time_ms(lambda: gpu_gmm.bank_avg_loglik(sb, x5, m5))
    t["serial_plain"] = time_ms(
        lambda: gpu_gmm.bank_avg_loglik_reference(sb, x5, m5))
    t["serial_ubm"] = time_ms(lambda: gpu_gmm.bank_avg_loglik(ub, x3, m3))
    t["serial_ubm_plain"] = time_ms(
        lambda: gpu_gmm.bank_avg_loglik_reference(ub, x3, m3))
    server = ModelInterface(device=dev)
    server.gmmset = gs
    sig5 = synth.synth_utterance("alice", 5.0, 980)
    t["reject"] = time_ms(lambda: server.predict_with_rejection(synth.FS,
                                                                sig5),
                          reps=1)
    trainer = ModelInterface(device=dev)
    for label, sigs in train_sigs.items():
        for sig in sigs:
            trainer.enroll(label, synth.FS, sig)
    t["train"] = time_ms(trainer.train, reps=1)
    tl = trainer.gmmset.train_log
    print(f"phase 9 [{card}] serial kernel, bench bank + UBM, 5 s: "
          f"{t['serial']:.4f} ms, plain {t['serial_plain']:.4f} ms")
    print(f"phase 9 [{card}] serial kernel, 80 x 256 + UBM, 3 s: "
          f"{t['serial_ubm']:.4f} ms, plain {t['serial_ubm_plain']:.4f} ms")
    print(f"phase 9 [{card}] predict_with_rejection, one 5 s utterance: "
          f"{t['reject']:.3f} ms")
    print(f"phase 9 [{card}] ModelInterface.train, 3 speakers x 12 s, "
          f"GMM-32: {t['train']:.3f} ms, {tl['iterations']} iterations, "
          f"{tl['host_syncs']} host syncs", flush=True)

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
        {"name": "bank_sum_loglik", "route": "cuda",
         "source": "speaker_recognition_tpu_torch/csrc/gmm_serial.cu",
         "replaces": "speaker_recognition_tpu/ops/pallas_gmm.py:47",
         "launches": launches2["serial"], "max_abs_err": err_serial,
         "ms": t["serial"], "plain_ms": t["serial_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
