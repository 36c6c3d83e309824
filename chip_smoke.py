#!/usr/bin/env python3
"""On-card check of speaker_recognition_tpu_torch: builds the CUDA kernels,
holds each against its plain torch version, drives batched predict, then
enrollment and open-set serial scoring through the entry points, and times
the kernels and the paths.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc. Phases (each prints its numbers; any failure
raises and the exit code is non-zero):
  1. device: card name, nvidia-smi name and power limit, kernel build time
  2. signal frontend kernel (K1, on an FFT) vs both plain versions, the
     dense packed DFT and the FFT route: 512 x 5 s at 8 kHz; a 150 s clip
     beside a short one; 11.025, 16 and 22.05 kHz batches; 44.1 and 48 kHz
     with fft_size 4096 (a 4096-point FFT); 96 kHz with fft_size 8192 and
     192 kHz with fft_size 16384 (8192- and 16384-point FFTs); 64 mel
     filters; 128 mel filters with LPC (144 outputs); 250 with LPC (266
     outputs, the fourth operator width); LPC order 40 with 40 cepstra; one
     utterance; two calls bitwise; its raw-autocorrelation mode (the LPC
     cepstra's) at the bench batch, at 16 and 22.05 kHz, at 48 kHz with
     fft_size 4096 and at 96 kHz with fft_size 8192
  3. bank-scoring kernel vs plain, two calls bitwise, each call counted on
     its route (TENSOR_LAUNCHES: the tensor route, 3 x TF32, up to d = 128):
     the 4 x 32 bench bank over 512 utterances; an 80 x 256 bank over 8; a
     4 x 1024 bank; d = 102 (bob's MFCC + LPC + two deltas at 16 kHz, the
     tensor route in chunks); d = 200 (the wide route); features that
     start off a 16-byte boundary; the
     benchmark cells' banks (80 x 32 and 4 x 32 at d = 38) over 512 x 311
     frames, with a frame under the -745 floor, also against float64
     (TENSOR_F64_ATOL; one TF32 term TENSOR_APART gates away)
  4. slice 1: `cli -t predict` on the fixture wavs, scores_batch against
     the JAX package's scores, both kernels' launch counts
  5. timing (CUDA events, median of 7 trials): end-to-end predict_scores at
     the bench geometry, each kernel and its plain version; K2's tensor
     route at the benchmark cells' shapes (512 x 311 frames, d = 38,
     80 x 32 and 4 x 32) beside its yardstick bound (three TF32 passes at
     the TF32 peak) and its plain version, its route counter checked
  6. serial kernel (one clustered launch) vs plain: the bench bank + UBM
     on one 5 s utterance, an 80 x 256 bank + UBM on 3 s, a 150 s clip,
     the underflow floor, no valid frame, one speaker, features off a
     16-byte boundary, 1024 components on 5 s and on the 150 s clip (a
     block walks several chunks of frames, each against the streamed
     rows), d = 102 and d = 200 (past the
     widest dimension a lane keeps in registers); at each, two calls
     bitwise and torch.profiler's count of kernels a call (one)
  7. slice 2: `cli -t enroll` then `cli -t predict` on CUDA at the default
     config; the same EM from one init on CUDA f32 against CPU f64
  8. the open set: train_ubm, adapt_speakers, calibrate_rejection and
     predict_one_with_rejection on CUDA; launch counts of phases 7-8; the
     same through ModelInterface at d = 102 (16 kHz), llr_scores against
     the CPU's plain version
  9. timing: the serial kernel and its plain version (the wrapper's host
     time and the device time), predict_with_rejection of one 5 s
     utterance, ModelInterface.train of three speakers
 10. full-spectrum kernel (K5, on an FFT) vs both plain versions, the
     dense DFT and the FFT route: 64 x 5 s at 48 kHz, 44.1 kHz, fft_size
     256 at 8 kHz, a frame longer than the FFT (16 kHz, fft_size 256),
     SRTPU_FRONTEND=full at 8 kHz, bob's config at 48 kHz, MFCC only, an
     utterance with no valid frame, 44.1 and 48 kHz with fft_size 4096, 128
     and 250 mel filters with LPC at 48 kHz, 96 kHz with fft_size 8192, 192
     kHz with fft_size 16384 and with 8192 (the default route there), two
     calls bitwise; fft_size 1500 at 8 kHz, which takes the chirp-z
     kernel, also with 144 outputs, 44.1 kHz with fft_size 1411 (the
     frame) and a 48 kHz frame folded onto fft_size 1000, each also
     against the chirp-z plain version
 11. frame-level packed kernel (K4 on an FFT, no serving caller) vs both
     plain versions, the dense packed DFT and the FFT route: 512 x 5 s at
     8 kHz and a 16 kHz batch with LPC cepstra, 96 and 192 kHz with
     fft_size 8192 and 16384, 250 mel filters at 48 kHz; the bench batch's
     LPCC through extract_batch launches K1's LPC-cepstra kernel (csrc/
     frontend_lpcc_signals.cu) once and K4 never, its features against
     the plain route
 12. slice 3 on the card: `cli -t enroll` then `cli -t predict` at 48 kHz,
     at the default config and with fft_size 4096 (K1 on a 4096-point
     FFT), and at 96 kHz with fft_size 8192 (K1 on an 8192-point FFT), the
     JAX-enrolled 48 kHz session against the JAX package's scores, UBM +
     MAP + open-set decisions at 48 kHz; then the LPC-cepstra slice at
     8 kHz: ModelInterface enroll, train, predict_batch, dump, `cli -t
     predict`, the open set, on K1's LPC-cepstra kernel and never K1's
     tile; launch counts of both; timing of the
     frontend kernels and their plain versions, of K5 beside the dense
     kernel and torch.fft.rfft in one interleaved set, of K1, K4 and K5 at
     96 kHz (8192-point FFTs), of predict_scores at 48 kHz, and of LPCC
     predict (K1's LPC-cepstra mode) beside the earlier route through K4
 13. the fused predict monolith (K6 and K7, one kernel; f32 on the FFT
     tile, bf16 on the dense tile) vs its plain versions (the FFT route's
     and the dense one): the bench batch in f32 and with bf16 DFT operands,
     against predict_scores (the frontend and bank-scoring kernels), 48 kHz
     with fft_size 4096, 96 kHz with fft_size 8192, a 4 x 1024 bank, d =
     102, the 80 x 256 bank over 8 utterances, a 150 s clip beside a 1 s
     one, MFCC only, 16 kHz, LPC order 40, an utterance with no valid
     frame; at each two calls bitwise and the launch counters; timing of
     the monolith, its plain versions and predict_scores, interleaved,
     with the FP32 roofline share
 14. the grid: K1 and K2 on 70,000 utterances of 0.1 s at 8 kHz and K3 on
     a bank of 70,000 speakers (launches of at most 65535 in one call), vs
     their plain versions
 15. the live path at the bench configuration (8 kHz, MFCC13 + LPC15,
     GMM-32 with k-means|| seeding): K5's chirp-z kernel at 216 outputs
     (fft_size 1500, 200 mel filters + LPC) on the bench batch vs its
     three plain versions (FFT route, chirp-z, dense), two calls bitwise,
     144 outputs bitwise inside 216, and through extract_batch
     (SRTPU_FRONTEND=full) on the bench batch vs the dense plain version,
     the chirp-z kernel launched once and the dense template never; the
     dense template launched directly on the same frames vs its plain
     version, two calls bitwise, 144 inside 216; both timed beside the
     plain versions and cuFFT's rfft at 1500 points; the chirp-z route on
     the cluster past M = 8192 (fft_size 16000, M = 16384, on 64 x 5 s;
     33000, M = 32768, on 8) vs its three plain versions, two calls
     bitwise, through extract_batch (the chirp counter once), timed beside
     the dense template on the same frames and cuFFT's rfft, the dense
     template at 16000 directly vs its plain version; the chirp-z route on
     the device-memory passes past the cluster (fft_size 261634, M =
     262144, on 2 x 5 s) vs its three plain versions through extract_batch
     (the chirp and passes counters once, the dense template never) and
     directly, timed beside the dense template on the same frames, its
     fused pass's split printed; past the chirp-z route's reach (fft_size
     16777218: M would be 2^24) the dense template through extract_batch
     on 2 utterances of two-sample frames (its counter once, nothing
     else) vs its plain version, and directly; the LTSD VAD and the
     spectral gate on the card vs the CPU at float64 (identical intervals, two
     calls bitwise); Lloyd's on the card vs the CPU at float64 from one
     init, k-means|| over 8 seeds against the CPU's median inertia, and
     seeding + EM of 80 speakers x 30 s at GMM-256 (warm, median of 7, the
     seeding by stage); then the port's web GUI
     on an ephemeral port: noise, noisy enrollments filtered, k-means-
     seeded training, filtered predictions of held-out clips, and a
     conversation on the JAX-calibrated session whose timeline must equal
     the JAX package's (testdata/synth3_conv_expected.json), K1 and K2
     launched once a predicting tick and never on a tick the VAD empties,
     no plain version run; K1 and K2 on a tick's padded batch vs their
     plain versions, and its predict_scores vs the plain versions
     composed; timing of a tick, init_noise, and k-means-seeded training
     beside plain-init training
 16. the lifted limits: K1, K4 and K5 on the four-step route of N >= 32768
     (384 kHz frames of 12,288 samples with fft_size 32768 on the packed
     route, fft_size 32768 and 65536 at 48 kHz on the full route: a
     frame's spectrum on one block and on a cluster of 2; K1 and K4 at
     65536 with 64 ms frames; K5 at 262144 on a cluster of 8 and at 524288
     on the device-memory passes, a few frames each, the fused pass split
     over the bins, its S printed beside the stages' device times; at
     524288 also on 62 frames of 1536 samples at 48 kHz, which take the
     column pass, timed alike) and past
     512 outputs on the FFT tile (600 mel filters + LPC at 8 kHz, 200 ms
     frames, fft_size 4096), each against the FFT route's plain version
     (and K5 against the dense one, K1 at 616 outputs against the float64
     route), two calls bitwise, through extract_batch with its route's
     counter, 512 outputs bitwise inside 616, and timed with the four-step
     route's device time by kernel (K5 beside cuFFT's rfft of the same
     frames); K6's bf16 route at 144 outputs on the
     bench batch (timed), 48 kHz frames with fft_size 4096 and 96 kHz with
     fft_size 8192 (32-frame tiles), 192 kHz with fft_size 16384 (the
     samples from device memory), each on the tile it claims, against its
     plain version
 17. float64 on the card: enroll, MAP from a float64 UBM, predict,
     predict_with_rejection and calibrate_rejection at dtype="float64"
     against the same on the CPU (within F64_RTOL, the same labels), the
     float64 counters moving and K1, K2, K3 not; an f32 call after it
     launching K1 and K2; f64 predict_scores at the bench batch beside f32
 18. JFA at the r5 cell's model shape (UBM K = 32, nv = 32, nu = 16,
     train_d) on 200 background speakers x 3 sessions of the port's
     identity-structured voices through per-session channels, at 0 and
     6 dB: the card's scores against the CPU's from the same stats (the
     gate), JFA's and MAP's accuracy and EER and the times (a report);
     then the jfa_pipeline CLI on the card, K1 once a gen-features
     utterance
 19. the RBM family: its deterministic surfaces and one CD step on the
     card against the CPU; a CRBM bank at speaker_task_config (4 voices x
     ~1000 frames of CMVN'd MFCC, timed); segments bitwise equal to one
     run; predict_bank on held-out utterances, the same decisions with the
     card's bank on the CPU; `python -m ...tools.crbm_cli` train -> test
 20. the multi-device programs at world size 1 (NCCL on a free port):
     sharded_fit and train_ubm(mesh=...) bitwise equal to the unsharded
     fits, sharded_bank_scores bitwise equal to the unsharded K3 call (K3
     counted), the sequence-sharded features against mix_feature (K1
     counted), K1 no farther from the float64 route on that voice than
     VOICE_FACTOR x the f32 plain versions, in its LPC mode and in its
     LPC-cepstra mode (csrc/frontend_lpcc_signals.cu, beside the raw tile
     + the torch recursion), scaling_report; phase 13 also
     holds the monolith's f32
     route at N = 32768 and 616 outputs (phase13_lifted)
 21. the bf16 operand modes, each against its plain version with two calls
     bitwise and its counter: K2 bf16 (tensor cores) on the bench bank over
     512 x 5 s, the 80 x 256 bank over 8, 4 x 1024, d = 102, d = 200 and
     d = 300 (its wide route, 12 components padded to 16); K2 bf16's argmax
     decisions against f32 on an 80-voice GMM-256 bank (printed, not
     gated); K3 bf16 on phase 6's bench bank + UBM, 80 x 256 + UBM and
     1024 components (5 s and the 150 s clip); K1 bf16 (the dense tile's
     product on the tensor cores) on the bench batch, 144 outputs, the
     raw-autocorrelation mode, 48 kHz and 44.1 kHz (flen 1411, fshift
     705: odd) with fft_size 4096, each with its tile (frames, shared
     memory, blocks an SM) and its cepstra held to per-cepstrum limits
     (MFCC_BF16_ATOL, or the mel sums' rounding where they cancel); K4
     bf16 on the bench batch's frames;
     predict_scores(mm="bf16") against the plain versions composed (K1
     bf16 once, K2 f32 once, K1 f32 never); the 48 kHz full route's bf16
     product (its counter moves, K5's do not); each bf16 kernel timed
     beside its f32 mode and plain version, K6 bf16 at 66 and 144 outputs,
     predict_scores at both mm values and cuBLAS's bf16 product of the
     bench frames and D (the yardstick of the tile's stage 1), in one
     interleaved set; the bf16 kernels' occupancy
 22. the full-spectrum frontend from the signals (K5's tile loading the
     signal, with K1's CMVN and Levinson in its tail, csrc/
     frontend_full_signals.cu) and the LPC cepstra in the signal kernels'
     tail, each against its plain version with two calls bitwise: 512 x 5
     s at 48 kHz, LPC cepstra at 48 kHz with a silent stretch (its
     cepstra 0), 44.1 kHz, no valid frame, fft_size 4096 / 8192 / 16384,
     128, 250 and 600 mel filters with LPC, frames folded onto the FFT (96
     and 192 kHz), K1's LPC-cepstra mode (csrc/frontend_lpcc_signals.cu:
     the signal tile with the power unfloored, the LPC cepstra in its
     tail) at 8 kHz with a silent stretch (its LPC cepstra 0) and 16 kHz;
     the 48 kHz and LPCC predicts' counters and kernels (torch.profiler:
     the LPC-cepstra mode launches its kernel and the CMVN kernel and
     nothing else), the LPC-cepstra kernel's occupancy; their timing
     beside the routes they replace, composed of the pieces that remain
     (torch's frames, K5 on them, the torch tail, K2; K1's raw mode, the
     torch tail, K2), the LPC-cepstra kernel beside K1's LPC mode and the
     LPCC predict in one interleaved set, and peak device memory both
     ways
The line before the last is {"kernels": [...]}, each kernel with its
launches on the main path (0 for K4, for K1's raw-autocorrelation mode
and for K5's frame-level FFT kernel at a power-of-two fft_size, which no
serving path takes; K5's
chirp-z kernel's on extract_batch at 216 outputs; the dense template's
on extract_batch past M = 2^23; phase 15's and 16's routes on their
extract_batch drives), its error against its plain version, its time,
its plain version's time and
its bound (the larger of the least FLOPs of
its function over the FP32 peak, the bf16 modes' products over the dense
bf16 tensor-core peak, and its bytes over the memory rate, from this run's
shapes); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import scipy.io.wavfile as wavfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from speaker_recognition_tpu_torch import _build, cli  # noqa: E402
from speaker_recognition_tpu_torch.api import fastpath  # noqa: E402
from speaker_recognition_tpu_torch.api.conversation import (  # noqa: E402
    ConversationSession)
from speaker_recognition_tpu_torch.api.interface import (  # noqa: E402
    ModelInterface)
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, GmmConfig, LpcConfig, MfccConfig, PipelineConfig,
    bob_mfcc_config, n_frames)
from speaker_recognition_tpu_torch.features import extract  # noqa: E402
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    FullFrontend, PackedFrontend)
from speaker_recognition_tpu_torch.gui import server as gui  # noqa: E402
from speaker_recognition_tpu_torch.models import (  # noqa: E402
    crbm, gmm, kmeans, neural_net, rbm)
from speaker_recognition_tpu_torch.models.gmm import GmmBank  # noqa: E402
from speaker_recognition_tpu_torch.models.gmmset import (  # noqa: E402
    GMMSet, _pad_frames_bucket, _pad_stack)
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    framing, gpu_frontend, gpu_gmm, gpu_predict)
from speaker_recognition_tpu_torch.ops import frontend as operators  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.tools import (  # noqa: E402
    crbm_cli, jfa_pipeline)
from speaker_recognition_tpu_torch.tools import ubm as ubm_tools  # noqa: E402
from speaker_recognition_tpu_torch.utils import (  # noqa: E402
    datamanip, metrics)
from speaker_recognition_tpu_torch.utils import serialization  # noqa: E402
from speaker_recognition_tpu_torch.vad import ltsd, noisered  # noqa: E402

BENCH_B, BENCH_FS, BENCH_SEC = 512, 8000, 5.0
LENGTH_BUCKET = 4096
# Frontend tolerances, kernel vs plain on the same card. Both are f32, but
# the kernels run an FFT (K1, K5) or sum the DFT in 32-row tiles (K4), and
# the mel/autocorrelation in chunks, where the plain versions take cuFFT's
# or cuBLAS's own order: about 1e-6 relative on the power spectrum, so
# 1e-3 absolute on CMVN'd O(1) cepstra leaves a wide margin. LPC comes out of a Levinson recursion that amplifies those
# rounding differences by the conditioning of the autocorrelation, hence
# 1e-2 absolute or 1e-3 relative, whichever is looser.
MFCC_ATOL = 1e-3
LPC_ATOL, LPC_RTOL = 1e-2, 1e-3
# The raw autocorrelation is a sum of f32 power bins taken in another
# order: ~1e-6 of the frame's lag-0 value (its largest) measured, 1e-4
# bounds it.
ACORR_RTOL = 1e-4
# Scoring: both sum 2d products per component in f32 in different orders;
# the [B, S] averages agree to ~1e-6 relative, 1e-4 bounds them.
SCORE_RTOL = 1e-4
# The benchmark cells' banks (perfbench/configs: 80 x 32 and 4 x 32 at
# d = 38) over 512 utterances of 311 frames (5 s at 8 kHz, 16 ms shift)
CELL_BANKS, CELL_DIM, CELL_FRAMES = ((80, 32), (4, 32)), 38, 311
# K2's tensor route (3 x TF32) at the cells' banks against the float64
# averages of the same f32 operands, absolute. Measured on the H100 (d =
# 38, Gaussian features, a frame under the floor, 512 x 311 frames): the
# route 2.9-3.2e-5, the FP32 route before it 1.3-1.4e-5, torch's f32
# product 3.0-4.3e-5; the route with its sums carried in the accumulators
# from cw 1.06-1.16e-4 (the tensor cores' adder truncates); one TF32 term
# 6.6e-4-1.5e-3. The gate lies between the route and both.
TENSOR_F64_ATOL = 8e-5
# ... and one TF32 term (both operands rounded to TF32, the products
# summed exactly) must lie at least TENSOR_APART of that gate away: a
# route that lost two of its three terms fails it
TENSOR_APART = 3.0
# Against the JAX package's CPU scores (different frontend arithmetic on
# another device): the fixture's agreement on the CPU is ~3e-5.
SLICE_RTOL = 1e-3
# Serial kernel vs plain: per-frame sums of the same products in another
# order, then a sum over frames in chunks; ~4e-7 relative measured.
SERIAL_RTOL = 1e-4
# The bf16 modes, kernel vs plain on the card: the same bf16-rounded
# operands, whose products are exact in f32, summed in another order by the
# tensor cores (K2, K3) or the dense tile (K1, K4). Measured on the H100:
# K2 up to 2.5e-6 relative (d = 300; 7e-7 at d = 28), K3 6.3e-7, K1's
# cepstra 4e-5 and LPC 8.8e-5 (48 kHz, fft_size 4096), K1's raw
# autocorrelation and K4 0, predict_scores(mm="bf16") 5.2e-7, the 48 kHz
# full route against the CPU 1.5e-6. Each gate is a few times that, far
# under the f32 gates above, which are as wide as the bf16 rounding itself.
SCORE_BF16_RTOL = 1e-5
SERIAL_BF16_RTOL = 5e-6
MFCC_BF16_ATOL = 2e-4
# ... except where the mel sums cancel (W's negative weights: at 128
# filters at 8 kHz a narrow filter's sum falls to 1e-7 of its magnitudes,
# and no two f32 orders of the same products agree to MFCC_BF16_ATOL in
# the cepstra): each cepstrum's limit is the larger of MFCC_BF16_ATOL and
# MFCC_BF16_ULPS units of 2^-24 sum |X^2| |W| on its mel sums, carried to
# first order through the log, the DCT and CMVN
# (gpu_frontend.bf16_cepstra_limits). At the bench's 50 filters no limit
# passes MFCC_BF16_ATOL; the f32 product must lie BF16_APART limits away.
MFCC_BF16_ULPS = 16
LPC_BF16_ATOL, LPC_BF16_RTOL = 1e-3, 1e-4
ACORR_BF16_RTOL = 1e-5
PREDICT_BF16_RTOL = 5e-6
FULL_BF16_RTOL = 2e-5
# ... and each bf16 check also measures, on the same inputs, how far the
# f32 mode (for K2 and K3 also the other kernel's x^2 rounding) lies from
# the bf16 plain version, and fails unless that is at least BF16_APART
# gates: a kernel that rounds nothing, or rounds x^2 the other way, would
# fail its gate.
BF16_APART = 3.0
# 20 EM iterations of GMM-32 in f32 on the card against f64 on the CPU
# from one init: f32 vs f64 on the CPU drifts by up to 8e-5 absolute on
# means and sigmas (O(1)) and 1.2e-6 on weights; 1e-3 leaves 12x margin.
EM_ATOL = 1e-3
UBM_ITERATIONS = 100
FS48 = 48000
LPCC = LpcConfig(n_lpcc=16)
# (trials, calls a trial) of phase 22's interleaved timing set
SIGNAL_TRIALS = (7, 3)
# shapes the tile widened to: a 4096-point FFT (44.1/48 kHz frames with
# fft_size 4096), LPC order 40 and 40 cepstra
FFT4096 = FeatureConfig(mfcc=MfccConfig(fft_size=4096))
ORDER40 = FeatureConfig(mfcc=MfccConfig(n_ceps=40), lpc=LpcConfig(n_lpc=40))
# 8192- and 16384-point FFTs: 96 kHz frames (3072 samples) with fft_size
# 8192 and 192 kHz frames (6144) with fft_size 16384 on the packed route
FS96, FS192 = 96000, 192000
FFT8192 = FeatureConfig(mfcc=MfccConfig(fft_size=8192))
FFT16384 = FeatureConfig(mfcc=MfccConfig(fft_size=16384))
# the 96 kHz CLI slice: 26 mel filters over 0-48 kHz leave the synthetic
# speakers' harmonic stacks too few filters (the JAX package and the CPU's
# plain route take carol for bob as well); 40 separate them
CLI96 = FeatureConfig(mfcc=MfccConfig(fft_size=8192, n_filters=40))
# 250 mel filters + LPC-15 (266 outputs) at 48 kHz, fft_size 4096: the
# fourth operator width (up to 512 outputs)
WIDE266 = FeatureConfig(mfcc=MfccConfig(fft_size=4096, n_filters=250))
# d = 102 in the monolith (87 cepstra of 128 filters + LPC-15): its
# register route past a padded d of 32
D102 = FeatureConfig(mfcc=MfccConfig(n_filters=128, n_ceps=87))
# the high-rate batches: 64 x 5 s at 96 kHz and 16 x 5 s at 192 kHz on the
# card (the same share of the bench batch where it is cut)
BIG_B, HUGE_B = max(2, BENCH_B // 8), max(2, BENCH_B // 32)
HIGH_SEC = BENCH_SEC  # their longest utterance
# the grid phase: more utterances (and speakers) than a launch's 65535
GRID_B = 70000
# Fused predict vs its plain version, both f32 on the card: the frontend
# differs as in phase 2 (~1e-5 on cepstra), the scores are means of
# hundreds of frames' log-likelihoods; 1e-3 relative with identical argmax.
FUSED_RTOL = 1e-3
# the dense K5 template past 192 outputs: 200 mel filters + LPC-15 at a
# fft_size that is not a power of two
DENSE216 = FeatureConfig(mfcc=MfccConfig(fft_size=1500, n_filters=200))
# LTSD scores (dB) on the card at f32 against the CPU at f64: the spectra
# differ by ~1e-6 relative, a score by ~1e-5 dB; the live path's scores
# clear both thresholds by >= 0.39 dB (synth3_conv_expected.json)
LTSD_ATOL = 1e-3
# the spectral gate, f32 on the card against f64 on the CPU, relative to
# the signal's peak: two rffts and an irfft in f32, ~1e-7 of the peak
GATE_RTOL = 1e-5
# Lloyd's from one init on well-separated blobs (centroids O(10)), f32 on
# the card against f64 on the CPU: the same assignments, so the centroids
# differ by the f32 rounding of sums over ~1000 points (~1e-5)
LLOYD_ATOL = 1e-3
# k-means|| over 8 seeds on a speaker's features: every seed's inertia
# within this factor of the CPU's median (seeds spread by ~2% on the CPU at
# f32 and f64); PARITY.md N3's single-pass collapse was 38x
KMEANS_FACTOR = 1.1
# the UBM-scale seeding + EM: speakers x seconds at 8 kHz, GMM-256
KM_SPEAKERS, KM_SECONDS, KM_K = 80, 30.0, 256
# phase 16: the four-step route of N >= 32768 (384 kHz frames of 12,288
# samples on the packed route, BIG384_B utterances; fft_size 32768 and
# 65536 at 48 kHz on the full route) and 616 outputs on the FFT tile
FS384, BIG384_B = 384000, 4
BIG384 = FeatureConfig(mfcc=MfccConfig(fft_size=32768))
FULL_BIG_FFTS = (32768, 65536)
# the cluster FFT's two-block size on the packed route (384 kHz frames of
# 64 ms, 24,576 samples: N = 65536), and K5's route sizes past it at 8 kHz
# (a few frames each): 262144 points on a cluster of 8, 524288 on the
# device-memory passes
BIG65536 = FeatureConfig(
    mfcc=MfccConfig(fft_size=65536, win_length_ms=64.0, win_shift_ms=32.0),
    lpc=LpcConfig(win_length_ms=64.0, win_shift_ms=32.0))
ROUTE_FFTS = (262144, 524288)
# the chirp-z route on the cluster (M = 16384 at fft_size 16000 on the
# bench batch, M = 32768 at 33000 on 8 utterances) and on the device-memory
# passes past its reach (fft_size 261634 at 8 kHz: M = 262144), where the
# dense template served before
CHIRP_CLUSTER_FFTS = (16000, 33000)  # BIG_B and 8 utterances
PAST_CLUSTER_FFT = 261634
# past the chirp-z route's reach (M would be 2^24) the dense template: at 8
# kHz, fft_size 16777218 on frames of two samples, 2 filters, no LPC (C and
# S of 2 x 8,388,612). A frame of one sample has a flat spectrum, so its
# cepstrum past c0 is the same for every frame and CMVN scales rounding up
# to O(1); two samples make it vary. 2 utterances of these samples
PAST_REACH_FFT = 16777218
PAST_REACH = FeatureConfig(
    mfcc=MfccConfig(fft_size=PAST_REACH_FFT, win_length_ms=0.25,
                    win_shift_ms=0.25, n_filters=2, n_ceps=1),
    use_lpc=False)
PAST_REACH_LENGTHS = (96, 64)
# (trials, calls a trial) of those routes' timings: the chirp on the
# cluster beside the dense template; the small cases past it
ROUTE_TRIALS, SMALL_TRIALS = (7, 3), (5, 1)
# (8 kHz with 200 ms frames of 1600 samples and fft_size 4096: a
# 4096-point FFT, the FFT route's operator mel itself, and no empty filter
# among the 600; at 48 kHz with fft_size 4096 nine are empty, where the
# JAX extractor's full route takes log(0))
WIDE616 = FeatureConfig(
    mfcc=MfccConfig(win_length_ms=200.0, win_shift_ms=100.0, fft_size=4096,
                    n_filters=600),
    lpc=LpcConfig(win_length_ms=200.0, win_shift_ms=100.0))
# phase 17: float64 on the card against the CPU's float64 run, normwise
# (max |d| / max |x|): the same plain torch arithmetic in another order,
# ~1e-15 a step, so 1e-9 leaves room for the EM's iterations
F64_RTOL = 1e-9
# phase 18: JFA at the model shape of experiments/results/
# r5_identity_structure.jsonl (UBM K = 32 on MFCC13 + LPC15, nv = 32,
# nu = 16, train_d, 20 iterations) on the port's identity-structured
# voices: JFA_BG background speakers x JFA_BG_SESSIONS sessions of JFA_SEC
# s, JFA_EVAL enrolled speakers x JFA_ENROLL sessions, JFA_TESTS tests of
# JFA_TEST_SEC s each, every session through its own channel
JFA_BG, JFA_BG_SESSIONS, JFA_SEC = 200, 3, 10.0
JFA_EVAL, JFA_ENROLL, JFA_TESTS, JFA_TEST_SEC = 20, 2, 10, 3.0
JFA_K, JFA_NV, JFA_NU, JFA_ITERS, JFA_UBM_ITERS = 32, 32, 16, 20, 100
JFA_CHANNELS_DB = (0.0, 6.0)
# the card's JFA scores against the CPU's from the same stats and inits,
# both f32: ~60 EM iterations of batched solves in other summation orders;
# relative to the largest |score|
JFA_RTOL = 1e-3
# phase 19: the RBM family. CRBM_SPEAKERS voices of the identity family,
# CRBM_SEC s of training audio each at 8 kHz (~1000 frames, the
# reference's nr_data_max) and CRBM_TESTS held-out utterances of
# CRBM_TEST_SEC s each; a bank of CRBM_HIDDEN hidden units at
# speaker_task_config (full batch, 2000 epochs)
CRBM_SPEAKERS, CRBM_SEC, CRBM_TESTS, CRBM_TEST_SEC = 4, 16.0, 3, 3.0
CRBM_HIDDEN = 32
# on CMVN'd MFCC: with the LPC columns (unnormalized) the CRBM bank
# predicts one speaker for every utterance of these voices in both
# packages (experiments/results/r5_crbm_faithful.jsonl finds the same of
# raw features); on MFCC alone it separates them
CRBM_FEATURES = FeatureConfig(use_lpc=False)
CRBM_CLI_EPOCHS = 100
# the card against the CPU on the RBM family's deterministic surfaces and
# one CD step given the same noise, both f32, normwise (max |d| / max |x|):
# sigmoids and small matmuls in other orders, ~1e-7 measured on the CPU
# between thread counts
RBM_RTOL = 1e-5
# phase 20: the multi-device programs at world size 1 over NCCL: sharded
# EM on the pooled phase-19 features (GMM-32, MULTI_ITERS iterations),
# bank-sharded scoring of a 5 s utterance against MULTI_S x 32, one
# SEQ_SEC s utterance's features sharded over 'data'
MULTI_ITERS, MULTI_S, SEQ_SEC = 50, 16, 60.0
# that utterance's near-singular frames (formant poles at radius 0.97)
# part every f32 route of the signal frontend from the float64 route, by a
# share of frames that depends on the utterance: K1 (CMVN off) may part
# from float64 by at most VOICE_FACTOR times the farther of the two f32
# plain versions, in the cepstra's max |d| and in the frames whose LPC
# parts past LPC_ATOL / LPC_RTOL. Measured on the H100 (3,749 frames):
# cepstra K1 0.162, dense 0.912, FFT route 0.211; LPC frames K1 1,098,
# dense 719, FFT route 619 (1.53x)
VOICE_FACTOR = 2.0
# the rows of that voice phase 20 reads again: the longest utterance the
# JAX package serves through its Pallas K1 (pallas_frontend.MAX_UTT_ROWS)
VOICE_ROWS = 2560
# scaling_report's EM frames a process (its default, the JAX package's)
SCALING_FRAMES = 262_144
# phase 21: K2's bf16 decisions against f32 at the UBM-scale shape, on a
# bank of FLIP_SPEAKERS voices x FLIP_SEC s, GMM-256 (FLIP_ITERS EM
# iterations), each voice tested on FLIP_TESTS utterances of FLIP_TEST_SEC s
FLIP_SPEAKERS, FLIP_SEC, FLIP_TESTS, FLIP_TEST_SEC = 80, 30.0, 2, 3.0
FLIP_ITERS = 20
# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, the
# dense bf16 and TF32 tensor cores, HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12


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


def feature_errors(got, want, mask, nc, lpc_tol=(LPC_ATOL, LPC_RTOL)):
    """(max |d| of the MFCC columns, of the LPC columns, count of LPC
    entries over both LPC bounds `lpc_tol`) on the valid frames of
    [B, T, d]."""
    m = mask[..., None]
    d_mfcc = ((got[..., :nc] - want[..., :nc]).abs() * m).max().item()
    d_lpc = (got[..., nc:] - want[..., nc:]).abs()
    lpc_bad = ((d_lpc > lpc_tol[0])
               & (d_lpc > lpc_tol[1] * want[..., nc:].abs())
               & m).sum().item()
    d_lpc = (d_lpc * m).max().item() if d_lpc.numel() else 0.0
    return d_mfcc, d_lpc, lpc_bad


def ceps_ratio(got, want, lim, mask) -> float:
    """max |got - want| / lim over the valid frames' cepstra (the first
    lim.shape[-1] columns of [B, T, d])."""
    nc = lim.shape[-1]
    d = (got[..., :nc] - want[..., :nc].to(got.dtype)).abs() / lim
    return float(d[mask].max())


def limit_text(lim, mask, past: float) -> str:
    """The cepstra limits of a bf16 check, for its line."""
    return (f"limit {MFCC_BF16_ATOL:g}, or {MFCC_BF16_ULPS:g} ulps of the "
            f"mel sums carried through log, DCT and CMVN where larger: on "
            f"{past:.4f} of the valid cepstra, up to "
            f"{float(lim[mask].max()):.3e}")


def check_frontend(name, fe: PackedFrontend, sig, lengths,
                   phase=2, dense=True) -> float:
    """The signal frontend kernel vs both plain versions on one batch (the
    FFT route's alone without `dense`), and two calls bitwise; returns the
    max abs error."""
    args = frontend_args(fe, sig, lengths)
    n_valid = args[1]
    mask = torch.arange(n_frames(sig.shape[1], fe.frame_len, fe.frame_shift),
                        device=sig.device) < n_valid[:, None]
    got = gpu_frontend.packed_from_signals(*args, fft=fe.fft)
    again = gpu_frontend.packed_from_signals(*args, fft=fe.fft)
    plains = {"fft": gpu_frontend.packed_from_signals_fft_reference(
        sig, n_valid, fe.fft, fe.dct, fe.floor, fe.frame_shift, fe.cmvn)}
    if dense and fe.D is not None:  # no dense operators from N = 32768 on
        plains["dense"] = gpu_frontend.packed_from_signals_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite features")
    if (got[~mask] != 0).any():
        raise AssertionError(f"{name}: frames past n_valid are not zero")
    err = 0.0
    for plain, want in plains.items():
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
        d_mfcc, d_lpc, lpc_bad = feature_errors(got, want, mask,
                                                fe.dct.shape[1])
        print(f"phase {phase} {name} vs {plain} plain: shape "
              f"{tuple(got.shape)} "
              f"valid frames {int(n_valid.sum())} mfcc max|d| {d_mfcc:.3e} "
              f"(tol {MFCC_ATOL}) lpc max|d| {d_lpc:.3e} (over tol: "
              f"{lpc_bad})", flush=True)
        if d_mfcc > MFCC_ATOL or lpc_bad:
            raise AssertionError(f"{name}: frontend kernel disagrees with "
                                 f"the {plain} plain version")
        err = max(err, d_mfcc, d_lpc)
    bitwise = torch.equal(got, again)
    print(f"phase {phase} {name}: two calls bitwise equal: {bitwise}",
          flush=True)
    if not bitwise:
        raise AssertionError(f"{name}: the frontend kernel is not "
                             "deterministic")
    return err


def check_frontend_raw(name, fe: PackedFrontend, sig, lengths) -> float:
    """The signal frontend kernel's raw-autocorrelation mode vs both plain
    versions on one batch, and two calls bitwise; returns the max abs error
    of the cepstra."""
    args = frontend_args(fe, sig, lengths)
    n_valid = args[1]
    mask = torch.arange(n_frames(sig.shape[1], fe.frame_len, fe.frame_shift),
                        device=sig.device) < n_valid[:, None]
    ceps, r = gpu_frontend.packed_from_signals(*args, fft=fe.fft,
                                               fuse_lpc=False)
    again = gpu_frontend.packed_from_signals(*args, fft=fe.fft,
                                             fuse_lpc=False)
    plains = {"dense": gpu_frontend.packed_from_signals_reference(
                  *args, fuse_lpc=False),
              "fft": gpu_frontend.packed_from_signals_fft_reference(
                  sig, n_valid, fe.fft, fe.dct, fe.floor, fe.frame_shift,
                  fe.cmvn, fuse_lpc=False)}
    torch.cuda.synchronize()
    if not (torch.isfinite(ceps).all() and torch.isfinite(r).all()):
        raise AssertionError(f"{name}: non-finite cepstra or autocorrelation")
    if (ceps[~mask] != 0).any() or (r[~mask] != 0).any():
        raise AssertionError(f"{name}: frames past n_valid are not zero")
    err = 0.0
    for plain, (want_c, want_r) in plains.items():
        if ceps.shape != want_c.shape or r.shape != want_r.shape:
            raise AssertionError(f"{name}: shapes {ceps.shape}, {r.shape}")
        d_ceps = (ceps - want_c).abs().max().item()
        lag0 = want_r[..., :1].abs().clamp_min(1e-30)
        d_r = ((r - want_r).abs() / lag0)[mask].max().item()
        print(f"phase 2 {name} vs {plain} plain: cepstra "
              f"{tuple(ceps.shape)} max|d| {d_ceps:.3e} (tol {MFCC_ATOL}), "
              f"autocorrelation {tuple(r.shape)} max|d|/lag0 {d_r:.3e} (tol "
              f"{ACORR_RTOL})", flush=True)
        if d_ceps > MFCC_ATOL or d_r > ACORR_RTOL:
            raise AssertionError(f"{name}: raw-autocorrelation mode "
                                 f"disagrees with the {plain} plain version")
        err = max(err, d_ceps)
    bitwise = all(torch.equal(a, b) for a, b in zip((ceps, r), again))
    print(f"phase 2 {name}: two calls bitwise equal: {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError(f"{name}: the frontend kernel is not "
                             "deterministic")
    return err


def random_bank(rng, S, K, d, dev, uniform_weights=False):
    w = (np.full((S, K), 1.0 / K) if uniform_weights
         else rng.dirichlet(np.ones(K), size=S))
    return GmmBank.from_numpy(w.astype(np.float32),
                              rng.randn(S, K, d).astype(np.float32),
                              (0.5 + rng.rand(S, K, d)).astype(np.float32),
                              dev)


def max_rel(got, want, floor=1e-30) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(floor)).max())


def swapped_rounding(bank, X, mask, batched: bool):
    """The plain bf16 scores with x^2 rounded the other JAX kernel's way
    (K2, batched: x rounded, squared, rounded again; K3, serial: squared in
    f32, rounded once): [B, S] averages or [S] sums."""
    S, K = bank.n_speakers, bank.n_mixtures
    Z, op = gmm._operands(bank, X, "bf16", square_rounded=not batched)
    lse = gmm._floored_lse((Z @ op + bank.cw).reshape(*X.shape[:-1], S, K),
                           1e-15)
    m = mask.to(X.dtype)
    if not batched:
        return m @ lse
    return torch.einsum("bts,bt->bs", lse, m) / m.sum(-1).clamp_min(1.0)[
        :, None]


def bf16_apart(what: str, dists: dict, tol: float) -> str:
    """Raise unless every distance of `dists` (the f32 mode's, the other
    rounding's, from the bf16 plain version) is at least BF16_APART x tol;
    returns them for the check's line."""
    for k, v in dists.items():
        if not v >= BF16_APART * tol:
            raise AssertionError(
                f"{what}: the {k} lies {v:.3e} from the bf16 plain version, "
                f"under {BF16_APART:g} x the gate {tol:g}: the gate cannot "
                "tell the modes apart")
    return ("; from the bf16 plain version: " + ", ".join(
        f"{k} {v:.3e}" for k, v in dists.items())
        + f" (each >= {BF16_APART:g} x tol: "
        + f"{min(dists.values()) / tol:.1f}x)")


def f64_averages(bank, X, mask, one_term=False):
    """The [B, S] average log-likelihoods of the f32 operands in float64
    (x^2 formed in float64), 32 utterances at a time; one_term: [x^2 | x]
    (x^2 in f32) and op rounded to TF32 first, as one TF32 term takes them,
    the products summed exactly."""
    S, K = bank.n_speakers, bank.n_mixtures
    B, T, _ = X.shape
    op, cw = bank.op.double(), bank.cw.double()
    if one_term:
        op = gmm.round_tf32(bank.op).double()
    out = torch.empty((B, S), dtype=torch.float64, device=X.device)
    m = mask.double()
    for b0 in range(0, B, 32):
        x = X[b0:b0 + 32]
        if one_term:
            Z = gmm.round_tf32(torch.cat([x * x, x], -1)).double()
        else:
            x64 = x.double()
            Z = torch.cat([x64 * x64, x64], -1)
        lse = gmm._floored_lse((Z @ op + cw).reshape(*x.shape[:-1], S, K),
                               1e-15)
        w = m[b0:b0 + 32]
        out[b0:b0 + 32] = (torch.einsum("bts,bt->bs", lse, w)
                           / w.sum(-1).clamp_min(1.0)[:, None])
    return out


def tensor_gate(name, bank, feats, mask, got) -> str:
    """K2's tensor route against float64 within TENSOR_F64_ATOL, one TF32
    term at least TENSOR_APART gates away; returns both for the check's
    line."""
    exact = f64_averages(bank, feats, mask)
    err = float((got.double() - exact).abs().max())
    one = float((f64_averages(bank, feats, mask, one_term=True)
                 - exact).abs().max())
    if not err <= TENSOR_F64_ATOL:
        raise AssertionError(f"{name}: the tensor route lies {err:.3e} from "
                             f"float64, past {TENSOR_F64_ATOL:g}")
    if not one >= TENSOR_APART * TENSOR_F64_ATOL:
        raise AssertionError(
            f"{name}: one TF32 term lies {one:.3e} from float64, under "
            f"{TENSOR_APART:g} x the gate {TENSOR_F64_ATOL:g}: the gate "
            "cannot tell three terms from one")
    return (f"; from float64 {err:.3e} (gate {TENSOR_F64_ATOL:g}), one TF32 "
            f"term {one:.3e} ({one / TENSOR_F64_ATOL:.1f}x the gate)")


def check_scoring(name, bank, feats, mask, phase=3,
                  precision="f32", f64_gate=False) -> float:
    """The batched scoring kernel at `precision` vs its plain version:
    SCORE_RTOL (SCORE_BF16_RTOL at bf16, where the f32 mode and K3's x^2
    rounding must lie BF16_APART gates away), the same argmax, two calls
    bitwise, two launches counted; f64_gate (f32 on the tensor route): also
    tensor_gate. Returns the max abs error."""
    bf16 = precision == "bf16"
    counter = "BF16_LAUNCHES" if bf16 else "LAUNCHES"
    tol = SCORE_BF16_RTOL if bf16 else SCORE_RTOL
    before = getattr(gpu_gmm, counter)
    tensor_before = gpu_gmm.TENSOR_LAUNCHES
    got = gpu_gmm.batch_bank_avg_loglik(bank, feats, mask,
                                        precision=precision)
    again = gpu_gmm.batch_bank_avg_loglik(bank, feats, mask,
                                          precision=precision)
    launched = getattr(gpu_gmm, counter) - before
    tensor = gpu_gmm.TENSOR_LAUNCHES - tensor_before
    on_route = not bf16 and feats.shape[-1] <= gpu_gmm.TENSOR_MAX_DIM
    want = gpu_gmm.batch_bank_avg_loglik_reference(bank, feats, mask,
                                                   precision=precision)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite scores")
    d = (got - want).abs()
    rel = max_rel(got, want)
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    bitwise = torch.equal(got, again)
    apart = bf16_apart(name, {
        "f32 mode": max_rel(gpu_gmm.batch_bank_avg_loglik_reference(
            bank, feats, mask), want),
        "K3's x^2 rounding": max_rel(swapped_rounding(bank, feats, mask,
                                                      True), want)},
        tol) if bf16 else ""
    if f64_gate:
        if not on_route:
            raise AssertionError(f"{name}: the float64 gate is the tensor "
                                 "route's")
        apart = tensor_gate(name, bank, feats, mask, got)
    mode = "K2 bf16 " if bf16 else ""
    print(f"phase {phase} {mode}{name}: [B, S] {tuple(got.shape)} d "
          f"{feats.shape[-1]} K "
          f"{bank.n_mixtures} max|d| {d.max().item():.3e} max rel {rel:.3e} "
          f"(tol {tol}) argmax identical {same} launches {launched} "
          f"(tensor route {tensor}) two calls bitwise equal {bitwise}{apart}",
          flush=True)
    if rel > tol or not same or not bitwise or launched != 2:
        raise AssertionError(f"{name}: scoring kernel disagrees with plain")
    if tensor != (2 if on_route else 0):
        raise AssertionError(f"{name}: {tensor} launches on the tensor route")
    return d.max().item()


def off_alignment(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x that starts one element into its storage."""
    flat = x.new_empty(x.numel() + 1)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


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


def device_times(fn, calls=20) -> str:
    """Where a call's time goes: the device microseconds per launch of
    each kernel fn() launches (their count and sum where there are many),
    by torch.profiler, and the host's microseconds per call to enqueue
    them (timed without the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and ev.device_time_total]
    if len(evs) > 4:
        device = (f"{sum(ev.count for ev in evs) / calls:.0f} launches a "
                  f"call, {sum(ev.device_time_total for ev in evs) / calls:.1f}"
                  " us in all")
    else:
        device = ", ".join(f"{kernel_name(ev.key)} "
                           f"{ev.device_time_total / ev.count:.1f} us"
                           for ev in evs) or "not measured"
    return f"device {device}; host enqueue {host:.1f} us a call"


def kernel_times(fn, calls=5) -> dict:
    """{kernel name: device ms a call} of the kernels fn() launches, by
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.device_time_total:
            key = kernel_name(ev.key)
            out[key] = out.get(key, 0.0) + ev.device_time_total / calls / 1e3
    return {k: round(v, 4) for k, v in out.items()}


def kernels_per_call(fn, calls=20, windows=8) -> dict:
    """{kernel name: launches a call} of the device kernels fn() runs, by
    torch.profiler (copies and memsets not counted): in up to `windows`
    windows, `calls` calls in an active profiling step after a warm-up
    step, read when that step's trace is ready (the step's own annotation
    is not a kernel). The profiler drops events now and then and never
    adds one, so each kernel's count is its most in any window; the
    windows stop at the first one in which every kernel shows a whole
    number of launches a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    counts = {}
    whole = []

    def ready(prof):
        seen = {}
        for ev in prof.key_averages():
            if (ev.device_type == DeviceType.CUDA and "emcpy" not in ev.key
                    and "emset" not in ev.key
                    and not ev.key.startswith("ProfilerStep")):
                key = kernel_name(ev.key)
                seen[key] = seen.get(key, 0) + ev.count / calls
        for key, per in seen.items():
            counts[key] = max(counts.get(key, 0), per)
        whole.append(bool(seen) and all(per == round(per) >= 1
                                        for per in seen.values()))

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        if any(whole):
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
    return counts


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without namespace, template or
    arguments."""
    return key.replace("(anonymous namespace)::", "").split("<")[0].split(
        "(")[0].split()[-1]


def check_serial(name, bank, x, mask, floor=False, phase=6, per_call=1):
    """Serial kernel vs plain on one utterance, averages and sums, with a
    bit-equal rerun and one kernel a call (by torch.profiler: no other
    kernel, and at most `per_call` launches a call, one per 65535 speakers,
    since the profiler may drop an event but never adds one); returns the
    max abs error of the averages."""
    before = gpu_gmm.SERIAL_LAUNCHES
    got = gpu_gmm.bank_avg_loglik(bank, x, mask)
    want = gpu_gmm.bank_avg_loglik_reference(bank, x, mask)
    sums = gpu_gmm.bank_sum_loglik(bank, x, mask)
    want_sums = gpu_gmm.bank_sum_loglik_reference(bank, x, mask)
    again = gpu_gmm.bank_avg_loglik(bank, x, mask)
    torch.cuda.synchronize()
    launched = gpu_gmm.SERIAL_LAUNCHES - before
    kernels = kernels_per_call(lambda: gpu_gmm.bank_avg_loglik(bank, x,
                                                               mask))
    d = (got - want).abs()
    rel = (d / want.abs().clamp_min(1e-30)).max().item()
    rel_sum = ((sums - want_sums).abs()
               / want_sums.abs().clamp_min(1e-30)).max().item()
    # the floor makes every speaker tie; elsewhere the winner must agree
    ties = want.unique().numel() < want.numel()
    same = ties or int(got.argmax()) == int(want.argmax())
    print(f"phase {phase} {name}: S {bank.n_speakers} K {bank.n_mixtures} "
          f"frames "
          f"{int(mask.sum())}/{mask.numel()} max|d| {d.max().item():.3e} "
          f"max rel {rel:.3e} (sums {rel_sum:.3e}; tol {SERIAL_RTOL}) "
          f"argmax identical {same} rerun bit-equal "
          f"{torch.equal(got, again)} launches {launched}, by torch.profiler "
          f"{kernels}: device kernels a call {sum(kernels.values()):g}",
          flush=True)
    if (not torch.isfinite(got).all() or rel > SERIAL_RTOL
            or rel_sum > SERIAL_RTOL or not same or launched != 3
            or not torch.equal(got, again)
            or set(kernels) != {"serial_kernel"}
            or not 0 < kernels["serial_kernel"] <= per_call):
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


def open_set(name, fs, pcfg: PipelineConfig, dev, n_mixtures=32):
    """The open set through the entry points at (fs, config) on the card:
    a UBM on the three synthetic speakers, alice and bob MAP-adapted from
    it, the threshold calibrated on held-out audio, then
    predict_with_rejection on a genuine and an impostor utterance, and
    llr_scores against the same bank's on the CPU (the plain version).
    Returns the server."""
    fcfg = pcfg.features
    utt = lambda label, sec, seed: synth.synth_utterance(  # noqa: E731
        label, sec, seed, fs)
    train = {label: [extract.mix_feature(fs, utt(label, sec, base + i), fcfg,
                                         device=dev)
                     for sec, base in synth.TRAIN]
             for i, label in enumerate(synth.SPEAKER_FREQS)}
    ubm = ubm_tools.train_ubm([f for fl in train.values() for f in fl],
                              n_mixtures=n_mixtures,
                              n_iterations=UBM_ITERATIONS, device=dev)
    labels, adapted = ubm_tools.adapt_speakers(
        ubm, {label: np.concatenate(train[label])
              for label in ("alice", "bob")}, device=dev)
    state = {"labels": labels, "weights": adapted.weights,
             "means": adapted.means, "sigmas": adapted.sigmas,
             "reject_threshold": 10.0, "ubm_weights": ubm.weights,
             "ubm_means": ubm.means, "ubm_sigmas": ubm.sigmas}
    server = ModelInterface(pcfg, device=dev)
    server.gmmset = GMMSet.from_state(state, device=dev)
    op = server.calibrate_rejection(
        fs, [utt(label, 2.0, 950 + j) for j, label in
             enumerate(["alice", "bob", "alice", "bob"])],
        [utt("carol", 2.0, 960 + j) for j in range(4)])
    decisions = [server.predict_with_rejection(fs, utt(label, 3.0, seed))
                 for label, seed in (("alice", 970), ("carol", 971))]
    x = extract.mix_feature(fs, utt("bob", 3.0, 972), fcfg, device=dev)
    got, got_ubm = server.gmmset.llr_scores(x)
    want, want_ubm = GMMSet.from_state(state, device="cpu").llr_scores(x)
    rel = float(np.max(np.abs(np.append(got, got_ubm)
                              - np.append(want, want_ubm))
                       / np.abs(np.append(want, want_ubm))))
    print(f"{name}: d {x.shape[1]}, UBM GMM-{n_mixtures} + MAP {labels}: "
          f"threshold {op['threshold']:.4f} EER {op['eer']:.3f}; held-out "
          f"alice -> {decisions[0]}, carol -> {decisions[1]}; llr_scores vs "
          f"the CPU's plain version max rel {rel:.3e} (tol {SERIAL_RTOL})",
          flush=True)
    if decisions != ["alice", None]:
        raise AssertionError(f"{name}: open-set decisions {decisions}")
    if x.shape[1] != fcfg.dim or rel > SERIAL_RTOL:
        raise AssertionError(f"{name}: llr_scores disagree with the CPU")
    return server


_DENSE_CS = {}


def dense_cs(fe: FullFrontend):
    """C and S of a full-spectrum frontend on its device, padded as its mel
    rows: the operators of the dense plain version and the dense kernel,
    which the FFT route does not keep. They depend on the frame length and
    the FFT size only."""
    if fe.C is not None:
        return fe.C, fe.S
    key = (fe.frame_len, fe.n_fft, fe.mel.shape[0], fe.mel.device)
    if key not in _DENSE_CS:
        pad = fe.mel.shape[0] - (fe.n_fft // 2 + 1)
        _DENSE_CS[key] = tuple(
            torch.as_tensor(np.pad(x, ((0, 0), (0, pad))),
                            dtype=torch.float32, device=fe.mel.device)
            for x in operators.dft_power_projection(fe.frame_len, fe.n_fft))
    return _DENSE_CS[key]


def frames_args(fe, sig, dense=True):
    """The frame-level kernel's arguments for a batch, as fe.forward builds
    them (C and S for the full spectrum even where the FFT route does not
    read them; None without `dense`): (args, B, T)."""
    fr = framing.frame_signal(sig, fe.frame_len, fe.frame_shift)
    B, T = fr.shape[:2]
    if isinstance(fe, FullFrontend):
        wp = framing.window_preemph(fr, fe.frame_len, fe.pre_emph,
                                    fe.preemph_first)
        return ((wp.reshape(B * T, fe.frame_len),
                 *(dense_cs(fe) if dense else (None, None)), fe.mel, fe.dct,
                 fe.floor, fe.acorr), B, T)
    return ((fr.reshape(B * T, fe.frame_len).contiguous(), fe.D, fe.W,
             fe.dct, fe.floor, fe.A), B, T)


def frames_kernel(fe, dense=True):
    """(kernel wrapper, {name: plain version}, launch counter name) of fe;
    all take frames_args' arguments (the dense plain version only with
    `dense`, and the packed frontend's none from N = 32768 on)."""
    big = fe.n_fft >= gpu_frontend.BIG_N and fe.n_fft & (fe.n_fft - 1) == 0
    if isinstance(fe, FullFrontend):
        n = fe.n_fft
        plains = {"fft": lambda wp, C, S, mel, dct, floor, ac:
                  gpu_frontend.mfcc_from_frames_fft_reference(
                      wp, mel, dct, floor, ac, n)}
        if dense:
            plains["dense"] = gpu_frontend.mfcc_from_frames_reference
        chirp = gpu_frontend.chirp_size(n, fe.frame_len)
        if chirp:
            plains["chirp"] = lambda wp, C, S, mel, dct, floor, ac: \
                gpu_frontend.mfcc_from_frames_chirp_reference(
                    wp, mel, dct, floor, ac, n)
        return (lambda *a: gpu_frontend.mfcc_from_frames(*a, n), plains,
                "FULL_BIG_LAUNCHES" if big else "FULL_LAUNCHES"
                if n & (n - 1) == 0 else "FULL_CHIRP_LAUNCHES" if chirp
                else "FULL_DENSE_LAUNCHES")
    plains = {"fft": lambda frames, D, W, dct, floor, A:
              gpu_frontend.packed_from_frames_fft_reference(
                  frames, fe.fft, dct, floor)}
    if dense and fe.D is not None:
        plains["dense"] = gpu_frontend.packed_from_frames_reference
    return (lambda *a: gpu_frontend.packed_from_frames(*a, fft=fe.fft),
            plains, "FRAMES_BIG_LAUNCHES" if big else "FRAMES_LAUNCHES")


def check_frames(phase, name, fe, sig, lengths, dense=True) -> float:
    """A frame-level kernel vs its plain versions on one batch, all carried
    through the frontend's CMVN, LPC or LPC cepstra and masking, and two
    calls bitwise; returns the max abs error of the features."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the plain versions must run full f32 matmuls")
    kernel, plains, counter = frames_kernel(fe, dense)
    args, B, T = frames_args(fe, sig, dense)
    mask = framing.frame_validity_mask(lengths, T, fe.frame_len,
                                       fe.frame_shift)
    before = getattr(gpu_frontend, counter)
    got_c, got_r = kernel(*args)
    again_c, again_r = kernel(*args)
    launched = getattr(gpu_frontend, counter) - before
    torch.cuda.synchronize()
    got, m = fe.finish(got_c.view(B, T, -1), got_r.view(B, T, -1), mask)
    bitwise = torch.equal(got_c, again_c) and torch.equal(got_r, again_r)
    if not torch.isfinite(got).all() or (got[~m] != 0).any():
        raise AssertionError(f"{name}: non-finite or unmasked features")
    err = 0.0
    for plain, fn in plains.items():
        want_c, want_r = fn(*args)
        want, _ = fe.finish(want_c.view(B, T, -1), want_r.view(B, T, -1),
                            mask)
        d_mfcc, d_lpc, lpc_bad = feature_errors(got, want, m,
                                                fe.dct.shape[1])
        print(f"phase {phase} {name} vs {plain} plain: {type(fe).__name__} "
              f"frames {tuple(args[0].shape)} valid {int(m.sum())} mfcc "
              f"max|d| {d_mfcc:.3e} (tol {MFCC_ATOL}) lpc max|d| "
              f"{d_lpc:.3e} (over tol: {lpc_bad}) launches {launched} "
              f"({counter}) bitwise {bitwise}", flush=True)
        if d_mfcc > MFCC_ATOL or lpc_bad or launched != 2 or not bitwise:
            raise AssertionError(f"{name}: frame-level kernel disagrees "
                                 f"with the {plain} plain version")
        err = max(err, d_mfcc, d_lpc)
    return err


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS,
          bf16_flops: float = 0.0, tf32_flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the FLOPs over the
    peak of their type (FP32 outside the tensor cores unless `peak` says
    otherwise; `bf16_flops` and `tf32_flops` more at the tensor cores' bf16
    and TF32 peaks, which run beside the FP32 pipes, so the slowest of them
    sets the time) and the bytes over the memory rate."""
    ops_ms = max(flops / peak, bf16_flops / BF16_FLOPS,
                 tf32_flops / TF32_FLOPS) * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    if ops_ms >= bytes_ms:
        return {"bound_ms": ops_ms, "bound_by": "operations"}
    return {"bound_ms": bytes_ms, "bound_by": "bytes"}


def frontend_flops(frames: int, n_fft: int, ops, nceps: int,
                   order: int = 0, window: int = 0) -> float:
    """The least FLOPs of a frontend function for `frames` frames, whatever
    implements it: `window` per frame for window and pre-emphasis, a real
    FFT of n_fft points (2.5 N log2 N), the power of its N/2 + 1 bins, two
    per nonzero of the bin-domain operators `ops` ([mel, autocorrelation],
    rows 0..N/2), the log of each mel energy, the DCT and an order-p
    Levinson recursion."""
    nb = n_fft // 2 + 1
    nmel = ops[0].shape[1]
    return (frames * (window + 2.5 * n_fft * math.log2(n_fft) + 3 * nb
                      + nmel + 2 * nmel * nceps + 2 * order * order)
            + projection_flops(frames, n_fft, ops))


def projection_flops(frames: int, n_fft: int, ops) -> float:
    """Two FLOPs per nonzero of the bin-domain operators `ops` (rows
    0..N/2) for each of `frames` frames: the power-to-[mel | acorr]
    product inside `frontend_flops`."""
    nb = n_fft // 2 + 1
    return frames * 2 * sum(int((op[:nb] != 0).sum()) for op in ops)


def score_flops(frames: int, d: int, n_components: int) -> float:
    """FLOPs of [x^2 | x] . op for `frames` frames against the components."""
    return frames * 4 * d * n_components


def fused_args(fe: PackedFrontend, sig, lengths, bank, n_valid=None):
    """The arguments of gpu_predict.fused_bank_predict for one batch."""
    if n_valid is None:
        T = n_frames(sig.shape[1], fe.frame_len, fe.frame_shift)
        n_valid = fe.valid_frames(lengths, T)
    return (sig, n_valid, bank, fe.frame_shift, fe.D, fe.W, fe.dct, fe.floor,
            fe.A, fe.cmvn)


def check_fused(name, got, want, phase=13) -> float:
    """Monolith (or predict_scores) scores vs plain ones: within
    FUSED_RTOL, identical argmax; returns the max abs error."""
    torch.cuda.synchronize()
    d = (got - want).abs()
    rel = (d / want.abs().clamp_min(1e-30)).max().item()
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    print(f"phase {phase} {name}: [B, S] {tuple(got.shape)} max|d| "
          f"{d.max().item():.3e} max rel {rel:.3e} (tol {FUSED_RTOL}) argmax "
          f"identical {same}", flush=True)
    if (got.shape != want.shape or not torch.isfinite(got).all()
            or rel > FUSED_RTOL or not same):
        raise AssertionError(f"{name}: fused predict disagrees with plain")
    return d.max().item()


def fused_plain(fe: PackedFrontend, args) -> torch.Tensor:
    """The FFT route's plain monolith on fused_args' arguments: what the f32
    kernel computes."""
    sig, n_valid, bank, fshift, _, _, dct, floor, _, cmvn = args
    return gpu_predict.fused_bank_predict_fft_reference(
        sig, n_valid, bank, fshift, dct, floor, fe.fft, cmvn)


def check_fused_case(name, fe: PackedFrontend, args) -> tuple[float, float]:
    """Both f32 wrappers (one kernel, on the FFT tile) vs the FFT route's
    plain monolith on one batch, each twice (bitwise equal) and counted;
    their max abs errors."""
    want = fused_plain(fe, args)
    before = (gpu_predict.LAUNCHES, gpu_predict.WIDE_LAUNCHES)
    k6, k6b, k7, k7b = (fn(*args, fft=fe.fft) for fn in (
        gpu_predict.fused_bank_predict, gpu_predict.fused_bank_predict,
        gpu_predict.fused_bank_predict_wide,
        gpu_predict.fused_bank_predict_wide))
    torch.cuda.synchronize()
    launched = (gpu_predict.LAUNCHES - before[0],
                gpu_predict.WIDE_LAUNCHES - before[1])
    bitwise = torch.equal(k6, k6b) and torch.equal(k7, k7b)
    print(f"phase 13 {name}: launches (K6, K7) {launched}, two calls bitwise "
          f"equal: {bitwise}", flush=True)
    if launched != (2, 2) or not bitwise:
        raise AssertionError(f"{name}: fused predict launches {launched}, "
                             f"bitwise {bitwise}")
    return (check_fused(name, k6, want),
            check_fused(name + " (wide)", k7, want))


def phase13_lifted(rng, dev, card, bench_bank) -> list:
    """13, the monolith's lifted f32 limits, at phase 16's shapes: N = 32768
    (384 kHz, BIG384_B x 5 s; the four-step route on one block,
    BIG_LAUNCHES), N = 65536 (384 kHz frames of 64 ms, 2 x 1 s; a cluster
    of 2) and 616 outputs (WIDE616, 64 x 5 s at 8 kHz; chunks of 512 on the
    tile, CHUNKED_LAUNCHES). Each, through both wrappers, against its plain
    version and predict_scores (K1's route there + K2) on the same argmax,
    two calls bitwise, counted and timed beside K1 + K2; at 616 outputs the
    first 512 keep their bits inside the larger call. Returns the entries
    of the kernels' line."""
    entries = []
    L384, L8 = int(FS384 * HIGH_SEC), int(BENCH_FS * BENCH_SEC)
    s384, l384 = signals_batch(
        rng, [L384 - int(rng.randint(0, L384 // 2))
              for _ in range(BIG384_B - 1)] + [L384], padded(L384), dev)
    s616, l616 = signals_batch(
        rng, [L8 - int(rng.randint(0, L8 // 2)) for _ in range(63)] + [L8],
        padded(L8), dev)
    L65 = int(FS384 * HIGH_SEC / 5)
    s65, l65 = signals_batch(rng, [L65, L65 * 2 // 3], padded(L65), dev)
    SK = bench_bank.n_speakers * bench_bank.n_mixtures
    for key, fs, cfg, sig, lens, route in (
            ("n32768", FS384, BIG384, s384, l384, "BIG_LAUNCHES"),
            ("n65536", FS384, BIG65536, s65, l65, "BIG_LAUNCHES"),
            ("616_outputs", BENCH_FS, WIDE616, s616, l616,
             "CHUNKED_LAUNCHES")):
        fe = PackedFrontend(fs, cfg, dev)
        args = fused_args(fe, sig, lens, bench_bank)
        nm = (f"K6/K7 {fs / 1000:g} kHz, n_fft {fe.n_fft}, "
              f"{fe.fft_mel.shape[1]} mel + {fe.fft_acorr.shape[1]} lags, "
              f"{sig.shape[0]} x {float(lens.max()) / fs:g} s")
        counters = ("LAUNCHES", "WIDE_LAUNCHES", "BIG_LAUNCHES",
                    "CHUNKED_LAUNCHES")
        for c in counters:
            setattr(gpu_predict, c, 0)
        k6 = gpu_predict.fused_bank_predict(*args, fft=fe.fft)
        torch.cuda.synchronize()
        drive = {c: getattr(gpu_predict, c) for c in counters}
        k6b, k7, k7b = (fn(*args, fft=fe.fft) for fn in (
            gpu_predict.fused_bank_predict,
            gpu_predict.fused_bank_predict_wide,
            gpu_predict.fused_bank_predict_wide))
        torch.cuda.synchronize()
        launched = {c: getattr(gpu_predict, c) for c in counters}
        want_counts = ({"LAUNCHES": 0, "WIDE_LAUNCHES": 0, "BIG_LAUNCHES": 4,
                        "CHUNKED_LAUNCHES": 0} if route == "BIG_LAUNCHES"
                       else {"LAUNCHES": 2, "WIDE_LAUNCHES": 2,
                             "BIG_LAUNCHES": 0, "CHUNKED_LAUNCHES": 4})
        bitwise = torch.equal(k6, k6b) and torch.equal(k7, k7b)
        print(f"phase 13 {nm}: launches {launched}, two calls bitwise equal "
              f"{bitwise}", flush=True)
        # (the CPU's plain versions need not repeat their bits: a property
        # of the kernels)
        if launched != want_counts or (dev.type == "cuda" and not bitwise):
            raise AssertionError(f"{nm}: launches {launched}, bitwise "
                                 f"{bitwise}")
        err = check_fused(nm + " vs its plain version", k6,
                          fused_plain(fe, args))
        err = max(err, check_fused(nm + " (wide) vs its plain version", k7,
                                   fused_plain(fe, args)))
        check_fused(nm + " vs predict_scores (K1 + K2)", k6,
                    fastpath.predict_scores(sig, lens, bench_bank, fs, cfg))
        tt_fns = {
            "fused": lambda: gpu_predict.fused_bank_predict(*args,
                                                            fft=fe.fft),
            "plain": lambda: fused_plain(fe, args),
            "predict": lambda: fastpath.predict_scores(sig, lens, bench_bank,
                                                       fs, cfg)}
        tt = time_interleaved(tt_fns)
        T = n_frames(sig.shape[1], fe.frame_len, fe.frame_shift)
        valid = int(args[1].sum())
        nceps = fe.dct.shape[1]
        nac = fe.fft_acorr.shape[1]
        b = bound(frontend_flops(valid, fe.n_fft, (fe.fft_mel, fe.fft_acorr),
                                 nceps, order=nac - 1,
                                 window=3 * fe.frame_len)
                  + score_flops(valid, bench_bank.dim, SK),
                  4 * sig.numel() + 4 * sig.shape[0]
                  + 4 * sum(x.numel() for x in (fe.fft_mel, fe.fft_acorr,
                                                fe.dct, fe.window))
                  + 4 * (bench_bank.op.numel() + bench_bank.cw.numel())
                  + 4 * sig.shape[0] * bench_bank.n_speakers)
        print(f"phase 13 [{card}] {nm} ({T} frames a row): monolith "
              f"{tt['fused']:.3f} ms, predict_scores (K1 + K2) "
              f"{tt['predict']:.3f} ms in the same trials, its plain version "
              f"{tt['plain']:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); device ms a call by kernel "
              f"{kernel_times(tt_fns['fused'])}", flush=True)
        entries.append((f"fused_bank_predict_{key}",
                        "predict_fused_big.cu" if route == "BIG_LAUNCHES"
                        else "predict_fused.cuh", "pallas_predict.py:91",
                        drive[route], err, tt["fused"], tt["plain"], b))
        del args, k6, k6b, k7, k7b
        torch.cuda.empty_cache()

    # at most 512 outputs keep their bits inside a larger call: 512 mel
    # filters, then the same with 104 more whose DCT rows are zero (an
    # exact zero added to each cepstrum), MFCC only, so the scores agree
    # bitwise when each output's FMA order does not depend on the count
    fe = PackedFrontend(BENCH_FS, dataclasses.replace(WIDE616, use_lpc=False),
                        dev)
    mel = fe.fft_mel
    r512 = fe.fft._replace(mel=mel[:, :512].contiguous())
    r616 = fe.fft._replace(mel=torch.cat([mel[:, :512], mel[:, 496:]],
                                         dim=1).contiguous())
    dct512 = torch.from_numpy(operators.dct_matrix(512)[1:14].T.astype(
        np.float32)).to(dev).contiguous()
    dct616 = torch.cat([dct512, dct512.new_zeros(104, 13)]).contiguous()
    bank13 = random_bank(rng, 4, 32, 13, dev)
    T = n_frames(s616.shape[1], fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(l616, T)
    a = (s616, nv, bank13, fe.frame_shift, None, None)
    gpu_predict.CHUNKED_LAUNCHES = 0
    c512 = gpu_predict.fused_bank_predict(*a, dct512, fe.floor, None,
                                          fft=r512)
    c616 = gpu_predict.fused_bank_predict(*a, dct616, fe.floor, None,
                                          fft=r616)
    torch.cuda.synchronize()
    inside = torch.equal(c512, c616) and gpu_predict.CHUNKED_LAUNCHES == 1
    print(f"phase 13 K6, 8 kHz 200 ms frames: 512 outputs' scores bitwise "
          f"equal inside 616 (104 more filters, zero DCT rows): {inside}",
          flush=True)
    if dev.type == "cuda" and not inside:
        raise AssertionError("the monolith's outputs depend on the output "
                             "count")
    del s384, l384, s616, l616, s65, l65
    torch.cuda.empty_cache()
    return entries


def time_interleaved(fns: dict, trials=7, reps=3) -> dict:
    """Median per-call device time of each fn, the fns taking turns in
    every trial."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(trials):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return {k: float(np.median(v)) for k, v in times.items()}


def wav_bytes(sig: np.ndarray, fs: int) -> bytes:
    """int16 mono wav bytes, as a browser posts them to the GUI."""
    buf = io.BytesIO()
    wavfile.write(buf, fs, np.asarray(sig, np.int16))
    return buf.getvalue()


def http(base: str, path: str, body: bytes | None = None) -> dict:
    """GET (no body) or POST `path` on the GUI server; its JSON, or raise
    on an error status."""
    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{path}: {e.code} {e.read()[:500]!r}") from e


@contextlib.contextmanager
def plain_calls():
    """{name: calls} of every kernel's plain version (the `*_reference`
    functions the wrappers run on CPU tensors) while the block runs."""
    calls = {}
    saved = []
    for mod in (gpu_frontend, gpu_gmm, gpu_predict):
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_reference") and callable(fn)):
                continue

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def blobs(rng, n_clusters: int, per: int, d: int, spread=0.3, scale=5.0):
    """Well-separated Gaussian blobs [n_clusters * per, d] (float64)."""
    mu = rng.randn(n_clusters, d) * scale
    return np.concatenate([m + spread * rng.randn(per, d) for m in mu])


SEEDING_STAGES = ("rounds + seed buffer + claim weights",
                  "weighted k-means++ recluster", "Lloyd's on the seeds",
                  "Lloyd's on the data")


def seeding_stages(fn, trials=7) -> dict:
    """{stage: median device ms} of one kmeans.kmeansii_device call fn(),
    warm, from CUDA events recorded around fn() and at the entry and exit
    of kmeans._pp_seed and of both kmeans.lloyd calls (SEEDING_STAGES in
    order; the host syncs inside a stage count in its time)."""
    saved = {name: getattr(kmeans, name) for name in ("_pp_seed", "lloyd")}
    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def marked(f):
        def call(*a, **kw):
            mark()
            out = f(*a, **kw)
            mark()
            return out
        return call

    fn()
    torch.cuda.synchronize()
    times = {k: [] for k in SEEDING_STAGES}
    for name, f in saved.items():
        setattr(kmeans, name, marked(f))
    try:
        for _ in range(trials):
            marks.clear()
            mark()
            fn()
            mark()
            marks[-1].synchronize()
            # start, _pp_seed in/out, lloyd in/out (seeds), in/out (data), end
            if len(marks) != 8:
                raise AssertionError(f"kmeansii_device made {len(marks)} "
                                     "marks, not 8")
            for k, (i, j) in zip(SEEDING_STAGES,
                                 ((0, 1), (1, 2), (3, 4), (5, 6))):
                times[k].append(marks[i].elapsed_time(marks[j]))
    finally:
        for name, f in saved.items():
            setattr(kmeans, name, f)
    return {k: float(np.median(v)) for k, v in times.items()}


FRONTEND_COUNTERS = ("LAUNCHES", "FRAMES_LAUNCHES", "FULL_LAUNCHES",
                     "FULL_SIGNAL_LAUNCHES", "LPCC_SIGNAL_LAUNCHES",
                     "FULL_CHIRP_LAUNCHES",
                     "FULL_DENSE_LAUNCHES",
                     "BIG_LAUNCHES", "FRAMES_BIG_LAUNCHES",
                     "FULL_BIG_LAUNCHES", "CHUNKED_LAUNCHES",
                     "BIG_PASSES_LAUNCHES")


def reset_frontend_counts():
    for name in FRONTEND_COUNTERS:
        setattr(gpu_frontend, name, 0)


def frontend_counts() -> dict:
    return {k: getattr(gpu_frontend, k) for k in FRONTEND_COUNTERS}


def drive_extract(name, fs, cfg, sig, lengths, want: dict,
                  full: bool = False, phase: int = 16) -> dict:
    """One extract_batch call on the card (SRTPU_FRONTEND=full when
    `full`), the frontend counters set to 0 just before and read just
    after; raises unless they are `want` (the others 0)."""
    if full:
        os.environ["SRTPU_FRONTEND"] = "full"
    try:
        fe = extract.frontend(fs, cfg, sig.device)
        reset_frontend_counts()
        feat, mask = extract.extract_batch(sig, lengths, fs, cfg)
        torch.cuda.synchronize()
        got = frontend_counts()
    finally:
        os.environ.pop("SRTPU_FRONTEND", None)
    expect = {k: want.get(k, 0) for k in got}
    ok = (got == expect and torch.isfinite(feat).all()
          and bool((feat[~mask] == 0).all()))
    print(f"phase {phase} {name} through extract_batch ({type(fe).__name__}, "
          f"n_fft {fe.n_fft}): features {tuple(feat.shape)}, launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    if not ok:
        raise AssertionError(f"{name}: extract_batch launched {got}, "
                             f"expected {expect}, or bad features")
    return got


def check_dense(phase, name, fe, sig, lengths) -> float:
    """The dense template called directly (mfcc_from_frames_dense) on a
    full-spectrum frontend's frames vs its dense plain version, both
    carried through the frontend's CMVN and LPC, and two calls bitwise;
    returns the max abs error of the features."""
    args, B, T = frames_args(fe, sig)
    mask = framing.frame_validity_mask(lengths, T, fe.frame_len,
                                       fe.frame_shift)
    got_c, got_r = gpu_frontend.mfcc_from_frames_dense(*args)
    again_c, again_r = gpu_frontend.mfcc_from_frames_dense(*args)
    torch.cuda.synchronize()
    bitwise = torch.equal(got_c, again_c) and torch.equal(got_r, again_r)
    want_c, want_r = gpu_frontend.mfcc_from_frames_reference(*args)
    got, m = fe.finish(got_c.view(B, T, -1), got_r.view(B, T, -1), mask)
    want, _ = fe.finish(want_c.view(B, T, -1), want_r.view(B, T, -1), mask)
    d_mfcc, d_lpc, lpc_bad = feature_errors(got, want, m, fe.dct.shape[1])
    print(f"phase {phase} dense kernel (direct), {name} vs the dense plain "
          f"version: mfcc max|d| {d_mfcc:.3e} (tol {MFCC_ATOL}) lpc max|d| "
          f"{d_lpc:.3e} (over tol: {lpc_bad}) bitwise {bitwise}", flush=True)
    if d_mfcc > MFCC_ATOL or lpc_bad or not bitwise:
        raise AssertionError(f"the dense kernel disagrees with its plain "
                             f"version at {name}")
    return max(d_mfcc, d_lpc)


def frames_work(fe, n_frames_: int, nbytes_in: int) -> dict:
    """The bound of a frame-level frontend function over n frames."""
    nmel, nceps = fe.dct.shape
    mel, ac = ((fe.mel, fe.acorr) if isinstance(fe, FullFrontend)
               else (fe.fft_mel, fe.fft_acorr))
    flops = frontend_flops(n_frames_, fe.n_fft, (mel, ac), nceps)
    return bound(flops, nbytes_in + 4 * n_frames_ * (nceps + ac.shape[1])
                 + 4 * sum(x.numel() for x in (mel, ac, fe.dct)))


def fused_split(nfc: int, nbins: int, dev) -> str:
    """S, the bin ranges the four-step route's fused pass splits a chunk of
    nfc frames of nbins bins into, as the library states the rule
    (srt_big_ranges: csrc/rfft_big.cuh rfft_big::ranges); the CPU builds no
    library."""
    if dev.type != "cuda":
        return "not built (CPU)"
    return str(_build.load().srt_big_ranges(nfc, nbins))


def check_column_pass(dev, rng, card, n: int) -> float:
    """K5 at n points past the cluster's reach on 62 frames of 1536 samples
    (48 kHz, 2 x 24,576 samples), which hold more values than a row of the
    passes' matrix, so that the column pass runs (the 8 kHz frames' row
    pass loads them itself); held to the FFT route's plain version, two
    calls bitwise, then timed beside it, cuFFT's rfft and the bound. On
    the card only: the dense plain version there, and any plain version on
    the CPU, would take C and S of 1536 x (n/2 + 1) points (3.2 GB at
    524288)."""
    L = 24576
    name = (f"K5 48 kHz, fft_size {n}, 2 x {L / FS48:g} s (the "
            "device-memory passes with their column pass)")
    if dev.type != "cuda":
        print(f"phase 16 {name}: on the card only", flush=True)
        return 0.0
    sig, lens = signals_batch(rng, [L, L * 2 // 3], padded(L), dev)
    fe = FullFrontend(FS48, FeatureConfig(mfcc=MfccConfig(fft_size=n)), dev)
    if (fe.frame_len + 1) // 2 <= gpu_frontend.passes_shape(n // 2)[1]:
        raise AssertionError(f"{name}: the frames fit a row")
    before = gpu_frontend.BIG_PASSES_LAUNCHES
    err = check_frames(16, name, fe, sig, lens, dense=False)
    if gpu_frontend.BIG_PASSES_LAUNCHES - before != 2:
        raise AssertionError(f"{name}: not on the device-memory passes")
    fargs, B, T = frames_args(fe, sig, dense=False)
    kern, plains, _ = frames_kernel(fe, dense=False)
    t = time_interleaved({
        "kernel": lambda: kern(*fargs),
        "plain": lambda: plains["fft"](*fargs),
        "rfft": lambda: torch.fft.rfft(fargs[0], n=n)}, *SMALL_TRIALS)
    b = frames_work(fe, B * T, 4 * fargs[0].numel())
    print(f"phase 16 [{card}] {name}: {t['kernel']:.3f} ms, plain "
          f"{t['plain']:.3f} ms, cuFFT's torch.fft.rfft(frames, n={n}) "
          f"alone {t['rfft']:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); the fused pass split in S "
          f"{fused_split(B * T, n // 2 + 1, dev)} over {B * T} frames; "
          f"device ms a call by kernel (stages) "
          f"{kernel_times(lambda: kern(*fargs))}", flush=True)
    return err


def extract_vs_dense(phase, name, fe, cfg, sig, lengths,
                     counter) -> tuple[int, float]:
    """extract_batch on the full route (fe: its FullFrontend for cfg at
    the bench rate), the frontend counters set to 0 just before and read
    just after (`counter` once, the others 0), its features held to the
    dense plain version's through the frontend's CMVN and LPC. Returns
    (the counter's launches, the max abs error)."""
    args, B, T = frames_args(fe, sig)
    mask = framing.frame_validity_mask(lengths, T, fe.frame_len,
                                       fe.frame_shift)
    want_c, want_r = gpu_frontend.mfcc_from_frames_reference(*args)
    want, wmask = fe.finish(want_c.view(B, T, -1), want_r.view(B, T, -1),
                            mask)
    del args, want_c, want_r
    os.environ["SRTPU_FRONTEND"] = "full"
    try:
        reset_frontend_counts()
        feats, fmask = extract.extract_batch(sig, lengths, BENCH_FS, cfg)
        torch.cuda.synchronize()
        counts = frontend_counts()
    finally:
        os.environ.pop("SRTPU_FRONTEND", None)
    d_mfcc, d_lpc, lpc_bad = feature_errors(feats, want, wmask,
                                            fe.dct.shape[1])
    print(f"phase {phase} extract_batch @ {name}: features "
          f"{tuple(feats.shape)} vs the dense plain version: mfcc max|d| "
          f"{d_mfcc:.3e} (tol {MFCC_ATOL}) lpc max|d| {d_lpc:.3e} (over tol: "
          f"{lpc_bad}), launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    if (counts != {k: int(k == counter) for k in counts}
            or feats.shape != want.shape or not torch.equal(fmask, wmask)
            or not torch.isfinite(feats).all()
            or d_mfcc > MFCC_ATOL or lpc_bad):
        raise AssertionError(f"extract_batch at {name} did not launch "
                             f"{counter} once and nothing else, or "
                             "disagrees with the dense plain version")
    return counts[counter], max(d_mfcc, d_lpc)


def phase16(rng, dev, card, bench_sig, bench_len) -> tuple[list, list]:
    """16. The FFT tile's lifted limits and the bf16 route's: K1, K4, K5 on
    the four-step route of N >= 32768 (a frame's spectrum on one block at
    32768 points, on a cluster of 2 at 65536 and of 8 at 262144; past it
    the device-memory passes), past 512 outputs on the tile, and K6's bf16
    route past 128 outputs and for long frames; each against its plain
    version, two calls bitwise, counted and timed. Returns the kernels'
    entries, and those of the four-step route's other sizes."""
    entries, routes = [], []
    L384 = int(FS384 * HIGH_SEC)
    s384, l384 = signals_batch(
        rng, [L384 - int(rng.randint(0, L384 // 2))
              for _ in range(BIG384_B - 1)] + [L384], padded(L384), dev)
    fe384 = PackedFrontend(FS384, BIG384, dev)
    if fe384.n_fft != 32768 or fe384.D is not None:
        raise AssertionError("384 kHz frames did not take a 32768-point FFT")
    name = (f"384 kHz, fft_size 32768, {BIG384_B} x {HIGH_SEC:g} s (flen "
            f"{fe384.frame_len}, n_fft 32768, four-step route)")
    args = frontend_args(fe384, s384, l384)
    err = check_frontend(name, fe384, s384, l384, phase=16)
    got384 = drive_extract("K1 384 kHz", FS384, BIG384, s384, l384,
                           {"BIG_LAUNCHES": 1})
    T384 = n_frames(s384.shape[1], fe384.frame_len, fe384.frame_shift)
    valid = int(args[1].sum())
    nmel, nceps = fe384.dct.shape
    nac = fe384.fft_acorr.shape[1]
    def k384():
        return gpu_frontend.packed_from_signals(*args, fft=fe384.fft)
    times = time_interleaved({
        "kernel": k384,
        "plain": lambda: gpu_frontend.packed_from_signals_fft_reference(
            s384, args[1], fe384.fft, fe384.dct, fe384.floor,
            fe384.frame_shift, fe384.cmvn)})
    b = bound(frontend_flops(valid, 32768, (fe384.fft_mel, fe384.fft_acorr),
                             nceps, order=nac - 1,
                             window=3 * fe384.frame_len),
              4 * s384.numel() + 4 * s384.shape[0] * T384 * (nceps + nac - 1)
              + 4 * sum(x.numel() for x in (fe384.fft_mel, fe384.fft_acorr,
                                            fe384.dct, fe384.window)))
    print(f"phase 16 [{card}] K1 four-step route, {name}: {times['kernel']:.3f}"
          f" ms, its plain version {times['plain']:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); device ms a call by "
          f"kernel {kernel_times(k384)}", flush=True)
    entries.append(("packed_frontend_n32768", "frontend.cu",
                    "pallas_frontend.py:231", got384["BIG_LAUNCHES"], err,
                    times["kernel"], times["plain"], b))

    # K4 on the four-step route (off the main path: the drive above
    # launched it got384["FRAMES_BIG_LAUNCHES"] = 0 times): the frames of the same batch
    err = check_frames(16, "K4 " + name, fe384, s384, l384)
    fargs, B_, T_ = frames_args(fe384, s384)
    kern, plains, _ = frames_kernel(fe384)
    times = time_interleaved({"kernel": lambda: kern(*fargs),
                              "plain": lambda: plains["fft"](*fargs)})
    b = frames_work(fe384, B_ * T_, 4 * fargs[0].numel())
    print(f"phase 16 [{card}] K4 four-step route: {times['kernel']:.3f} ms, "
          f"plain {times['plain']:.3f} ms, bound {b['bound_ms']:.4f} ms",
          flush=True)
    entries.append(("packed_from_frames_n32768", "frontend_frames_fft.cu",
                    "pallas_frontend.py:111", got384["FRAMES_BIG_LAUNCHES"],
                    err, times["kernel"], times["plain"], b))

    # K5 on the four-step route: 48 kHz with fft_size 32768 and 65536
    L48 = int(FS48 * HIGH_SEC)
    s48, l48 = signals_batch(
        rng, [L48 - int(rng.randint(0, L48 // 2))
              for _ in range(BIG_B // 8 - 1)] + [L48], padded(L48), dev)
    for n in FULL_BIG_FFTS:  # an entry each
        cfg = FeatureConfig(mfcc=MfccConfig(fft_size=n))
        fe = FullFrontend(FS48, cfg, dev)
        nm = (f"K5 48 kHz, fft_size {n}, {s48.shape[0]} x {HIGH_SEC:g} s "
              "(four-step route)")
        err5 = check_frames(16, nm, fe, s48, l48)
        launched5 = drive_extract(nm, FS48, cfg, s48, l48,
                                  {"FULL_BIG_LAUNCHES": 1},
                                  full=True)["FULL_BIG_LAUNCHES"]
        fargs, B_, T_ = frames_args(fe, s48)
        kern, plains, _ = frames_kernel(fe)
        # cuFFT's spectrum alone: the spectral stage's yardstick, not the
        # whole function
        t5 = time_interleaved({
            "kernel": lambda: kern(*fargs),
            "plain": lambda: plains["fft"](*fargs),
            "rfft": lambda: torch.fft.rfft(fargs[0], n=n)})
        b5 = frames_work(fe, B_ * T_, 4 * fargs[0].numel())
        print(f"phase 16 [{card}] {nm}: {t5['kernel']:.3f} ms, plain "
              f"{t5['plain']:.3f} ms, cuFFT's torch.fft.rfft(frames, n={n}) "
              f"alone {t5['rfft']:.3f} ms, bound {b5['bound_ms']:.4f} ms "
              f"({b5['bound_by']}); device ms a call by kernel "
              f"{kernel_times(lambda: kern(*fargs))}", flush=True)
        entries.append((f"mfcc_from_frames_n{n}", "frontend_big.cu",
                        "pallas_frontend.py:50", launched5, err5,
                        t5["kernel"], t5["plain"], b5))
        del fargs, fe
        torch.cuda.empty_cache()

    # the cluster at 65536 points on the packed route (K1 and K4: 384 kHz
    # frames of 64 ms, a cluster of 2 blocks), then K5 at 262144 points (8
    # blocks) and past the cluster's reach (524288: the device-memory
    # passes, counted in BIG_PASSES_LAUNCHES as well), a few frames each
    L65 = int(FS384 * HIGH_SEC / 5)
    s65, l65 = signals_batch(rng, [L65, L65 * 2 // 3], padded(L65), dev)
    fe65 = PackedFrontend(FS384, BIG65536, dev)
    if fe65.n_fft != 65536 or fe65.D is not None:
        raise AssertionError("64 ms frames at 384 kHz did not take a "
                             "65536-point FFT")
    nm65 = (f"384 kHz, 64 ms frames, fft_size 65536, {s65.shape[0]} x "
            f"{L65 / FS384:g} s (flen {fe65.frame_len}, a cluster of 2)")
    err65 = check_frontend("K1 " + nm65, fe65, s65, l65, phase=16)
    got65 = drive_extract("K1 " + nm65, FS384, BIG65536, s65, l65,
                          {"BIG_LAUNCHES": 1})
    err65 = max(err65, check_frames(16, "K4 " + nm65, fe65, s65, l65))
    args65 = frontend_args(fe65, s65, l65)
    t65 = time_interleaved({
        "kernel": lambda: gpu_frontend.packed_from_signals(*args65,
                                                           fft=fe65.fft),
        "plain": lambda: gpu_frontend.packed_from_signals_fft_reference(
            s65, args65[1], fe65.fft, fe65.dct, fe65.floor,
            fe65.frame_shift, fe65.cmvn)})
    T65 = n_frames(s65.shape[1], fe65.frame_len, fe65.frame_shift)
    nac65 = fe65.fft_acorr.shape[1]
    b65 = bound(frontend_flops(int(args65[1].sum()), 65536,
                               (fe65.fft_mel, fe65.fft_acorr), nceps,
                               order=nac65 - 1, window=3 * fe65.frame_len),
                4 * s65.numel() + 4 * s65.shape[0] * T65 * (nceps + nac65 - 1)
                + 4 * sum(x.numel() for x in (fe65.fft_mel, fe65.fft_acorr,
                                              fe65.dct, fe65.window)))
    print(f"phase 16 [{card}] K1 {nm65}: {t65['kernel']:.3f} ms, plain "
          f"{t65['plain']:.3f} ms, bound {b65['bound_ms']:.4f} ms "
          f"({b65['bound_by']})", flush=True)
    routes.append(("packed_frontend_n65536", "rfft_cluster.cu",
                   "pallas_frontend.py:231", got65["BIG_LAUNCHES"], err65,
                   t65["kernel"], t65["plain"], b65))
    del s65, l65, args65, fe65
    L8r = int(BENCH_FS * HIGH_SEC / 10)
    s8r, l8r = signals_batch(rng, [L8r, L8r * 2 // 3], padded(L8r), dev)
    for n in ROUTE_FFTS:
        cfg = FeatureConfig(mfcc=MfccConfig(fft_size=n))
        passes = n > gpu_frontend.CLUSTER_MAX_N
        nm = (f"K5 8 kHz, fft_size {n}, {s8r.shape[0]} x {L8r / BENCH_FS:g} "
              "s (" + ("the device-memory passes, past the cluster's reach)"
                       if passes else f"a cluster of {n // 32768})"))
        fe = FullFrontend(BENCH_FS, cfg, dev)
        err5 = check_frames(16, nm, fe, s8r, l8r)
        if passes:
            err5 = max(err5, check_column_pass(dev, rng, card, n))
        want = {"FULL_BIG_LAUNCHES": 1}
        if passes:
            want["BIG_PASSES_LAUNCHES"] = 1
        launched5 = drive_extract(nm, BENCH_FS, cfg, s8r, l8r, want,
                                  full=True)["FULL_BIG_LAUNCHES"]
        fargs, B_, T_ = frames_args(fe, s8r)
        kern, plains, _ = frames_kernel(fe)
        t5 = time_interleaved({
            "kernel": lambda: kern(*fargs),
            "plain": lambda: plains["fft"](*fargs),
            "rfft": lambda: torch.fft.rfft(fargs[0], n=n)}, *SMALL_TRIALS)
        b5 = frames_work(fe, B_ * T_, 4 * fargs[0].numel())
        # the fused pass's split over the bins for these few frames, in one
        # chunk
        S = fused_split(B_ * T_, n // 2 + 1, dev)
        if dev.type == "cuda" and gpu_frontend.big_chunk(
                _build.load(), n, fe.mel.shape[1] + fe.acorr.shape[1],
                B_ * T_) != B_ * T_:
            raise AssertionError(f"{nm}: more than one chunk")
        print(f"phase 16 [{card}] {nm}: {t5['kernel']:.3f} ms, plain "
              f"{t5['plain']:.3f} ms, cuFFT's torch.fft.rfft(frames, n={n}) "
              f"alone {t5['rfft']:.3f} ms, bound {b5['bound_ms']:.4f} ms "
              f"({b5['bound_by']}); the fused pass split in S {S} over "
              f"{B_ * T_} frames; device ms a call by kernel (stages) "
              f"{kernel_times(lambda: kern(*fargs))}", flush=True)
        routes.append((f"mfcc_from_frames_n{n}", "rfft_passes.cuh" if passes
                       else "rfft_cluster.cu", "pallas_frontend.py:50",
                       launched5, err5, t5["kernel"], t5["plain"], b5))
        del fargs, fe
        extract._frontend.cache_clear()
        torch.cuda.empty_cache()

    # past 512 outputs on the tile: 600 mel filters + LPC-15 (WIDE616: 616
    # outputs, two chunks of 512) on 64 bench utterances. K1 and K4 are
    # held to the FFT route's plain version and K1 to the float64 route
    # (the dense plain version at f64 on the card): the dense plain
    # version at f32 read 1.033e-3 from K1 on cepstra here on the card,
    # over MFCC_ATOL, and its distance to the float64 route is printed
    # beside K1's. (At 48 kHz with fft_size 4096, nine of 600 filters are
    # empty and others two bins wide, and the dense f32 route strays
    # further; tests/test_torch_limits.py holds the FFT route to the
    # float64 one there)
    s8w, l8w = bench_sig[:64].contiguous(), bench_len[:64].contiguous()
    fe616 = PackedFrontend(BENCH_FS, WIDE616, dev)
    nm = (f"8 kHz, 200 ms frames, fft_size 4096, 600 mel filters + LPC "
          f"(616 outputs), {s8w.shape[0]} x {BENCH_SEC:g} s")
    reset_frontend_counts()
    err1 = check_frontend("K1 " + nm, fe616, s8w, l8w, phase=16, dense=False)
    if gpu_frontend.CHUNKED_LAUNCHES != 2 or gpu_frontend.LAUNCHES != 2:
        raise AssertionError("616 outputs did not take the chunked tile")
    args = frontend_args(fe616, s8w, l8w)
    ref64, m64 = PackedFrontend(BENCH_FS, WIDE616, dev, torch.float64)(
        s8w, l8w)
    for which, feat in (
            ("K1", gpu_frontend.packed_from_signals(*args, fft=fe616.fft)),
            ("the dense plain version at f32",
             gpu_frontend.packed_from_signals_reference(*args))):
        d_mfcc, d_lpc, lpc_bad = feature_errors(feat.double(), ref64, m64,
                                                13)
        print(f"phase 16 {which} vs the float64 route, {nm}: mfcc max|d| "
              f"{d_mfcc:.3e} (tol {MFCC_ATOL}) lpc max|d| {d_lpc:.3e} (over "
              f"tol: {lpc_bad})", flush=True)
        if which == "K1" and (d_mfcc > MFCC_ATOL or lpc_bad):
            raise AssertionError(f"K1 {nm}: off the float64 route")
    del ref64, m64
    launched1 = drive_extract("K1 " + nm, BENCH_FS, WIDE616, s8w, l8w,
                              {"LAUNCHES": 1, "CHUNKED_LAUNCHES": 1})
    t1 = time_interleaved({
        "kernel": lambda: gpu_frontend.packed_from_signals(*args,
                                                           fft=fe616.fft),
        "plain": lambda: gpu_frontend.packed_from_signals_fft_reference(
            s8w, args[1], fe616.fft, fe616.dct, fe616.floor,
            fe616.frame_shift, fe616.cmvn)})
    T8w = n_frames(s8w.shape[1], fe616.frame_len, fe616.frame_shift)
    b1 = bound(frontend_flops(int(args[1].sum()), fe616.n_fft,
                              (fe616.fft_mel, fe616.fft_acorr), 13,
                              order=15, window=3 * fe616.frame_len),
               4 * s8w.numel() + 4 * s8w.shape[0] * T8w * 28
               + 4 * sum(x.numel() for x in (fe616.fft_mel, fe616.fft_acorr,
                                             fe616.dct)))
    print(f"phase 16 [{card}] K1 {nm}: {t1['kernel']:.3f} ms, plain "
          f"{t1['plain']:.3f} ms, bound {b1['bound_ms']:.4f} ms", flush=True)
    entries.append(("packed_frontend_616_outputs", "frontend.cu",
                    "pallas_frontend.py:231", launched1["LAUNCHES"], err1,
                    t1["kernel"], t1["plain"], b1))
    err4 = check_frames(16, "K4 " + nm, fe616, s8w, l8w, dense=False)
    fargs, B_, T_ = frames_args(fe616, s8w)
    kern, plains, _ = frames_kernel(fe616)
    t4 = time_interleaved({"kernel": lambda: kern(*fargs),
                           "plain": lambda: plains["fft"](*fargs)})
    entries.append(("packed_from_frames_616_outputs", "frontend_frames_fft.cu",
                    "pallas_frontend.py:111", launched1["FRAMES_LAUNCHES"],
                    err4, t4["kernel"], t4["plain"],
                    frames_work(fe616, B_ * T_, 4 * fargs[0].numel())))
    os.environ["SRTPU_FRONTEND"] = "full"
    try:
        fe616f = FullFrontend(BENCH_FS, WIDE616, dev)
    finally:
        os.environ.pop("SRTPU_FRONTEND")
    err5 = check_frames(16, "K5 " + nm, fe616f, s8w, l8w)
    # the full route at a power-of-two fft_size takes the kernel from the
    # signals (phase 22): the frame-level K5 has no serving caller there
    launched5 = drive_extract("K5 " + nm, BENCH_FS, WIDE616, s8w, l8w,
                              {"FULL_SIGNAL_LAUNCHES": 1,
                               "CHUNKED_LAUNCHES": 1}, full=True)
    fargs, B_, T_ = frames_args(fe616f, s8w)
    kern, plains, _ = frames_kernel(fe616f)
    t5 = time_interleaved({"kernel": lambda: kern(*fargs),
                           "plain": lambda: plains["fft"](*fargs)})
    entries.append(("mfcc_from_frames_616_outputs", "frontend_fft.cu",
                    "pallas_frontend.py:50", launched5["FULL_LAUNCHES"],
                    err5, t5["kernel"], t5["plain"],
                    frames_work(fe616f, B_ * T_, 4 * fargs[0].numel())))
    # at most 512 outputs keep their bits inside a larger call: 496 mel +
    # 16 lags, then the same with 104 more lags (one chunk more)
    route = fe616.fft._replace(mel=fe616.fft_mel[:, :496].contiguous())
    extra = torch.from_numpy(rng.rand(route.acorr.shape[0], 104).astype(
        np.float32)).to(dev) * route.acorr[:, :1]
    wide = route._replace(acorr=torch.cat([route.acorr, extra],
                                          dim=1).contiguous())
    dct496 = torch.from_numpy(operators.dct_matrix(496)[1:14].T.astype(
        np.float32)).to(dev).contiguous()
    a = (s8w, args[1], None, None, dct496, None, fe616.floor,
         fe616.frame_shift, True)
    c512, r512 = gpu_frontend.packed_from_signals(*a, fft=route,
                                                  fuse_lpc=False)
    c616, r616 = gpu_frontend.packed_from_signals(*a, fft=wide,
                                                  fuse_lpc=False)
    wp = framing.window_preemph(
        framing.frame_signal(s8w, fe616f.frame_len, fe616f.frame_shift),
        fe616f.frame_len, fe616f.pre_emph).reshape(-1, fe616f.frame_len)
    fa = (wp.contiguous(), *dense_cs(fe616f),
          fe616f.mel[:, :496].contiguous(), dct496, fe616.floor)
    ac16 = fe616f.acorr
    k512 = gpu_frontend.mfcc_from_frames(*fa, ac16, fe616f.n_fft)
    k616 = gpu_frontend.mfcc_from_frames(*fa, torch.cat(
        [ac16, extra[:ac16.shape[0]] if extra.shape[0] >= ac16.shape[0]
         else torch.nn.functional.pad(extra, (0, 0, 0, ac16.shape[0]
                                              - extra.shape[0]))],
        dim=1).contiguous(), fe616f.n_fft)
    torch.cuda.synchronize()
    parts = {"K1 cepstra": torch.equal(c512, c616),
             "K1 lags": torch.equal(r512, r616[..., :16]),
             "K5 cepstra": torch.equal(k512[0], k616[0]),
             "K5 lags": torch.equal(k512[1], k616[1][:, :16])}
    inside = all(parts.values())
    print(f"phase 16 K1 and K5: 512 outputs bitwise equal inside 616 "
          f"{parts}: {inside}", flush=True)
    # (a property of the kernels: the CPU's plain versions take the BLAS's
    # order, which depends on the product's width)
    if dev.type == "cuda" and not inside:
        raise AssertionError("the FFT tile's outputs depend on the output "
                             "count")
    del wp, fa, k512, k616, c512, c616, r512, r616, fargs
    torch.cuda.empty_cache()

    # K6's bf16 route past its old limits: 144 outputs at 8 kHz (two output
    # chunks; checked, counted and timed on the bench batch), 48 kHz frames
    # with fft_size 4096 and 96 kHz frames with fft_size 8192 (32-frame
    # tiles) and 192 kHz frames with fft_size 16384 (the samples from
    # device memory), each on the tile it claims
    bank = random_bank(rng, 4, 32, FeatureConfig().dim, dev)
    errb = 0.0
    for fs_b, cfg_b, claim in (
            (BENCH_FS, FeatureConfig(mfcc=MfccConfig(n_filters=128)),
             {"chunks": 2}),
            (FS48, FFT4096, {"ft": 32, "gseg": 0}),
            (FS96, FFT8192, {"ft": 32, "gseg": 0}),
            (FS192, FFT16384, {"ft": 32, "gseg": 1})):
        fe = PackedFrontend(fs_b, cfg_b, dev)
        if fs_b == BENCH_FS:
            sb, lb = bench_sig, bench_len
        else:
            Lb = int(fs_b * HIGH_SEC)
            sb, lb = signals_batch(rng, [Lb, Lb * 2 // 3, Lb // 3],
                                   padded(Lb), dev)
        fargs = fused_args(fe, sb, lb, bank)
        tile = gpu_predict.bf16_tile(fe.frame_len, fe.frame_shift,
                                     fe.dct.shape[0] + fe.A.shape[1],
                                     bank.dim)
        nm = (f"K6 bf16 {fs_b / 1e3:g} kHz, fft_size "
              f"{cfg_b.mfcc.fft_size}, {fe.dct.shape[0]} mel + "
              f"{fe.A.shape[1]} lags, flen {fe.frame_len}, {sb.shape[0]} x "
              f"{sb.shape[1] / fs_b:g} s, tile {tile}")
        # (the tile is csrc/packed_tile.cuh's pick, built on the card only)
        if dev.type == "cuda" and any(tile[k] != v for k, v in claim.items()):
            raise AssertionError(f"{nm}: not the tile {claim}")
        gpu_predict.BF16_LAUNCHES = 0
        got = gpu_predict.fused_bank_predict(*fargs, mm_bf16=True)
        torch.cuda.synchronize()
        launched = gpu_predict.BF16_LAUNCHES
        again = gpu_predict.fused_bank_predict(*fargs, mm_bf16=True)
        errb = max(errb, check_fused(nm, got, gpu_predict.
                                     fused_bank_predict_reference(
                                         *fargs, mm_bf16=True), phase=16))
        bitwise = torch.equal(got, again)
        print(f"phase 16 {nm}: launches {launched}, two calls bitwise "
              f"{bitwise}", flush=True)
        if launched != 1 or not bitwise:
            raise AssertionError(f"{nm}: launches {launched}, bitwise "
                                 f"{bitwise}")
        if fs_b == BENCH_FS:  # 144 outputs on the bench batch: the entry
            launched_b = launched
            tb = time_interleaved({
                "kernel": lambda: gpu_predict.fused_bank_predict(
                    *fargs, mm_bf16=True),
                "plain": lambda: gpu_predict.fused_bank_predict_reference(
                    *fargs, mm_bf16=True)})
            valid = int(fargs[1].sum())
            bb = bound(frontend_flops(valid, fe.n_fft, (fe.fft_mel,
                                                        fe.fft_acorr), 13,
                                      order=15, window=3 * fe.frame_len)
                       + score_flops(valid, FeatureConfig().dim, 4 * 32),
                       4 * sb.numel() + 4 * (bank.op.numel()
                                             + bank.cw.numel()))
            print(f"phase 16 [{card}] {nm}: {tb['kernel']:.3f} ms, plain "
                  f"{tb['plain']:.3f} ms, bound {bb['bound_ms']:.4f} ms "
                  f"({bb['bound_by']})", flush=True)
        del fargs, got, again
        torch.cuda.empty_cache()
    entries.append(("fused_bank_predict_bf16_lifted", "predict_fused.cuh",
                    "pallas_predict.py:91", launched_b, errb, tb["kernel"],
                    tb["plain"], bb))
    return entries, routes


def phase17(rng, dev, card, bench_sig, bench_len) -> dict:
    """17. float64 on the card: a session enrolled, MAP-adapted from a
    float64 UBM, predicted, decided open-set and calibrated at
    dtype="float64" on the card and on the CPU; their features, scores and
    decisions agree within F64_RTOL (normwise) with the same labels; the
    float64 counters move and K1, K2 and K3 do not; an f32 call in the
    same process still launches K1 and K2; f64 predict_scores at the bench
    batch beside f32."""
    fs = synth.FS
    exp = synth.expected()
    utts = synth.fixture_utterances(exp)
    impostors = [synth.voice_utterance(v, 3.0, 70 + i) for i, v in
                 enumerate(synth.voices(3, seed=17))]
    train = {label: [synth.synth_utterance(label, sec, base + i)
                     for sec, base in synth.TRAIN]
             for i, label in enumerate(synth.SPEAKER_FREQS)}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ubm = ubm_tools.train_ubm(
            [extract.mix_feature(fs, x, dtype="float64", device=dev)
             for xs in train.values() for x in xs], n_mixtures=16,
            n_iterations=50, dtype="float64", device=dev)
        ubm_path = os.path.join(tmp, "ubm.txt")
        with open(ubm_path, "w") as f:
            serialization.dump_reference_gmm(ubm, f)
        for where in (dev, torch.device("cpu")):
            for mod, names in ((gpu_frontend, ("LAUNCHES",)),
                               (gpu_gmm, ("LAUNCHES", "SERIAL_LAUNCHES",
                                          "F64_CALLS")),
                               (extract, ("F64_CALLS",))):
                for name in names:
                    setattr(mod, name, 0)
            m = ModelInterface(PipelineConfig(dtype="float64"), device=where)
            m.UBM_MODEL_FILE = ubm_path
            for label, xs in train.items():
                for x in xs:
                    m.enroll(label, fs, x)
            m.train()
            scores, valid = m.scores_batch(fs, utts)
            run = {"feats": np.concatenate([np.concatenate(v) for v in
                                            m.features.values()]),
                   "scores": scores, "labels": m.predict_batch(fs, utts),
                   "open": [m.predict_with_rejection(fs, u) for u in utts],
                   "cal": m.calibrate_rejection(fs, utts, impostors),
                   "counts": {"K1": gpu_frontend.LAUNCHES,
                              "K2": gpu_gmm.LAUNCHES,
                              "K3": gpu_gmm.SERIAL_LAUNCHES,
                              "extract_f64": extract.F64_CALLS,
                              "gmm_f64": gpu_gmm.F64_CALLS}}
            runs[where.type] = run
            print(f"phase 17 float64 on {where}: labels {run['labels']}, "
                  f"open set {run['open']}, threshold "
                  f"{run['cal']['threshold']:.6f}, counts {run['counts']}",
                  flush=True)
    card_run, cpu_run = runs[dev.type], runs["cpu"]
    errs = {k: float(np.abs(card_run[k] - cpu_run[k]).max()
                     / np.abs(cpu_run[k]).max()) for k in ("feats", "scores")}
    d_thr = abs(card_run["cal"]["threshold"] - cpu_run["cal"]["threshold"])
    errs["threshold"] = d_thr / abs(cpu_run["cal"]["threshold"])
    c = card_run["counts"]
    print(f"phase 17 float64 card vs CPU (normwise, tol {F64_RTOL}): "
          f"{errs}; labels equal "
          f"{card_run['labels'] == cpu_run['labels']}, open-set equal "
          f"{card_run['open'] == cpu_run['open']}", flush=True)
    if (max(errs.values()) > F64_RTOL
            or card_run["labels"] != cpu_run["labels"]
            or card_run["open"] != cpu_run["open"]
            or card_run["labels"] != [u["label"] for u in exp["utterances"]]
            or (dev.type == "cuda" and (c["K1"] or c["K2"] or c["K3"]))
            or not (c["extract_f64"] and c["gmm_f64"])):
        raise AssertionError("float64 on the card disagrees with the CPU, "
                             "or took a kernel")
    # an f32 call in the same process still takes the kernels
    gpu_frontend.LAUNCHES = gpu_gmm.LAUNCHES = 0
    m32 = ModelInterface.load(synth.SESSION, device=dev)
    if m32.predict_batch(fs, utts) != card_run["labels"] or min(
            gpu_frontend.LAUNCHES, gpu_gmm.LAUNCHES) < 1:
        raise AssertionError("f32 after f64 did not launch K1 and K2")
    print(f"phase 17 f32 after f64: launches K1 {gpu_frontend.LAUNCHES}, "
          f"K2 {gpu_gmm.LAUNCHES}", flush=True)
    # f64 predict_scores at the bench batch beside f32
    cfg = FeatureConfig()
    params = [a.astype(np.float32) for a in (
        np.full((4, 32), 1 / 32), rng.randn(4, 32, cfg.dim),
        0.5 + rng.rand(4, 32, cfg.dim))]
    b32 = GmmBank.from_numpy(*params, device=dev)
    b64 = GmmBank.from_numpy(*params, device=dev, dtype=torch.float64)
    s64 = bench_sig.to(torch.float64)
    t = time_interleaved({
        "f32": lambda: fastpath.predict_scores(bench_sig, bench_len, b32, fs,
                                               cfg),
        "f64": lambda: fastpath.predict_scores(s64, bench_len, b64, fs,
                                               cfg)}, trials=5, reps=1)
    print(f"phase 17 [{card}] predict_scores {tuple(bench_sig.shape)} @ 8 kHz"
          f": float64 {t['f64']:.3f} ms (plain versions), float32 "
          f"{t['f32']:.3f} ms (K1 + K2), ratio {t['f64'] / t['f32']:.1f}",
          flush=True)
    return t


def jfa_features(sigs, dev) -> list:
    """The default config's features of equal-length int16 signals, one
    extract_batch on `dev` (K1 on the card), trimmed to each one's valid
    frames."""
    x = np.stack(sigs).astype(np.float32)
    L = -(-x.shape[1] // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
    batch = np.zeros((len(sigs), L), np.float32)
    batch[:, :x.shape[1]] = x
    feats, mask = extract.extract_batch(
        torch.from_numpy(batch).to(dev),
        torch.full((len(sigs),), x.shape[1], device=dev), synth.FS)
    return [f[m].cpu().numpy() for f, m in zip(feats, mask)]


def jfa_corpus(ch_db: float, seed: int, dev) -> dict:
    """The r5 cell's corpus at one channel strength: background, enrollment
    and test sessions of the port's identity-structured voices, each
    session through its own channel (synth.apply_channel), as features."""
    fs = synth.FS
    nrng = np.random.RandomState(10_000 * seed + int(ch_db * 10))
    bg = synth.voices(JFA_BG, seed=1000 + seed)
    ev = synth.voices(JFA_EVAL, seed=2000 + seed)

    def session(v, sec, key):
        return synth.apply_channel(synth.voice_utterance(v, sec, key), fs,
                                   nrng, ch_db)
    bg_sig = [session(v, JFA_SEC, 100_000 + 10 * i + k)
              for i, v in enumerate(bg) for k in range(JFA_BG_SESSIONS)]
    en_sig = [session(v, JFA_SEC, 200_000 + 10 * i + k)
              for i, v in enumerate(ev) for k in range(JFA_ENROLL)]
    te_sig = [session(v, JFA_TEST_SEC, 300_000 + 100 * i + k)
              for i, v in enumerate(ev) for k in range(JFA_TESTS)]
    return {"bg": jfa_features(bg_sig, dev),
            "bg_ids": np.repeat(np.arange(JFA_BG), JFA_BG_SESSIONS),
            "en": jfa_features(en_sig, dev),
            "en_ids": np.repeat(np.arange(JFA_EVAL), JFA_ENROLL),
            "te": jfa_features(te_sig, dev),
            "truth": np.repeat(np.arange(JFA_EVAL), JFA_TESTS)}


def verification_eer(scores: np.ndarray, truth: np.ndarray) -> float:
    """EER of [n_models, n_test] scores: the true model's as genuine, every
    other as an impostor trial (experiments/jfa_channel.py)."""
    cols = np.arange(len(truth))
    impostor = np.ones_like(scores, bool)
    impostor[truth, cols] = False
    return metrics.eer(scores[truth, cols], scores[impostor])[0]


def wall(fn):
    """(fn()'s result, its host seconds, the card synchronized around)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase18(dev, card, seed: int = 0) -> dict:
    """18. JFA at the r5 cell's model shape on the card, at 0 and 6 dB
    channel strength: UBM, session stats, training (v, u, d), enrollment
    and linear scoring, with MAP (the UBM-adapted bank) beside it. The one
    gate: the card's JFA scores against the CPU's from the same stats and
    inits, both f32, within JFA_RTOL of the largest |score| with the same
    argmax. Accuracy, EER and the times are a report. Then the
    jfa_pipeline CLI (gen-features -> stats -> train -> score) on a small
    corpus, with K1's launches per gen-features utterance."""
    out = {}
    for ch_db in JFA_CHANNELS_DB:
        c = jfa_corpus(ch_db, seed, dev)
        ubm = ubm_tools.train_ubm(c["bg"], n_mixtures=JFA_K,
                                  n_iterations=JFA_UBM_ITERS, seed=seed,
                                  device=dev)
        (stats, t_stats) = wall(lambda: [
            jfa_pipeline.collect_session_stats(ubm, c[k], dev)
            for k in ("bg", "en", "te")])
        (N_bg, F_bg), (N_en, F_en), (N_te, F_te) = stats
        logs = {}
        model, t_train = wall(lambda: jfa_pipeline.train_jfa(
            ubm, N_bg, F_bg, c["bg_ids"], nv=JFA_NV, nu=JFA_NU,
            n_iter=JFA_ITERS, train_d=True, seed=seed, device=dev,
            log=logs.setdefault("card", {})))

        def enroll_score(mdl, where):
            y, z = jfa_pipeline.enroll(mdl, N_en.to(where), F_en.to(where),
                                       c["en_ids"], JFA_EVAL)
            return jfa_pipeline.score(mdl, y, z, N_te.to(where),
                                      F_te.to(where))
        s_card, t_score = wall(lambda: enroll_score(model, dev))
        cpu = torch.device("cpu")
        model_cpu = jfa_pipeline.train_jfa(
            ubm, N_bg.cpu(), F_bg.cpu(), c["bg_ids"], nv=JFA_NV, nu=JFA_NU,
            n_iter=JFA_ITERS, train_d=True, seed=seed, device=cpu,
            log=logs.setdefault("cpu", {}))
        s_cpu = enroll_score(model_cpu, cpu).numpy()
        s_card = s_card.cpu().numpy()
        rel = float(np.abs(s_card - s_cpu).max() / np.abs(s_cpu).max())
        same = bool((s_card.argmax(0) == s_cpu.argmax(0)).all())
        print(f"phase 18 {ch_db:g} dB: JFA scores {s_card.shape} card vs "
              f"CPU max|d|/max|s| {rel:.3e} (tol {JFA_RTOL}), argmax "
              f"identical {same}; attempts {logs}", flush=True)
        if not np.isfinite(s_card).all() or rel > JFA_RTOL or not same:
            raise AssertionError(f"{ch_db} dB: the card's JFA disagrees with "
                                 "the CPU's")
        # MAP: the UBM-adapted bank minus the UBM, per test (K2 on the card)
        per = {}
        for f, i in zip(c["en"], c["en_ids"]):
            per.setdefault(int(i), []).append(f)
        _, bank = ubm_tools.adapt_speakers(
            ubm, {i: np.concatenate(v) for i, v in per.items()}, device=dev)
        Xs, masks = _pad_stack(c["te"])
        X = torch.as_tensor(Xs, dtype=torch.float32, device=dev)
        mask = torch.from_numpy(masks).to(dev)
        bs = gpu_gmm.batch_bank_avg_loglik(
            GmmBank.from_numpy(*bank, device=dev), X, mask)
        us = gmm.avg_loglik(gmm.params_to(ubm, torch.float32, dev), X, mask)
        s_map = (bs - us[:, None]).T.cpu().numpy()
        truth = c["truth"]
        row = {"acc_jfa": float((s_card.argmax(0) == truth).mean()),
               "eer_jfa": verification_eer(s_card, truth),
               "acc_map": float((s_map.argmax(0) == truth).mean()),
               "eer_map": verification_eer(s_map, truth),
               "stats_ms": 1e3 * t_stats, "train_ms": 1e3 * t_train,
               "score_ms": 1e3 * t_score}
        out[ch_db] = row
        print(f"phase 18 [{card}] {ch_db:g} dB, {JFA_BG} x "
              f"{JFA_BG_SESSIONS} x {JFA_SEC:g} s background, {JFA_EVAL} "
              f"speakers, {len(truth)} tests: JFA acc {row['acc_jfa']:.4f} "
              f"EER {row['eer_jfa']:.4f}, MAP acc {row['acc_map']:.4f} EER "
              f"{row['eer_map']:.4f}; stats {row['stats_ms']:.1f} ms, "
              f"training {row['train_ms']:.1f} ms, enroll + scoring "
              f"{row['score_ms']:.1f} ms", flush=True)
    # the CLI on a small corpus, with the 6 dB UBM
    with tempfile.TemporaryDirectory() as tmp:
        ubm_dir = os.path.join(tmp, "ubm")
        serialization.dump_jfa_supervectors(ubm, ubm_dir)
        tasks = {}
        for task, (n, sec) in (("train", (2, 3.0)), ("test", (1, 2.0))):
            dirs = []
            for i, v in enumerate(synth.voices(4, seed=99)):
                d = os.path.join(tmp, task, f"spk{i}")
                os.makedirs(d)
                for k in range(n):
                    wavfile.write(os.path.join(d, f"s{k}.wav"), synth.FS,
                                  synth.voice_utterance(
                                      v, sec, 1000 * (task == "test")
                                      + 10 * i + k))
                dirs.append(d)
            tasks[task] = (" ".join(dirs), 4 * n)

        def cli_run(*argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jfa_pipeline.main(list(argv))
            return buf.getvalue().strip().splitlines()
        per_utt = []
        for task, (dirs, n) in tasks.items():
            gpu_frontend.LAUNCHES = 0
            cli_run("gen-features", "-i", dirs, "-o",
                    os.path.join(tmp, "feat"), "--task", task,
                    "--device", "cuda")
            per_utt.append(gpu_frontend.LAUNCHES / n)
            cli_run("stats", "--ubm-dir", ubm_dir, "--lst",
                    os.path.join(tmp, "feat", task + ".lst"), "-o",
                    os.path.join(tmp, task + "_stats.npz"),
                    "--device", "cuda")
        cli_run("train", "--ubm-dir", ubm_dir, "--stats",
                os.path.join(tmp, "train_stats.npz"), "-o",
                os.path.join(tmp, "model.npz"), "--nv", "2", "--nu", "1",
                "--iters", "5", "--device", "cuda")
        lines = cli_run("score", "--ubm-dir", ubm_dir, "--model",
                        os.path.join(tmp, "model.npz"), "--enroll-stats",
                        os.path.join(tmp, "train_stats.npz"),
                        "--test-stats", os.path.join(tmp, "test_stats.npz"),
                        "--device", "cuda")
    right = sum(ln.split(" -> ")[0] == ln.split(" -> ")[1].split(" ")[0]
                for ln in lines)
    print(f"phase 18 jfa_pipeline CLI on the card: {len(lines)} test "
          f"sessions scored, {right} to their own speaker; K1 launches per "
          f"gen-features utterance {per_utt}", flush=True)
    if len(lines) != tasks["test"][1] or per_utt != [1.0, 1.0]:
        raise AssertionError("the jfa_pipeline CLI did not run through K1 "
                             "once an utterance")
    return out


def normwise(got, want) -> float:
    """max |got - want| / max |want|, over tensors on any device."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def rbm_surfaces(where, rng_seed: int = 19) -> dict:
    """The RBM family's deterministic outputs on one device, from inputs
    and noise drawn on the host: the CRBM's noise-free up-down pass,
    reconstruction errors of one model and a bank, one CRBM CD-1 step; the
    RBM's probabilities and one CD-1 step; the MLP's forward pass and one
    SGD step."""
    rng = np.random.RandomState(rng_seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=where)
    nv, nh, S, B = 28, CRBM_HIDDEN, CRBM_SPEAKERS, 200
    cp = crbm.CrbmParams(
        t(0.3 * rng.randn(S, nv)), t(0.3 * rng.randn(S, nh)),
        t(0.5 * rng.randn(S, nv, nh)), t(1.0 + 0.2 * rng.rand(S, nh)),
        t(-1.0 - rng.rand(S, nv)), t(1.0 + rng.rand(S, nv)))
    vel = crbm._Velocity(*(t(0.01 * rng.randn(*p.shape)) for p in cp[:4]))
    X = t(rng.randn(B, nv))
    batch = t(rng.randn(S, B, nv))
    noise = [t(rng.randn(S, B, nh)), t(rng.randn(S, B, nv)),
             t(rng.randn(S, B, nh))]
    one = crbm.CrbmParams(*(p[0] for p in cp))
    H = crbm.sample_hidden(one, X)
    new, nvel = crbm.cd_batch(cp, vel, batch, noise, crbm.CrbmTrainConfig())
    rp = rbm.RbmParams(t(0.3 * rng.randn(nv)), t(0.3 * rng.randn(nh)),
                       t(0.5 * rng.randn(nv, nh)))
    Xb = t(rng.rand(B, nv) > 0.5)
    unif = [t(rng.rand(B, nh)), t(rng.rand(B, nv)), t(rng.rand(B, nh))]
    rnew = rbm.cd_step(rp, Xb, unif, rbm.RbmTrainConfig())
    mp = neural_net.MlpParams((t(0.5 * rng.randn(nv, 16)),
                               t(0.5 * rng.randn(16, S))),
                              (t(0.1 * rng.randn(16)), t(0.1 * rng.randn(S))))
    Y = t(np.eye(S)[rng.randint(0, S, B)])
    mnew = neural_net.sgd_step(mp, X, Y, 0.1)
    return {"hidden": H, "visible": crbm.sample_visible(one, H),
            "recon_error": crbm.reconstruction_error(
                one, X, torch.ones(B, dtype=torch.bool, device=where)),
            "bank_errors": crbm.bank_reconstruction_errors(
                cp, X, torch.ones(B, dtype=torch.bool, device=where)),
            "cd_w": new.w, "cd_a": new.a, "cd_dv": nvel.dv,
            "rbm_transform": rbm.transform(rp, Xb), "rbm_cd_w": rnew.w,
            "rbm_cd_hb": rnew.hb, "mlp_forward": neural_net.forward(mp, X),
            "mlp_sgd_w0": mnew.weights[0], "mlp_sgd_b1": mnew.biases[1]}


def phase19(dev, card) -> dict:
    """19. The RBM family on the card: its deterministic surfaces and one
    CD step against the CPU; a speaker bank trained at speaker_task_config
    on the port's voices, timed; segments bitwise equal to one run;
    predict_bank on held-out utterances, on the card and with the card's
    bank on the CPU; the crbm_cli train -> test on the card. Returns the
    training features, which phase 20 pools."""
    card_s, cpu_s = rbm_surfaces(dev), rbm_surfaces("cpu")
    errs = {k: normwise(card_s[k], cpu_s[k]) for k in cpu_s}
    worst = max(errs.values())
    print(f"phase 19 RBM family, card vs CPU, f32 (normwise, tol "
          f"{RBM_RTOL}): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                       errs.items()), flush=True)
    if worst > RBM_RTOL:
        raise AssertionError("the RBM family on the card disagrees with the "
                             "CPU")

    vs = synth.voices(CRBM_SPEAKERS, seed=1900)
    labels = list(range(1, CRBM_SPEAKERS + 1))
    train = [extract.mix_feature(synth.FS, synth.voice_utterance(
        v, CRBM_SEC, 1900 + 10 * i), CRBM_FEATURES, device=dev)
        for i, v in enumerate(vs)]
    tests = [(labels[i], extract.mix_feature(synth.FS, synth.voice_utterance(
        v, CRBM_TEST_SEC, 1950 + 10 * i + j), CRBM_FEATURES, device=dev))
        for i, v in enumerate(vs) for j in range(CRBM_TESTS)]
    Xs, masks = _pad_stack(train)
    Xs = torch.as_tensor(Xs, dtype=torch.float32, device=dev)
    masks = torch.as_tensor(masks, device=dev)
    cfg = crbm.speaker_task_config(Xs.shape[1])

    def train_bank():
        return crbm.fit_bank(Xs, masks, CRBM_HIDDEN, cfg, 0, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = train_bank()
    torch.cuda.synchronize()
    t_train = (time.perf_counter() - t0) * 1e3
    print(f"phase 19 [{card}] CRBM bank at speaker_task_config, "
          f"{CRBM_SPEAKERS} speakers x {Xs.shape[1]} frames (d {Xs.shape[2]},"
          f" nh {CRBM_HIDDEN}, full batch, {cfg.n_epochs} steps): "
          f"{t_train:.1f} ms; " + device_times(train_bank, calls=1),
          flush=True)
    seg_cfg = crbm.CrbmTrainConfig(n_epochs=60, batch_size=100)
    mono = crbm.fit_bank(Xs, masks, CRBM_HIDDEN, seg_cfg, 3, dev)
    state = None
    for seg in (25, 20, 15):
        state = crbm.fit_bank_segment(Xs, masks, CRBM_HIDDEN, seg_cfg, 3,
                                      state, seg, 60, dev)
    seg_equal = all(torch.equal(a, b) for a, b in zip(mono, state.params))
    print(f"phase 19 CRBM segments (25 + 20 + 15 epochs) bitwise equal to "
          f"one run of 60 on the card: {seg_equal}", flush=True)
    bank_cpu = crbm.CrbmParams(*(p.cpu() for p in bank))
    got, on_cpu = [], []
    for _, f in tests:
        x = torch.as_tensor(f, device=dev)
        m = torch.ones(len(f), dtype=torch.bool, device=dev)
        got.append(crbm.predict_bank(bank, labels, x, m))
        on_cpu.append(crbm.predict_bank(bank_cpu, labels, x.cpu(), m.cpu()))
    acc = float(np.mean([g == lab for g, (lab, _) in zip(got, tests)]))
    print(f"phase 19 predict_bank on {len(tests)} held-out utterances of "
          f"{CRBM_TEST_SEC:g} s: accuracy {acc:.4f} (chance "
          f"{1 / CRBM_SPEAKERS:.2f}); the card's bank on the CPU gives the "
          f"same decisions {got == on_cpu}", flush=True)
    if not seg_equal or got != on_cpu or acc <= 1 / CRBM_SPEAKERS:
        raise AssertionError("the CRBM bank's segments, decisions or "
                             "accuracy are off")

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for split, pairs in (("train", list(zip(labels, train))),
                             ("test", tests)):
            paths[split] = os.path.join(tmp, f"{split}.svm")
            datamanip.write_svm_data(
                paths[split], np.concatenate([f for _, f in pairs]),
                np.concatenate([np.full(len(f), lab) for lab, f in pairs]))
        model = os.path.join(tmp, "bank.npz")
        outs = []
        for task in ("train", "test"):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "speaker_recognition_tpu_torch.tools.crbm_cli", task, "-i",
                 paths[task], "-m", model, "--hidden", str(CRBM_HIDDEN),
                 "--epochs", str(CRBM_CLI_EPOCHS), "--device", "cuda"],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            outs.append((proc.returncode, proc.stdout.strip(),
                         time.perf_counter() - t0))
        ok = all(rc == 0 for rc, _, _ in outs)
        # the CLI's per-frame accuracy, against the same bank's decisions
        # made here on the card
        mine = ""
        if ok:
            X_te, y_te = datamanip.read_svm_data(paths["test"])
            cli_labels, cli_bank = crbm_cli._load_bank(model, dev)
            errs = crbm_cli.instance_errors(cli_bank, torch.as_tensor(
                X_te, dtype=torch.float32, device=dev))
            pred = np.asarray(cli_labels)[errs.argmin(0).cpu().numpy()]
            mine = f"{np.mean(pred == y_te):.4f}"
        print(f"phase 19 python -m ...tools.crbm_cli train -> test on the "
              f"card ({CRBM_CLI_EPOCHS} epochs, batch 100, per frame): "
              f"{[o[1] for o in outs]}, {[round(o[2], 1) for o in outs]} s; "
              f"the same bank's accuracy here {mine}", flush=True)
        if not ok or not outs[1][1].endswith(mine):
            raise AssertionError(f"crbm_cli failed: {outs}")
    return {"train": train, "tests": tests}


def phase20(dev, card, feats: dict) -> list:
    """20. The multi-device programs at world size 1 (NCCL on the card, a
    free localhost port; gloo on the CPU), destroyed afterwards:
    sharded_fit bitwise equal to gmm.fit, sharded_bank_scores bitwise
    equal to the unsharded K3 call (K3's counter moving),
    sharded_mix_feature within the feature tolerance of mix_feature (K1's
    counter moving), train_ubm(mesh=...) equal to train_ubm(), and
    scaling_report. Returns the kernels' entries of this path."""
    import torch.distributed as dist

    from speaker_recognition_tpu_torch.parallel import (mesh as pmesh,
                                                        multihost, seqshard)

    multihost.initialize(None, 1, 0, device=dev)
    entries = []
    try:
        mesh = pmesh.make_mesh(1, 1, device=dev)
        print(f"phase 20 process group: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {tuple(mesh.mesh.shape)} "
              f"{mesh.mesh_dim_names}", flush=True)
        X = np.concatenate(feats["train"]).astype(np.float32)
        mask = np.ones(len(X), bool)
        cfg = GmmConfig(n_mixtures=32, n_iterations=MULTI_ITERS)
        got, ll = pmesh.sharded_fit(mesh, cfg)(X, mask, 0)
        want, wll = gmm.fit(torch.as_tensor(X[None], device=dev),
                            torch.ones((1, len(X)), dtype=torch.bool,
                                       device=dev), cfg, 0)
        fit_bits = (all(torch.equal(a, b[0]) for a, b in zip(got, want))
                    and torch.equal(ll, wll[0]))
        print(f"phase 20 sharded_fit bitwise equal to gmm.fit ({len(X)} "
              f"frames, GMM-32, {MULTI_ITERS} iterations): {fit_bits}",
              flush=True)
        rng = np.random.RandomState(20)
        d = X.shape[1]
        w = rng.dirichlet(np.ones(32), size=MULTI_S).astype(np.float32)
        bank = (w, rng.randn(MULTI_S, 32, d).astype(np.float32),
                (0.5 + rng.rand(MULTI_S, 32, d)).astype(np.float32))
        x5 = torch.as_tensor(feats["tests"][0][1], device=dev).contiguous()
        m5 = torch.ones(len(x5), dtype=torch.bool, device=dev)
        score = pmesh.sharded_bank_scores(mesh)
        gpu_gmm.SERIAL_LAUNCHES = 0
        s = score(bank, x5, m5)
        torch.cuda.synchronize()
        k3 = gpu_gmm.SERIAL_LAUNCHES
        gbank = GmmBank.from_numpy(*bank, dev)
        unsharded = gpu_gmm.bank_avg_loglik(gbank, x5, m5)
        score_bits = torch.equal(s, unsharded)
        print(f"phase 20 sharded_bank_scores ({MULTI_S} x 32, {len(x5)} "
              f"frames) bitwise equal to the unsharded K3 call: "
              f"{score_bits}; K3 launches on the sharded path {k3}",
              flush=True)
        vs = synth.voices(1, seed=2000)
        sig = synth.voice_utterance(vs[0], SEQ_SEC, 2001)
        gpu_frontend.LAUNCHES = 0
        seq = seqshard.sharded_mix_feature(mesh, synth.FS, sig)
        torch.cuda.synchronize()
        k1 = gpu_frontend.LAUNCHES
        ref = extract.mix_feature(synth.FS, sig, device=dev)
        ones = torch.ones((1, len(ref)), dtype=torch.bool)
        d_mfcc, d_lpc, lpc_bad = feature_errors(
            torch.from_numpy(seq)[None], torch.from_numpy(ref)[None], ones,
            13)
        print(f"phase 20 sharded_mix_feature, {SEQ_SEC:g} s @ 8 kHz "
              f"{seq.shape} vs mix_feature {ref.shape}: mfcc max|d| "
              f"{d_mfcc:.3e} (tol {MFCC_ATOL}) lpc max|d| {d_lpc:.3e} (over "
              f"tol: {lpc_bad}); K1 launches on the sharded path {k1}",
              flush=True)
        parts = feats["train"]
        a = ubm_tools.train_ubm(parts, n_mixtures=32, n_iterations=20,
                                mesh=mesh, device=dev)
        b = ubm_tools.train_ubm(parts, n_mixtures=32, n_iterations=20,
                                device=dev)
        ubm_bits = all(np.array_equal(x, y) for x, y in zip(a, b))
        print(f"phase 20 train_ubm(mesh=...) bitwise equal to train_ubm(): "
              f"{ubm_bits}", flush=True)
        if (not (fit_bits and score_bits and ubm_bits)
                or seq.shape != ref.shape or d_mfcc > MFCC_ATOL or lpc_bad
                or (dev.type == "cuda" and (k3 < 1 or k1 < 1))):
            raise AssertionError("the multi-device path disagrees with the "
                                 "unsharded one, or missed its kernels")
        report = multihost.scaling_report(SCALING_FRAMES, device=dev)
        print(f"phase 20 [{card}] scaling_report: {json.dumps(report)}",
              flush=True)

        # the kernels at this path's shapes: K3 on the rank's share of the
        # bank (all of it at world size 1), K1 (CMVN off) on its chunk
        plain = gpu_gmm.bank_avg_loglik_reference(gbank, x5, m5)
        tk3 = time_interleaved({
            "kernel": lambda: gpu_gmm.bank_avg_loglik(gbank, x5, m5),
            "plain": lambda: gpu_gmm.bank_avg_loglik_reference(gbank, x5,
                                                               m5),
            "sharded": lambda: score(bank, x5, m5)})
        n5 = len(x5)
        entries.append((
            "bank_sum_loglik_sharded", "gmm_serial.cu", "pallas_gmm.py:47",
            k3, float((unsharded - plain).abs().max()), tk3["kernel"],
            tk3["plain"], bound(score_flops(n5, d, MULTI_S * 32),
                                4 * x5.numel() + n5 + 4 * (
                                    gbank.op.numel() + gbank.cw.numel())
                                + 4 * MULTI_S)))
        # K1 with CMVN off on the chunk a rank frames (the whole signal at
        # world size 1). On the path's own voice, whose near-singular frames
        # part every f32 route from float64, K1 may part from the float64
        # route VOICE_FACTOR times as far as the f32 plain versions; the
        # kernels line holds K1 to its plain version on int16-scale white
        # noise of the same shape, as phase 2 holds K1
        fe = extract.frontend(synth.FS, FeatureConfig(), dev)
        fe64 = extract.frontend(synth.FS, FeatureConfig(), dev, "float64")
        L = len(sig)
        chunk = -(-L // fe.frame_shift) * fe.frame_shift
        T = n_frames(chunk + fe.frame_len - fe.frame_shift, fe.frame_len,
                     fe.frame_shift)
        Tv = n_frames(L, fe.frame_len, fe.frame_shift)
        nv = torch.tensor([Tv], dtype=torch.int32, device=dev)
        m = (torch.arange(T, device=dev) < nv)[None]

        def chunk_of(x):
            ext = torch.zeros((1, chunk + fe.frame_len - fe.frame_shift),
                              dtype=torch.float32, device=dev)
            ext[0, :L] = torch.as_tensor(x.astype(np.float32), device=dev)
            return ext

        def parted(voice, nv, Tv, what, fe=fe, fe64=fe64, n_lpcc=0):
            """K1 (CMVN off) and the f32 plain versions against the float64
            route on [1, L] samples, the LPC or with n_lpcc the LPC
            cepstra (then also K1's raw tile with the torch recursion
            after it, the parent's LPC-cepstra route's rows): {route:
            (cepstra max |d|, frames whose LPC columns part past LPC_ATOL /
            LPC_RTOL)}."""
            vargs = (voice, nv, fe.D, fe.W, fe.dct, fe.A, fe.floor,
                     fe.frame_shift, False)
            f64 = gpu_frontend.packed_from_signals_reference(
                voice.double(), nv, fe64.D, fe64.W, fe64.dct, fe64.A,
                fe64.floor, fe.frame_shift, False, n_lpcc=n_lpcc)[0, :Tv]
            routes = [
                ("K1", gpu_frontend.packed_from_signals(
                    *vargs, fft=fe.fft, n_lpcc=n_lpcc)),
                ("dense f32", gpu_frontend.packed_from_signals_reference(
                    *vargs, n_lpcc=n_lpcc)),
                ("fft f32", gpu_frontend.packed_from_signals_fft_reference(
                    voice, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift,
                    False, True, n_lpcc))]
            if n_lpcc:
                c, r = gpu_frontend.packed_from_signals(
                    *vargs, fft=fe.fft, fuse_lpc=False)
                routes.append(("raw tile + torch tail", torch.cat(
                    [c, gpu_frontend.lpc_columns(r, n_lpcc)], -1)))
            errs = {}
            for name, got in routes:
                dv = (got[0, :Tv].double() - f64).abs()
                lpc_bad = ((dv[:, 13:] > LPC_ATOL)
                           & (dv[:, 13:] > LPC_RTOL * f64[:, 13:].abs())).any(1)
                errs[name] = (float(dv[:, :13].max()), int(lpc_bad.sum()))
                print(f"phase 20 {name} (CMVN off) vs the float64 route on "
                      f"{what} ({Tv} frames): cepstra max|d| "
                      f"{errs[name][0]:.3e}, LPC max|d| "
                      f"{float(dv[:, 13:].max()):.3e}, frames past the LPC "
                      f"tolerance {errs[name][1]}", flush=True)
            return errs

        errs = parted(chunk_of(sig), nv, Tv, "the seqshard voice")
        # the voice's first VOICE_ROWS rows, the longest utterance the JAX
        # package serves through its Pallas K1: tests/test_torch_voice_lpc.py
        # reads the JAX package's f32 routes on the same frames
        Lc = min(L, VOICE_ROWS * fe.frame_shift)
        Tc = n_frames(Lc, fe.frame_len, fe.frame_shift)
        parted(torch.as_tensor(sig[None, :Lc].astype(np.float32), device=dev),
               torch.tensor([Tc], dtype=torch.int32, device=dev), Tc,
               f"the voice's first {Lc} samples")
        worst = [max(errs["dense f32"][i], errs["fft f32"][i])
                 for i in (0, 1)]
        print(f"phase 20 K1 on the seqshard voice within {VOICE_FACTOR}x the "
              f"f32 plain versions' distance from float64 (cepstra max|d|, "
              f"LPC frames past tolerance): {errs['K1']} against "
              f"{tuple(worst)}", flush=True)
        if any(k > VOICE_FACTOR * w for k, w in zip(errs["K1"], worst)):
            raise AssertionError("K1 parts from float64 on the seqshard "
                                 "voice further than the f32 plain versions")
        # the same rule for K1's LPC-cepstra mode (csrc/
        # frontend_lpcc_signals.cu: the projection in three TF32 terms,
        # the power unfloored), beside the raw tile + the torch recursion
        cfg_c = FeatureConfig(lpc=LPCC)
        errs_c = parted(chunk_of(sig), nv, Tv,
                        "the seqshard voice, n_lpcc 16",
                        extract.frontend(synth.FS, cfg_c, dev),
                        extract.frontend(synth.FS, cfg_c, dev, "float64"),
                        LPCC.n_lpcc)
        worst_c = [max(errs_c["dense f32"][i], errs_c["fft f32"][i])
                   for i in (0, 1)]
        print(f"phase 20 K1's LPC-cepstra mode on the seqshard voice within "
              f"{VOICE_FACTOR}x the f32 plain versions' distance from "
              f"float64 (cepstra max|d|, LPC-cepstra frames past "
              f"tolerance): {errs_c['K1']} against {tuple(worst_c)}; the "
              f"raw tile + torch tail {errs_c['raw tile + torch tail']}",
              flush=True)
        if any(k > VOICE_FACTOR * w for k, w in zip(errs_c["K1"], worst_c)):
            raise AssertionError("K1's LPC cepstra part from float64 on the "
                                 "seqshard voice further than the f32 plain "
                                 "versions")
        ext = chunk_of(rng.randn(L) * 3000)
        args = (ext, nv, fe.D, fe.W, fe.dct, fe.A, fe.floor, fe.frame_shift,
                False)
        d_mfcc, d_lpc, lpc_bad = feature_errors(
            gpu_frontend.packed_from_signals(*args, fft=fe.fft),
            gpu_frontend.packed_from_signals_reference(*args), m, 13)
        print(f"phase 20 K1 (CMVN off) on the seqshard chunk vs its plain "
              f"version on noise: mfcc max|d| {d_mfcc:.3e} (tol {MFCC_ATOL}) "
              f"lpc max|d| {d_lpc:.3e} (over tol: {lpc_bad})", flush=True)
        if d_mfcc > MFCC_ATOL or lpc_bad:
            raise AssertionError("K1 on the seqshard chunk disagrees with "
                                 "its plain version")
        tk1 = time_interleaved({
            "kernel": lambda: gpu_frontend.packed_from_signals(*args,
                                                               fft=fe.fft),
            "plain": lambda: gpu_frontend.packed_from_signals_reference(
                *args)})
        nceps, nac = fe.dct.shape[1], fe.A.shape[1]
        entries.append((
            "packed_frontend_seqshard", "frontend.cu",
            "pallas_frontend.py:231", k1, max(d_mfcc, d_lpc), tk1["kernel"],
            tk1["plain"],
            bound(frontend_flops(int(nv), fe.n_fft, (fe.fft_mel,
                                                     fe.fft_acorr), nceps,
                                 order=nac - 1, window=3 * fe.frame_len),
                  4 * ext.numel() + 4 * T * (nceps + nac - 1))))
        print(f"phase 20 [{card}] K3 on the sharded path's share: "
              f"{tk3['kernel']:.4f} ms, plain {tk3['plain']:.4f} ms, the "
              f"sharded call (bank upload + K3 + all_gather) "
              f"{tk3['sharded']:.4f} ms; K1 on the seqshard chunk ({T} "
              f"frames): {tk1['kernel']:.4f} ms, plain {tk1['plain']:.4f} ms",
              flush=True)
    finally:
        dist.destroy_process_group()
    return entries


def check_frontend_bf16(name, fe: PackedFrontend, sig, lengths,
                        fuse_lpc=True) -> float:
    """K1's bf16 mode vs its plain version (the dense product on bf16-rounded
    signals and D) on one batch, at the bf16 gates (the cepstra at
    bf16_cepstra_limits'), the f32 dense product BF16_APART gates away:
    zeros past n_valid, two calls bitwise, two
    launches counted; returns the max abs error (of the cepstra in the
    raw-autocorrelation mode, whose autocorrelation is held to lag 0)."""
    args = frontend_args(fe, sig, lengths)
    n_valid = args[1]
    mask = torch.arange(n_frames(sig.shape[1], fe.frame_len, fe.frame_shift),
                        device=sig.device) < n_valid[:, None]
    before = gpu_frontend.BF16_LAUNCHES
    got = gpu_frontend.packed_from_signals(*args, fuse_lpc=fuse_lpc,
                                           mm_bf16=True)
    again = gpu_frontend.packed_from_signals(*args, fuse_lpc=fuse_lpc,
                                             mm_bf16=True)
    launched = gpu_frontend.BF16_LAUNCHES - before
    want, f32 = (gpu_frontend.packed_from_signals_reference(
        *args, fuse_lpc=fuse_lpc, mm_bf16=bf16) for bf16 in (True, False))
    # the float64 route: the plain version in float64 on the same rounded
    # operands
    f64 = gpu_frontend.packed_from_signals_reference(
        *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
          for a in args), fuse_lpc=fuse_lpc, mm_bf16=True)
    torch.cuda.synchronize()
    got, again, want, f32, f64 = ((x,) if fuse_lpc else x
                                  for x in (got, again, want, f32, f64))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if not all(torch.isfinite(x).all() for x in got) or any(
            (x[~mask] != 0).any() for x in got):
        raise AssertionError(f"{name}: non-finite or unmasked features")
    nc = fe.dct.shape[1]
    frames = framing.frame_signal(sig, fe.frame_len, fe.frame_shift)
    lim = gpu_frontend.bf16_cepstra_limits(
        frames, fe.D, fe.W, fe.dct, fe.floor, mask, fe.cmvn, MFCC_BF16_ULPS,
        MFCC_BF16_ATOL)
    del frames

    def ceps_d(a, b):
        return float(((a[..., :nc] - b[..., :nc].to(a.dtype)).abs()
                      * mask[..., None]).max())

    def acorr(a):
        lag0 = want[1][..., :1].abs().clamp_min(1e-30)
        return float(((a[1] - want[1]).abs() / lag0)[mask].max())

    # the cepstra, each within its limit of the plain version's; the f32
    # product BF16_APART limits away
    r_k, r_f32 = (ceps_ratio(a[0], want[0], lim, mask) for a in (got, f32))
    k64, p64 = ceps_d(got[0], f64[0]), ceps_d(want[0], f64[0])
    past = float((lim > MFCC_BF16_ATOL)[mask].double().mean())
    if fuse_lpc:
        d_mfcc, d_lpc, lpc_bad = feature_errors(
            got[0], want[0], mask, nc, (LPC_BF16_ATOL, LPC_BF16_RTOL))
        d_r, err = 0.0, max(d_mfcc, d_lpc)
        apart = bf16_apart(name, {"f32 product's cepstra, max|d|/limit":
                                  r_f32}, 1.0)
    else:
        d_mfcc, d_r = ceps_d(got[0], want[0]), acorr(got)
        d_lpc, lpc_bad, err = 0.0, 0, d_mfcc
        apart = bf16_apart(name, {"f32 product's cepstra, max|d|/limit":
                                  r_f32}, 1.0)
        apart += bf16_apart(name, {"f32 product's autocorrelation":
                                   acorr(f32)}, ACORR_BF16_RTOL)
    tile = occupancy(fe.frame_len, fe.frame_shift,
                     fe.W.shape[1] + fe.A.shape[1])
    print(f"phase 21 K1 bf16 {name} ({tile}) vs its plain version: "
          f"{[tuple(x.shape) for x in got]} mfcc max|d| {d_mfcc:.3e}, "
          f"max|d|/limit {r_k:.3e} (tol 1; {limit_text(lim, mask, past)}) "
          f"lpc max|d| {d_lpc:.3e} (over tol: {lpc_bad}) autocorrelation "
          f"max|d|/lag0 {d_r:.3e} (tol {ACORR_BF16_RTOL}) launches "
          f"{launched} two calls bitwise equal {bitwise}; cepstra from the "
          f"float64 route: kernel {k64:.3e}, f32 plain version {p64:.3e}"
          f"{apart}", flush=True)
    if (not r_k <= 1.0 or lpc_bad or d_r > ACORR_BF16_RTOL
            or launched != 2 or not bitwise):
        raise AssertionError(f"{name}: K1's bf16 mode disagrees with its "
                             "plain version")
    return err


def check_serial_bf16(name, bank, x, mask) -> float:
    """K3's bf16 mode vs its plain version: the sums within
    SERIAL_BF16_RTOL, the f32 mode and K2's x^2 rounding BF16_APART gates
    away, two calls bitwise, two launches counted; returns the max abs
    error of the sums over the valid frames (the averages')."""
    before = gpu_gmm.SERIAL_BF16_LAUNCHES
    sums = gpu_gmm.bank_sum_loglik(bank, x, mask, precision="bf16")
    again = gpu_gmm.bank_sum_loglik(bank, x, mask, precision="bf16")
    launched = gpu_gmm.SERIAL_BF16_LAUNCHES - before
    want = gpu_gmm.bank_sum_loglik_reference(bank, x, mask, precision="bf16")
    torch.cuda.synchronize()
    n = max(int(mask.sum()), 1)
    rel = max_rel(sums, want, 1.0)
    bitwise = torch.equal(sums, again)
    apart = bf16_apart(name, {
        "f32 mode": max_rel(gpu_gmm.bank_sum_loglik_reference(bank, x, mask),
                            want, 1.0),
        "K2's x^2 rounding": max_rel(swapped_rounding(bank, x, mask, False),
                                     want, 1.0)}, SERIAL_BF16_RTOL)
    print(f"phase 21 K3 bf16 {name}: [S] {tuple(sums.shape)} frames "
          f"{x.shape[0]} d {x.shape[1]} K {bank.n_mixtures} max rel "
          f"{rel:.3e} (tol {SERIAL_BF16_RTOL}) launches {launched} two calls "
          f"bitwise equal {bitwise}{apart}", flush=True)
    if (not torch.isfinite(sums).all() or rel > SERIAL_BF16_RTOL
            or not bitwise or launched != 2):
        raise AssertionError(f"{name}: K3's bf16 mode disagrees with its "
                             "plain version")
    return float((sums - want).abs().max()) / n


def occupancy(flen, fshift, nout, B=None, T=None, d=None, bank=None) -> str:
    """The bf16 kernels' launch shapes and resident blocks an SM on the
    card (the occupancy API): K1's (and K4's, fshift = flen) tile at a
    geometry, and with a bank K2's blocks at [B, T, d] against it."""
    import ctypes
    lib = _build.load()
    k1 = (ctypes.c_int * 3)()
    _build.check(lib.srt_frontend_bf16_occupancy(flen, fshift, nout, k1),
                 "K1 bf16 occupancy")
    text = (f"bf16 tile: {k1[0]} frames, {k1[1]} B of shared memory, "
            f"{k1[2]} blocks an SM")
    if bank is None:
        return text
    k2 = (ctypes.c_int * 3)()
    _build.check(lib.srt_bank_bf16_occupancy(
        B, T, d, bank.n_speakers, bank.n_mixtures, k2), "K2 bf16 occupancy")
    return (f"K1 {text}; K2 bf16: {k2[0]} warps a block, {k2[1]} B of "
            f"shared memory, {k2[2]} blocks an SM")


def signal_occupancy(n_fft: int, nout: int, kernel: str = "full") -> str:
    """A signal kernel at n_fft and nout outputs on the card: csrc/
    frontend_full_signals.cu's full_signals_kernel, or with kernel "lpcc"
    csrc/frontend_lpcc_signals.cu's lpcc_signals_kernel; blocks an SM (the
    occupancy API), registers and local bytes a thread (ptxas), shared
    memory a block."""
    import ctypes
    out = (ctypes.c_int * 4)()
    occupancy = getattr(_build.load(), f"srt_{kernel}_signals_occupancy")
    _build.check(occupancy(n_fft, nout, out), "signal kernel occupancy")
    return (f"{out[0]} blocks an SM, {out[1]} registers and {out[2]} local "
            f"bytes a thread, {out[3]} B of shared memory a block")


def flip_bank(dev):
    """K2's bf16 decisions against f32 at the UBM-scale shape: a GMM-256
    bank of FLIP_SPEAKERS voices (EM on FLIP_SEC s each) scored on
    FLIP_TESTS held-out utterances a voice; (flips, accuracy at f32, at
    bf16, utterances)."""
    vs = synth.voices(FLIP_SPEAKERS, seed=2100)
    train = jfa_features([synth.voice_utterance(v, FLIP_SEC, 2100 + i)
                          for i, v in enumerate(vs)], dev)
    X, M = _pad_stack(train)
    params, _ = gmm.fit(torch.as_tensor(X, dtype=torch.float32, device=dev),
                        torch.as_tensor(M, device=dev),
                        GmmConfig(n_mixtures=KM_K, n_iterations=FLIP_ITERS),
                        0)
    bank = GmmBank.from_numpy(*gmm.params_numpy(params), dev)
    tests = jfa_features([synth.voice_utterance(v, FLIP_TEST_SEC,
                                                2200 + 10 * i + j)
                          for i, v in enumerate(vs)
                          for j in range(FLIP_TESTS)], dev)
    truth = np.repeat(np.arange(len(vs)), FLIP_TESTS)
    Xt, Mt = _pad_stack(tests)
    Xt = torch.as_tensor(Xt, dtype=torch.float32, device=dev)
    Mt = torch.as_tensor(Mt, device=dev)
    f32 = gpu_gmm.batch_bank_avg_loglik(bank, Xt, Mt).argmax(-1).cpu()
    b16 = gpu_gmm.batch_bank_avg_loglik(bank, Xt, Mt,
                                        precision="bf16").argmax(-1).cpu()
    return (int((f32 != b16).sum()), float((f32.numpy() == truth).mean()),
            float((b16.numpy() == truth).mean()), len(truth))


def phase21(rng, dev, card, bench_sig, bench_len, fe8, fe8c, bench_bank,
            banks: dict, serial: dict, wide48) -> list:
    """21. The bf16 operand modes: K2 and K3 on the tensor cores, K1 and K4
    on the dense tile, each against its plain version at the main path's
    shapes (two calls bitwise, counters), K2's decisions against f32 at the
    UBM-scale shape (printed), predict_scores(mm="bf16") against the plain
    versions composed (K1 bf16 once, K2 f32 once, K1 f32 never), the
    48 kHz full route's bf16 product (its counter, K5 never), and each
    bf16 kernel timed beside its f32 mode. Returns the kernels' entries."""
    t0 = time.perf_counter()
    feats, mask = banks["bench_feats"]
    d = feats.shape[-1]
    # K2 bf16
    err_k2 = check_scoring("bench bank 4 x 32, 512 x 5 s", bench_bank,
                           feats, mask, 21, "bf16")
    for name, bank, f, m in banks["cases"]:
        err_k2 = max(err_k2, check_scoring(name, bank, f, m, 21, "bf16"))
    f200 = torch.from_numpy(rng.randn(16, 311, 200).astype(np.float32)).to(
        dev)
    m200 = torch.ones((16, 311), dtype=torch.bool, device=dev)
    err_k2 = max(err_k2, check_scoring(
        "bank 4 x 32 at d = 200", random_bank(rng, 4, 32, 200, dev), f200,
        m200, 21, "bf16"))
    f300 = torch.from_numpy(rng.randn(4, 70, 300).astype(np.float32)).to(dev)
    m300 = torch.ones((4, 70), dtype=torch.bool, device=dev)
    err_k2 = max(err_k2, check_scoring(
        "bank 3 x 12 at d = 300 (the wide route; 12 components padded to "
        "16)", random_bank(rng, 3, 12, 300, dev), f300, m300, 21, "bf16"))
    flips, acc32, acc16, n_flip = flip_bank(dev)
    print(f"phase 21 K2 bf16 against f32 at {FLIP_SPEAKERS} x {KM_K} "
          f"(voices, {FLIP_SEC:g} s each, EM): {flips} of {n_flip} argmax "
          f"decisions flip; accuracy f32 {acc32:.4f}, bf16 {acc16:.4f} "
          "(reported, not gated)", flush=True)
    # K3 bf16
    err_k3 = 0.0
    for name, bank, x, m in serial["cases"]:
        err_k3 = max(err_k3, check_serial_bf16(name, bank, x, m))
    # K1 bf16
    err_k1 = check_frontend_bf16("bench 512 x 5 s @ 8 kHz", fe8, bench_sig,
                                 bench_len)
    fe144 = PackedFrontend(BENCH_FS, FeatureConfig(mfcc=MfccConfig(
        n_filters=128)), dev)
    err_k1 = max(err_k1, check_frontend_bf16(
        "8 kHz, 128 mel filters + LPC (144 outputs)", fe144, bench_sig[:64],
        bench_len[:64]))
    err_k1 = max(err_k1, check_frontend_bf16(
        "raw autocorrelation (LPCC), bench batch", fe8c, bench_sig,
        bench_len, fuse_lpc=False))
    s48p, l48p = wide48
    err_k1 = max(err_k1, check_frontend_bf16(
        "48 kHz, fft_size 4096", PackedFrontend(FS48, FFT4096, dev), s48p,
        l48p))
    # 44.1 kHz with fft_size 4096: flen 1411 and fshift 705, both odd (no
    # 16-byte frame rows: the tile's 16-bit loads), on a batch of the f32
    # route's 44.1 kHz shape
    s44p, l44p = signals_batch(rng, [44100, 20000], padded(44100), dev)
    err_k1 = max(err_k1, check_frontend_bf16(
        "44.1 kHz, fft_size 4096", PackedFrontend(44100, FFT4096, dev), s44p,
        l44p))
    # K4 bf16 on the bench batch's frames, through the frontend's tail
    fargs, B, T = frames_args(fe8, bench_sig)
    nout8 = fe8.W.shape[1] + fe8.A.shape[1]
    fmask = framing.frame_validity_mask(bench_len, T, fe8.frame_len,
                                        fe8.frame_shift)
    before = gpu_frontend.FRAMES_BF16_LAUNCHES
    k4 = [gpu_frontend.packed_from_frames(*fargs, mm_bf16=True)
          for _ in range(2)]
    k4_launched = gpu_frontend.FRAMES_BF16_LAUNCHES - before
    want, f32 = (fe8.finish(*(x.view(B, T, -1) for x in
                              gpu_frontend.packed_from_frames_reference(
                                  *fargs, mm_bf16=bf16)), fmask)[0]
                 for bf16 in (True, False))
    torch.cuda.synchronize()
    got, fm = fe8.finish(k4[0][0].view(B, T, -1), k4[0][1].view(B, T, -1),
                         fmask)
    nc = fe8.dct.shape[1]
    d_mfcc, d_lpc, lpc_bad = feature_errors(got, want, fm, nc,
                                            (LPC_BF16_ATOL, LPC_BF16_RTOL))
    lim = gpu_frontend.bf16_cepstra_limits(
        fargs[0].view(B, T, -1), fe8.D, fe8.W, fe8.dct, fe8.floor, fm,
        fe8.cmvn, MFCC_BF16_ULPS, MFCC_BF16_ATOL)
    r_k4, r_f32 = (ceps_ratio(x, want, lim, fm) for x in (got, f32))
    past = float((lim > MFCC_BF16_ATOL)[fm].double().mean())
    apart = bf16_apart("K4 bf16", {"f32 product's cepstra, max|d|/limit":
                                   r_f32}, 1.0)
    k4_bits = all(torch.equal(a, b) for a, b in zip(*k4))
    print(f"phase 21 K4 bf16 bench frames {tuple(fargs[0].shape)} ("
          f"{occupancy(fe8.frame_len, fe8.frame_len, nout8)}) vs its "
          f"plain version, through CMVN and Levinson: mfcc max|d| "
          f"{d_mfcc:.3e}, max|d|/limit {r_k4:.3e} (tol 1; "
          f"{limit_text(lim, fm, past)}) lpc max|d| {d_lpc:.3e} (over "
          f"tol: {lpc_bad}) launches {k4_launched} two calls bitwise equal "
          f"{k4_bits}{apart}", flush=True)
    del lim
    if (not r_k4 <= 1.0 or lpc_bad or k4_launched != 2
            or not k4_bits or not torch.isfinite(got).all()):
        raise AssertionError("K4's bf16 mode disagrees with its plain "
                             "version")
    err_k4 = max(d_mfcc, d_lpc)

    # the slice: predict_scores(mm="bf16") on the bench batch
    def reset():
        for mod, names in ((gpu_frontend, ("LAUNCHES", "BF16_LAUNCHES",
                                           "FRAMES_BF16_LAUNCHES",
                                           "FULL_LAUNCHES", "FULL_BIG_LAUNCHES",
                                           "FULL_DENSE_LAUNCHES",
                                           "FULL_SIGNAL_LAUNCHES",
                                           "FULL_BF16_CALLS")),
                           (gpu_gmm, ("LAUNCHES", "BF16_LAUNCHES"))):
            for c in names:
                setattr(mod, c, 0)

    def counts():
        return {"K1 f32": gpu_frontend.LAUNCHES,
                "K1 bf16": gpu_frontend.BF16_LAUNCHES,
                "K4 bf16": gpu_frontend.FRAMES_BF16_LAUNCHES,
                "K2 f32": gpu_gmm.LAUNCHES, "K2 bf16": gpu_gmm.BF16_LAUNCHES,
                "K5": gpu_frontend.FULL_LAUNCHES
                + gpu_frontend.FULL_BIG_LAUNCHES
                + gpu_frontend.FULL_DENSE_LAUNCHES
                + gpu_frontend.FULL_SIGNAL_LAUNCHES,
                "full bf16": gpu_frontend.FULL_BF16_CALLS}

    reset()
    got = fastpath.predict_scores(bench_sig, bench_len, bench_bank, BENCH_FS,
                                  mm="bf16")
    torch.cuda.synchronize()
    slice_counts = counts()
    pargs = frontend_args(fe8, bench_sig, bench_len)
    pmask = torch.arange(n_frames(bench_sig.shape[1], fe8.frame_len,
                                  fe8.frame_shift), device=dev) \
        < pargs[1][:, None]
    want = gpu_gmm.batch_bank_avg_loglik_reference(
        bench_bank, gpu_frontend.packed_from_signals_reference(
            *pargs, mm_bf16=True), pmask)
    rel = max_rel(got, want)
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    apart = bf16_apart("predict_scores(mm='bf16')", {
        "f32 slice": max_rel(fastpath.predict_scores(
            bench_sig, bench_len, bench_bank, BENCH_FS), want)},
        PREDICT_BF16_RTOL)
    print(f"phase 21 predict_scores(mm='bf16'), bench 512 x 5 s: vs the "
          f"plain versions composed max rel {rel:.3e} (tol "
          f"{PREDICT_BF16_RTOL}) argmax identical {same}; launches "
          f"{slice_counts}{apart}", flush=True)
    if (rel > PREDICT_BF16_RTOL or not same or slice_counts["K1 bf16"] != 1
            or slice_counts["K2 f32"] != 1 or slice_counts["K1 f32"]
            or slice_counts["K2 bf16"] or slice_counts["K4 bf16"]):
        raise AssertionError("predict_scores(mm='bf16') disagrees with the "
                             "plain versions or missed its kernels")
    # the 48 kHz full route's bf16 product: plain torch, K5 not launched
    L48 = 2 * FS48
    s48, l48 = signals_batch(rng, [L48, FS48, 30000, 2000], padded(L48), dev)
    reset()
    got48 = fastpath.predict_scores(s48, l48, bench_bank, FS48, mm="bf16")
    torch.cuda.synchronize()
    full_counts = counts()
    cpu_bank = GmmBank(bench_bank.op.cpu(), bench_bank.cw.cpu(),
                       bench_bank.n_speakers, bench_bank.n_mixtures)
    want48, f32_48 = (fastpath.predict_scores(s48.cpu(), l48.cpu(), cpu_bank,
                                              FS48, mm=mm)
                      for mm in ("bf16", "f32"))
    rel48 = max_rel(got48.cpu(), want48)
    apart = bf16_apart("the 48 kHz full route", {
        "f32 slice": max_rel(f32_48, want48)}, FULL_BF16_RTOL)
    print(f"phase 21 predict_scores(mm='bf16') at 48 kHz (the full route's "
          f"bf16 product) vs the same on the CPU: max rel {rel48:.3e} (tol "
          f"{FULL_BF16_RTOL}); launches {full_counts}{apart}", flush=True)
    if (rel48 > FULL_BF16_RTOL or full_counts["full bf16"] != 1
            or full_counts["K5"] or full_counts["K1 bf16"]
            or full_counts["K2 f32"] != 1):
        raise AssertionError("the 48 kHz bf16 route disagrees or took K5")

    # the main paths' launches, each counted on one call: K2 and K3 through
    # their ops' precision=, K1 and K4 on predict_scores above (K4 has no
    # serving caller: its count there is 0)
    gpu_gmm.BF16_LAUNCHES = gpu_gmm.SERIAL_BF16_LAUNCHES = 0
    sb, x5, m5 = serial["timed"]
    gpu_gmm.batch_bank_avg_loglik(bench_bank, feats, mask, precision="bf16")
    gpu_gmm.bank_sum_loglik(sb, x5, m5, precision="bf16")
    torch.cuda.synchronize()
    launched = {"k1": slice_counts["K1 bf16"],
                "k4": slice_counts["K4 bf16"],
                "k2": gpu_gmm.BF16_LAUNCHES,
                "k3": gpu_gmm.SERIAL_BF16_LAUNCHES}

    # timing: each bf16 kernel beside its f32 mode and its plain version,
    # K6 bf16 at 66 and 144 outputs, predict_scores at both mm values, and
    # the yardstick of the tile's stage 1: cuBLAS's bf16 product of the
    # bench batch's frames, materialized, and D (torch.matmul on bf16
    # tensors; the port never calls it), in one interleaved set
    k6_66 = fused_args(fe8, bench_sig, bench_len, bench_bank)
    k6_144 = fused_args(fe144, bench_sig, bench_len, bench_bank)
    frames_b = fargs[0].to(torch.bfloat16)
    D_b = fe8.D.to(torch.bfloat16)
    t = time_interleaved({
        "k2_bf16": lambda: gpu_gmm.batch_bank_avg_loglik(
            bench_bank, feats, mask, precision="bf16"),
        "k2_f32": lambda: gpu_gmm.batch_bank_avg_loglik(bench_bank, feats,
                                                        mask),
        "k2_plain": lambda: gpu_gmm.batch_bank_avg_loglik_reference(
            bench_bank, feats, mask, precision="bf16"),
        "k3_bf16": lambda: gpu_gmm.bank_sum_loglik(sb, x5, m5,
                                                   precision="bf16"),
        "k3_f32": lambda: gpu_gmm.bank_sum_loglik(sb, x5, m5),
        "k3_plain": lambda: gpu_gmm.bank_sum_loglik_reference(
            sb, x5, m5, precision="bf16"),
        "k1_bf16": lambda: gpu_frontend.packed_from_signals(*pargs,
                                                            mm_bf16=True),
        "k1_f32": lambda: gpu_frontend.packed_from_signals(*pargs,
                                                           fft=fe8.fft),
        "k1_plain": lambda: gpu_frontend.packed_from_signals_reference(
            *pargs, mm_bf16=True),
        "k4_bf16": lambda: gpu_frontend.packed_from_frames(*fargs,
                                                           mm_bf16=True),
        "k4_f32": lambda: gpu_frontend.packed_from_frames(*fargs,
                                                          fft=fe8.fft),
        "k4_plain": lambda: gpu_frontend.packed_from_frames_reference(
            *fargs, mm_bf16=True),
        "k6_bf16": lambda: gpu_predict.fused_bank_predict(*k6_66,
                                                          mm_bf16=True),
        "k6_bf16_144": lambda: gpu_predict.fused_bank_predict(*k6_144,
                                                              mm_bf16=True),
        "stage1_cublas": lambda: torch.matmul(frames_b, D_b),
        "predict_bf16": lambda: fastpath.predict_scores(
            bench_sig, bench_len, bench_bank, BENCH_FS, mm="bf16"),
        "predict_f32": lambda: fastpath.predict_scores(
            bench_sig, bench_len, bench_bank, BENCH_FS)})
    del k6_66, k6_144, frames_b
    print(f"phase 21 [{card}] bf16 beside f32, ms (CUDA events, median of 7,"
          f" interleaved): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         t.items()), flush=True)
    k12 = occupancy(fe8.frame_len, fe8.frame_shift, nout8, B, T, d,
                    bench_bank)
    print(f"phase 21 [{card}] {k12}", flush=True)
    print(f"phase 21 [{card}] stage-1 yardstick, cuBLAS bf16 frames . D "
          f"{tuple(fargs[0].shape)} x {tuple(fe8.D.shape)}: "
          f"{t['stage1_cublas']:.4f} ms beside K1 bf16 {t['k1_bf16']:.4f} "
          f"and K1 f32 {t['k1_f32']:.4f} (the same trials)", flush=True)
    for name, fn in (
            ("K2 bf16", lambda: gpu_gmm.batch_bank_avg_loglik(
                bench_bank, feats, mask, precision="bf16")),
            ("K2 f32", lambda: gpu_gmm.batch_bank_avg_loglik(bench_bank,
                                                             feats, mask)),
            ("K3 bf16", lambda: gpu_gmm.bank_sum_loglik(sb, x5, m5,
                                                        precision="bf16")),
            ("K3 f32", lambda: gpu_gmm.bank_sum_loglik(sb, x5, m5))):
        print(f"phase 21 [{card}] {name}: {device_times(fn)}", flush=True)
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s", flush=True)

    # bounds from this run's shapes: the products of bf16 operands at the
    # bf16 tensor-core peak (K1 and K4: the dense product; its projection
    # onto W | A and the DCT, f32 by the JAX kernel, at the FP32 peak), or
    # the bytes
    valid = int(pargs[1].sum())
    SK = bench_bank.n_speakers * bench_bank.n_mixtures
    flen, ncols = fe8.D.shape
    nmel, nceps = fe8.dct.shape
    nac = fe8.A.shape[1]
    dft = 2 * flen * ncols  # the bf16 product
    proj = 2 * ncols * (nmel + nac) + 2 * nmel * nceps  # f32
    op_bytes = 4 * sum(x.numel() for x in (fe8.D, fe8.W, fe8.dct, fe8.A))
    rows = 2 * 2 * d * SK + 4 * SK
    n5 = int(m5.sum())
    SK5 = sb.n_speakers * sb.n_mixtures
    return [
        ("packed_frontend_bf16", "frontend_bf16.cu", "pallas_frontend.py:231",
         launched["k1"], err_k1, t["k1_bf16"], t["k1_plain"],
         bound(valid * proj, 4 * bench_sig.numel() + op_bytes
               + 4 * B * T * d, bf16_flops=valid * dft)),
        ("packed_from_frames_bf16", "frontend_bf16.cu",
         "pallas_frontend.py:111", launched["k4"], err_k4, t["k4_bf16"],
         t["k4_plain"],
         bound(B * T * proj, 4 * fargs[0].numel() + op_bytes
               + 4 * B * T * (nceps + nac), bf16_flops=B * T * dft)),
        ("bank_avg_loglik_bf16", "gmm_score_bf16.cu", "pallas_gmm.py:154",
         launched["k2"], err_k2, t["k2_bf16"], t["k2_plain"],
         bound(score_flops(valid, d, SK), 4 * feats.numel() + mask.numel()
               + rows + 4 * B * bench_bank.n_speakers, BF16_FLOPS)),
        ("bank_sum_loglik_bf16", "gmm_serial_bf16.cu", "pallas_gmm.py:47",
         launched["k3"], err_k3, t["k3_bf16"], t["k3_plain"],
         bound(score_flops(n5, d, SK5), 4 * x5.numel() + m5.numel()
               + 2 * 2 * d * SK5 + 4 * SK5 + 4 * sb.n_speakers, BF16_FLOPS)),
    ]


def check_signals(name, fe, sig, lengths, zero_frames=()) -> float:
    """A signal route's kernel vs its plain version on one batch, with the
    frontend's CMVN and LPC columns, two calls bitwise and two launches of
    its counter: mfcc_from_signals (csrc/frontend_full_signals.cu) for a
    FullFrontend, K1 in the frontend's mode for a PackedFrontend (its LPC
    cepstra with n_lpcc: csrc/frontend_lpcc_signals.cu, counted in
    LPCC_SIGNAL_LAUNCHES). `zero_frames`: (utterance, frame) pairs
    of a silent stretch whose LPC cepstra must be 0. Returns the max abs
    error of the features."""
    T = n_frames(sig.shape[1], fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(lengths, T)
    mask = torch.arange(T, device=sig.device) < nv[:, None]
    if isinstance(fe, FullFrontend):
        args = (sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, fe.cmvn,
                fe.n_lpcc)
        kernel = lambda: gpu_frontend.mfcc_from_signals(*args)  # noqa: E731
        want = gpu_frontend.mfcc_from_signals_reference(*args)
        counter = "FULL_SIGNAL_LAUNCHES"
    else:
        fa = frontend_args(fe, sig, lengths)
        kernel = lambda: gpu_frontend.packed_from_signals(  # noqa: E731
            *fa, fft=fe.fft, n_lpcc=fe.n_lpcc)
        want = gpu_frontend.packed_from_signals_fft_reference(
            sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, fe.cmvn, True,
            fe.n_lpcc)
        counter = "LPCC_SIGNAL_LAUNCHES" if fe.n_lpcc else "LAUNCHES"
    before = getattr(gpu_frontend, counter)
    got = kernel()
    again = kernel()
    launched = getattr(gpu_frontend, counter) - before
    torch.cuda.synchronize()
    nc = fe.dct.shape[1]
    d_mfcc, d_lpc, lpc_bad = feature_errors(got, want, mask, nc)
    bitwise = torch.equal(got, again)
    silent = all(bool((got[b, t, nc:] == 0).all()) for b, t in zero_frames)
    print(f"phase 22 {name} ({counter}) vs its plain version: shape "
          f"{tuple(got.shape)} valid frames {int(nv.sum())} mfcc max|d| "
          f"{d_mfcc:.3e} (tol {MFCC_ATOL}) lpc max|d| {d_lpc:.3e} (over tol: "
          f"{lpc_bad}) launches {launched} bitwise {bitwise}"
          + (f", LPC cepstra 0 on the {len(zero_frames)} silent frames: "
             f"{silent}" if zero_frames else ""), flush=True)
    if (got.shape != want.shape or not torch.isfinite(got).all()
            or (got[~mask] != 0).any() or d_mfcc > MFCC_ATOL or lpc_bad
            or launched != 2 or not bitwise or not silent):
        raise AssertionError(f"{name}: the signal kernel disagrees with its "
                             "plain version")
    return max(d_mfcc, d_lpc)


def silent_batch(rng, fe, lengths, Lp, dev):
    """signals_batch with a silent stretch of 4 frames early in the first
    utterance, and the (utterance, frame) pairs that lie wholly in it."""
    sig, lens = signals_batch(rng, lengths, Lp, dev)
    z0, z1 = 2 * fe.frame_shift, 2 * fe.frame_shift + 4 * fe.frame_len
    sig[0, z0:z1] = 0.0
    frames = [(0, t) for t in range(n_frames(Lp, fe.frame_len,
                                             fe.frame_shift))
              if t * fe.frame_shift >= z0
              and t * fe.frame_shift + fe.frame_len <= z1]
    return sig, lens, frames


def phase22(rng, dev, card, bench_sig, bench_len, fe8, bench_bank,
            t) -> list:
    """The full-spectrum frontend from the signals (mfcc_from_signals,
    csrc/frontend_full_signals.cu) and the LPC cepstra in the signal
    kernels' tail, against their plain versions at the serving shape and
    the shapes its tile takes; the 48 kHz and LPCC predicts' counters and
    kernels; the timing beside the routes they replace, composed of the
    pieces that remain; peak memory both ways. Returns the kernels line's
    two entries."""
    fcfg = FeatureConfig()
    lpcc_cfg = FeatureConfig(lpc=LPCC)
    L48 = int(FS48 * BENCH_SEC)
    fe48 = FullFrontend(FS48, fcfg, dev)
    sig48, len48, z48 = silent_batch(rng, fe48, [L48] * BENCH_B, padded(L48),
                                     dev)
    err = check_signals("512 x 5 s @ 48 kHz", fe48, sig48, len48)
    fe48c = FullFrontend(FS48, lpcc_cfg, dev)
    err = max(err, check_signals("48 kHz, n_lpcc 16, a silent stretch",
                                 fe48c, sig48[:64].contiguous(), len48[:64],
                                 z48))
    s44, l44 = signals_batch(rng, [44100 * 5, 44100 * 2, 30000, 1000],
                             padded(44100 * 5), dev)
    err = max(err, check_signals(
        "44.1 kHz (flen 1411, fshift 705), an utterance with no valid frame",
        FullFrontend(44100, fcfg, dev), s44, l44))
    s0, l0 = signals_batch(rng, [1000, 1535], padded(FS48), dev)
    err = max(err, check_signals("48 kHz, no valid frame in the batch",
                                 fe48, s0, l0))
    sub, lsub = sig48[:8].contiguous(), len48[:8]
    for n_fft in (4096, 8192, 16384):
        err = max(err, check_signals(
            f"48 kHz, fft_size {n_fft}",
            FullFrontend(FS48, FeatureConfig(mfcc=MfccConfig(
                fft_size=n_fft)), dev), sub, lsub))
    for n_filters, n_fft in ((128, 2048), (250, 4096), (600, 4096)):
        err = max(err, check_signals(
            f"48 kHz, fft_size {n_fft}, {n_filters} mel filters + LPC "
            f"({n_filters + 16} outputs)", FullFrontend(FS48, FeatureConfig(
                mfcc=MfccConfig(fft_size=n_fft, n_filters=n_filters)), dev),
            sub, lsub))
    # frames longer than the FFT: 3072 (96 kHz) and 6144 (192 kHz) samples
    # folded onto the default 2048 points
    for fs_f in (FS96, FS192):
        Lf = int(fs_f * 2.0)
        sf, lf = signals_batch(rng, [Lf, Lf // 2, 2000], padded(Lf), dev)
        fe_f = FullFrontend(fs_f, fcfg, dev)
        err = max(err, check_signals(
            f"{fs_f / 1e3:g} kHz (flen {fe_f.frame_len} folded onto "
            f"{fe_f.n_fft})", fe_f, sf, lf))
    fe8c = PackedFrontend(BENCH_FS, lpcc_cfg, dev)
    nout8c = fe8c.fft_mel.shape[1] + fe8c.fft_acorr.shape[1]
    s8, l8, z8 = silent_batch(rng, fe8c, [int(BENCH_FS * BENCH_SEC)]
                              * BENCH_B, bench_sig.shape[1], dev)
    err_lpcc = check_signals("K1 LPC-cepstra mode, 512 x 5 s @ 8 kHz, a "
                             "silent stretch", fe8c, s8, l8, z8)
    err_lpcc = max(err_lpcc, check_signals(
        "K1 LPC-cepstra mode, 16 kHz", PackedFrontend(16000, lpcc_cfg, dev),
        *signals_batch(rng, [48000, 20000, 300], padded(48000), dev)))

    # the predicts' launches: the frontend counters and K2 set to 0 just
    # before one call and read just after
    def drive(name, fs, cfg, sig, lens, want):
        bank = random_bank(rng, 4, 32, cfg.dim, dev, uniform_weights=True)
        reset_frontend_counts()
        gpu_gmm.LAUNCHES = 0
        scores = fastpath.predict_scores(sig, lens, bank, fs, cfg)
        torch.cuda.synchronize()
        got = {k: v for k, v in frontend_counts().items() if v}
        got["K2"] = gpu_gmm.LAUNCHES
        kernels = kernels_per_call(
            lambda: fastpath.predict_scores(sig, lens, bank, fs, cfg),
            calls=3)
        print(f"phase 22 {name}: scores {tuple(scores.shape)}, launches "
              f"{got}; by torch.profiler {sum(kernels.values()):g} device "
              f"kernels a call: {kernels}", flush=True)
        if got != want or not torch.isfinite(scores).all():
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        return got, kernels
    launched48, k48 = drive("predict_scores 512 x 5 s @ 48 kHz", FS48, fcfg,
                            sig48, len48,
                            {"FULL_SIGNAL_LAUNCHES": 1, "K2": 1})
    drive("predict_scores 64 x 5 s @ 48 kHz, n_lpcc 16", FS48, lpcc_cfg,
          sig48[:64].contiguous(), len48[:64],
          {"FULL_SIGNAL_LAUNCHES": 1, "K2": 1})
    launched_c, kc = drive("predict_scores 512 x 5 s @ 8 kHz, n_lpcc 16",
                           BENCH_FS, lpcc_cfg, s8, l8,
                           {"LPCC_SIGNAL_LAUNCHES": 1, "K2": 1})
    if dev.type == "cuda" and (
            k48.get("full_signals_kernel") != 1 or "fft_frames_kernel" in k48
            or kc.get("lpcc_signals_kernel") != 1
            or "packed_frontend_kernel" in kc or "lpcc_kernel" in kc):
        raise AssertionError("the predicts did not run their kernels once")

    # the routes they replace, composed of the pieces that remain: at 48
    # kHz torch's frames, K5 on them, the torch tail, K2; for LPCC K1's
    # raw mode, the torch tail, K2
    T48 = n_frames(sig48.shape[1], fe48.frame_len, fe48.frame_shift)
    mask48 = framing.frame_validity_mask(len48, T48, fe48.frame_len,
                                         fe48.frame_shift)
    bank48 = random_bank(rng, 4, 32, fcfg.dim, dev, uniform_weights=True)
    bank8 = random_bank(rng, 4, 32, lpcc_cfg.dim, dev, uniform_weights=True)

    def framing48():
        return framing.window_preemph(
            framing.frame_signal(sig48, fe48.frame_len, fe48.frame_shift),
            fe48.frame_len, fe48.pre_emph, fe48.preemph_first).reshape(
                BENCH_B * T48, fe48.frame_len)

    def k5_frames(wp):  # C and S for the CPU's plain version
        return gpu_frontend.mfcc_from_frames(wp, *dense_cs(fe48), fe48.mel,
                                             fe48.dct, fe48.floor,
                                             fe48.acorr, fe48.n_fft)

    def tail48(c, r):
        return fe48.finish(c.view(BENCH_B, T48, -1), r.view(BENCH_B, T48, -1),
                           mask48)

    def predict48_frames():
        f, m = tail48(*k5_frames(framing48()))
        return gpu_gmm.batch_bank_avg_loglik(bank48, f, m)

    raw_args = frontend_args(fe8c, s8, l8)
    T8 = n_frames(s8.shape[1], fe8c.frame_len, fe8c.frame_shift)
    mask8 = framing.frame_validity_mask(l8, T8, fe8c.frame_len,
                                        fe8c.frame_shift)

    def k1_raw():
        return gpu_frontend.packed_from_signals(*raw_args, fft=fe8c.fft,
                                                fuse_lpc=False)

    def lpcc_predict_raw():
        f, m = fe8c.finish(*k1_raw(), mask8, cmvn_done=True)
        return gpu_gmm.batch_bank_avg_loglik(bank8, f, m)

    wp48 = framing48()
    c48, r48 = k5_frames(wp48)
    f48, m48 = tail48(c48, r48)
    sig_args = (sig48, fe48.valid_frames(len48, T48), fe48.fft, fe48.dct,
                fe48.floor, fe48.frame_shift, fe48.cmvn, 0)
    raw_c, raw_r = k1_raw()
    k1_lpcc = lambda: gpu_frontend.packed_from_signals(  # noqa: E731
        *raw_args, fft=fe8c.fft, n_lpcc=16)
    signals48 = lambda: gpu_frontend.mfcc_from_signals(  # noqa: E731
        *sig_args)
    # the LPC-cepstra mode on the card: its kernel and the CMVN kernel,
    # nothing else (no raw tile, no lpcc_kernel), by torch.profiler
    k1c = kernels_per_call(k1_lpcc, calls=3)
    print(f"phase 22 K1's LPC-cepstra mode, 512 x 5 s @ 8 kHz, by "
          f"torch.profiler: {sum(k1c.values()):g} device kernels a call: "
          f"{k1c}", flush=True)
    if dev.type == "cuda" and k1c != {"lpcc_signals_kernel": 1.0,
                                      "cmvn_kernel": 1.0}:
        raise AssertionError("K1's LPC-cepstra mode ran other kernels")
    # the kernels in sets of one rate each, the end-to-end routes beside
    # the earlier ones in one interleaved set, the host-bound torch tails
    # alone; every kernel's arguments made before its trials, as phase 5
    # makes K1's
    lpc_args = frontend_args(fe8, bench_sig, bench_len)
    t.update({f"p22_{k}": v for k, v in time_interleaved({
        "k1_lpcc": k1_lpcc,
        "k1_raw": k1_raw,
        "k1_lpc": lambda: gpu_frontend.packed_from_signals(*lpc_args,
                                                           fft=fe8.fft),
        "lpcc_predict": lambda: fastpath.predict_scores(s8, l8, bank8,
                                                        BENCH_FS, lpcc_cfg),
    }, *SIGNAL_TRIALS).items()})
    t.update({f"p22_{k}": v for k, v in time_interleaved({
        "framing48": framing48,
        "k5_frames48": lambda: k5_frames(wp48),
        "signals48": signals48,
        "k2_48": lambda: gpu_gmm.batch_bank_avg_loglik(bank48, f48, m48),
    }, *SIGNAL_TRIALS).items()})
    t.update({f"p22_{k}": v for k, v in time_interleaved({
        "predict48": lambda: fastpath.predict_scores(sig48, len48, bank48,
                                                     FS48, fcfg),
        "predict48_frames": predict48_frames,
        "lpcc_predict_raw": lpcc_predict_raw,
    }, *SIGNAL_TRIALS).items()})
    t["p22_tail48"] = time_ms(lambda: tail48(c48, r48), *SIGNAL_TRIALS)
    t["p22_lpcc_tail"] = time_ms(
        lambda: fe8c.finish(raw_c, raw_r, mask8, cmvn_done=True),
        *SIGNAL_TRIALS)
    del wp48, c48, r48, f48, m48, raw_c, raw_r
    for name, fn in (("the signal kernel at 48 kHz", signals48),
                     ("K1's LPC-cepstra mode at 8 kHz", k1_lpcc)):
        print(f"phase 22 [{card}] {name}, by kernel (torch.profiler): "
              f"{device_times(fn)}", flush=True)
    t["p22_signals48_plain"] = time_ms(
        lambda: gpu_frontend.mfcc_from_signals_reference(*sig_args), trials=3)
    t["p22_k1_lpcc_plain"] = time_ms(
        lambda: gpu_frontend.packed_from_signals_fft_reference(
            s8, raw_args[1], fe8c.fft, fe8c.dct, fe8c.floor,
            fe8c.frame_shift, True, True, 16), trials=3)
    # peak device memory above what the call's inputs hold, both ways
    peaks = {}
    for k, fn in (("signals", lambda: fastpath.predict_scores(
            sig48, len48, bank48, FS48, fcfg)), ("frames", predict48_frames)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks[k] = torch.cuda.max_memory_allocated() - base
    frame_bytes = 4 * BENCH_B * T48 * fe48.frame_len
    rate = lambda ms: BENCH_B * BENCH_SEC / (ms / 1e3)  # noqa: E731
    print(f"phase 22 [{card}] predict_scores 512 x 5 s @ 48 kHz on the "
          f"signal kernel: {t['p22_predict48']:.3f} ms = "
          f"{rate(t['p22_predict48']):.0f} audio-s/s; the frame route "
          f"composed {t['p22_predict48_frames']:.3f} ms, its pieces each "
          f"timed alone (a host-bound piece reads its enqueue time, which "
          f"in the route overlaps the kernels before it): framing + window "
          f"{t['p22_framing48']:.3f}, K5 on the frames "
          f"{t['p22_k5_frames48']:.3f}, the torch tail (CMVN, Levinson, "
          f"masking) {t['p22_tail48']:.3f}, K2 {t['p22_k2_48']:.3f}; the "
          f"signal kernel alone {t['p22_signals48']:.3f} ms, its plain "
          f"version {t['p22_signals48_plain']:.3f} ms", flush=True)
    nout48 = fe48.mel.shape[1] + fe48.acorr.shape[1]
    print(f"phase 22 [{card}] the signal kernel against K5 on the same "
          f"frames (csrc/frontend_fft.cu), in the same interleaved trials: "
          f"{t['p22_signals48']:.3f} ms against {t['p22_k5_frames48']:.3f} "
          f"(ratio {t['p22_signals48'] / t['p22_k5_frames48']:.3f}); "
          f"full_signals_kernel<{fe48.n_fft}, 9>: "
          f"{signal_occupancy(fe48.n_fft, nout48)}", flush=True)
    print(f"phase 22 [{card}] peak device memory of a 48 kHz predict above "
          f"its inputs: signal route {peaks['signals'] / 1e6:.1f} MB, frame "
          f"route {peaks['frames'] / 1e6:.1f} MB (one [B, T, flen] f32 "
          f"tensor: {frame_bytes / 1e6:.1f} MB)", flush=True)
    print(f"phase 22 [{card}] K1's LPC-cepstra mode (csrc/"
          f"frontend_lpcc_signals.cu), 512 x 5 s @ 8 kHz: "
          f"{t['p22_k1_lpcc']:.3f} ms, its plain version "
          f"{t['p22_k1_lpcc_plain']:.3f} ms; in the same interleaved trials "
          f"K1's LPC mode (the 8 kHz main path) {t['p22_k1_lpc']:.3f} ms "
          f"(ratio {t['p22_k1_lpcc'] / t['p22_k1_lpc']:.3f}; "
          f"{t['frontend']:.3f} ms in phase 5), K1's raw mode "
          f"{t['p22_k1_raw']:.3f} ms and predict_scores with n_lpcc 16 "
          f"{t['p22_lpcc_predict']:.3f} ms; lpcc_signals_kernel<"
          f"{fe8c.n_fft}, 9>: {signal_occupancy(fe8c.n_fft, nout8c, 'lpcc')}",
          flush=True)
    print(f"phase 22 [{card}] predict_scores 512 x 5 s @ 8 kHz, n_lpcc 16, "
          f"the raw mode + torch tail composed "
          f"{t['p22_lpcc_predict_raw']:.3f} ms (K1 raw {t['p22_k1_raw']:.3f}"
          f", tail {t['p22_lpcc_tail']:.3f})", flush=True)
    if dev.type == "cuda" and peaks["signals"] >= frame_bytes:
        raise AssertionError("the 48 kHz predict allocated a frame tensor")

    B8, Lp8 = s8.shape
    nmel, nceps = fe8c.dct.shape
    nac = fe8c.fft_acorr.shape[1]
    op_bytes = lambda *xs: 4 * sum(x.numel() for x in xs)  # noqa: E731
    v48 = int(sig_args[1].sum())
    # the kernel's projection runs on the TF32 tensor cores in three terms
    # (hi.hi + hi.lo + lo.hi); the rest of its work on the FP32 pipes
    proj48 = projection_flops(v48, fe48.n_fft, (fe48.mel, fe48.acorr))
    b48 = bound(frontend_flops(v48, fe48.n_fft, (fe48.mel, fe48.acorr),
                               fe48.dct.shape[1],
                               order=fe48.acorr.shape[1] - 1,
                               window=3 * fe48.frame_len) - proj48,
                4 * sig48.numel() + 4 * BENCH_B * T48 * fcfg.dim
                + op_bytes(fe48.mel, fe48.acorr, fe48.dct),
                tf32_flops=3 * proj48)
    v8 = int(raw_args[1].sum())
    # the recursion: about n_lpcc * order multiply-adds a frame; the
    # projection on the TF32 tensor cores in three terms, as K5's
    ops8 = (fe8c.fft_mel, fe8c.fft_acorr)
    proj8 = projection_flops(v8, fe8c.n_fft, ops8)
    b8 = bound(frontend_flops(v8, fe8c.n_fft, ops8, nceps, order=nac - 1,
                              window=3 * fe8c.frame_len) - proj8
               + v8 * 2 * 16 * (nac - 1),
               4 * s8.numel() + 4 * B8 * T8 * lpcc_cfg.dim
               + op_bytes(fe8c.fft_mel, fe8c.fft_acorr, fe8c.dct),
               tf32_flops=3 * proj8)
    for k, b in (("mfcc_from_signals", b48), ("packed_frontend_lpcc", b8)):
        print(f"phase 22 [{card}] bound of {k}: {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})", flush=True)
    return [("mfcc_from_signals", "frontend_full_signals.cu",
             "pallas_frontend.py:50", launched48["FULL_SIGNAL_LAUNCHES"], err,
             t["p22_signals48"], t["p22_signals48_plain"], b48),
            ("packed_frontend_lpcc", "frontend_lpcc_signals.cu",
             "pallas_frontend.py:231", launched_c["LPCC_SIGNAL_LAUNCHES"],
             err_lpcc, t["p22_k1_lpcc"], t["p22_k1_lpcc_plain"], b8)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    seed = args.seed
    t_start = time.perf_counter()
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
    # ptxas -v, in short: the kernels' register range and every kernel
    # that spills (the whole log lies beside the library)
    with open(_build.build_log) as f:
        log = f.read()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"Compiling entry function '(\w+)'[^\n]*\n[^\n]*\n"
                        r"\s*(\d+ bytes stack frame, [1-9]\d* bytes spill "
                        r"stores, \d+ bytes spill loads)", log)
    # each source's nvcc, all started together: the slowest sets the build
    secs = [(os.path.basename(src), float(sec)) for src, sec in re.findall(
        r"^== (\S+) \(([\d.]+) s\)$", log, re.M)]
    slowest = max(secs, key=lambda x: x[1], default=("-", 0.0))
    print(f"phase 1 build: {_build.build_seconds:.1f} s "
          f"({os.path.basename(_build.build_log)[:-4]}.so), {len(secs)} "
          f"sources (slowest {slowest[0]} {slowest[1]:.1f} s), {len(regs)} "
          f"kernels, {min(regs, default=0)}-{max(regs, default=0)} "
          f"registers, {len(spills)} with spills", flush=True)
    for name, spill in spills:
        print(f"  ptxas: {name[:120]}: {spill}")
    print("phase 1 build by source (all started together): " + ", ".join(
        f"{src} {sec:.1f} s" for src, sec in secs), flush=True)

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
    # n_fft 1024 > 2 * frame_len 704
    fe11 = PackedFrontend(11025, fcfg, dev)
    s11, l11 = signals_batch(rng, [11025, 7000, 300], padded(11025), dev)
    err_fe = max(err_fe, check_frontend(
        f"11.025 kHz (flen {fe11.frame_len}, n_fft {fe11.n_fft})", fe11, s11,
        l11))
    # frame_len 705 (odd), shift 352: n_fft 2048
    fe22 = PackedFrontend(22050, fcfg, dev)
    s22, l22 = signals_batch(rng, [22050, 15000], padded(22050), dev)
    err_fe = max(err_fe, check_frontend(
        f"22.05 kHz (flen {fe22.frame_len}, fshift {fe22.frame_shift})", fe22,
        s22, l22))
    # a 4096-point FFT: 44.1 and 48 kHz frames with fft_size 4096 take the
    # packed route (16-frame tiles)
    s48p, l48p = signals_batch(rng, [FS48, 30000, 2000], padded(FS48), dev)
    s44p, l44p = signals_batch(rng, [44100, 20000], padded(44100), dev)
    for fs_p, sig_p, len_p in ((FS48, s48p, l48p), (44100, s44p, l44p)):
        fe_p = PackedFrontend(fs_p, FFT4096, dev)
        err_fe = max(err_fe, check_frontend(
            f"{fs_p / 1e3:g} kHz, fft_size 4096 (flen {fe_p.frame_len}, "
            f"n_fft {fe_p.n_fft})", fe_p, sig_p, len_p))
    # 8192- and 16384-point FFTs (4- and 2-frame tiles): 96 kHz with
    # fft_size 8192 and 192 kHz with fft_size 16384, ragged batches
    L96, L192 = int(FS96 * HIGH_SEC), int(FS192 * HIGH_SEC)
    s96, l96 = signals_batch(
        rng, [L96 - int(rng.randint(0, L96 * 3 // 5))
              for _ in range(BIG_B - 1)] + [L96], padded(L96), dev)
    s192, l192 = signals_batch(
        rng, [L192 - int(rng.randint(0, L192 * 3 // 5))
              for _ in range(HUGE_B - 1)] + [L192], padded(L192), dev)
    fe96 = PackedFrontend(FS96, FFT8192, dev)
    fe192 = PackedFrontend(FS192, FFT16384, dev)
    for fs_p, fe_p, sig_p, len_p in ((FS96, fe96, s96, l96),
                                     (FS192, fe192, s192, l192)):
        err_fe = max(err_fe, check_frontend(
            f"{fs_p / 1e3:g} kHz, fft_size {fe_p.n_fft}, {sig_p.shape[0]} x "
            f"{HIGH_SEC:g} s (flen {fe_p.frame_len}, n_fft {fe_p.n_fft})",
            fe_p, sig_p, len_p))
    # 250 mel filters + LPC-15: 266 outputs, the fourth operator width
    err_fe = max(err_fe, check_frontend(
        "48 kHz, fft_size 4096, 250 mel filters + LPC (266 outputs)",
        PackedFrontend(FS48, WIDE266, dev), s48p, l48p))
    # 64 mel + 16 autocorrelation outputs take the kernel's other tiling;
    # 128 + 16 its widest (256 columns)
    for n_filters in (64, 128):
        fe_w = PackedFrontend(BENCH_FS, FeatureConfig(mfcc=MfccConfig(
            n_filters=n_filters)), dev)
        err_fe = max(err_fe, check_frontend(
            f"8 kHz, {n_filters} mel filters + LPC", fe_w, bench_sig[:4],
            bench_len[:4]))
    # LPC order 40 and 40 cepstra: the Levinson and CMVN past 32
    fe40 = PackedFrontend(BENCH_FS, ORDER40, dev)
    err_fe = max(err_fe, check_frontend(
        "8 kHz, LPC order 40, 40 cepstra", fe40, bench_sig[:16],
        bench_len[:16]))
    # one utterance: GMMSet's serial decisions
    err_fe = max(err_fe, check_frontend(
        "one 5 s utterance", fe8, bench_sig[:1].contiguous(), bench_len[:1]))
    # the raw-autocorrelation mode, which serves the LPC cepstra
    lpcc_cfg = FeatureConfig(lpc=LPCC)
    fe8c = PackedFrontend(BENCH_FS, lpcc_cfg, dev)
    err_raw = check_frontend_raw("raw autocorrelation, bench 512 x 5 s @ "
                                 "8 kHz", fe8c, bench_sig, bench_len)
    for fs_c, sig_c, len_c in ((16000, s16, l16), (22050, s22, l22)):
        err_raw = max(err_raw, check_frontend_raw(
            f"raw autocorrelation, {fs_c / 1e3:g} kHz",
            PackedFrontend(fs_c, lpcc_cfg, dev), sig_c, len_c))
    err_raw = max(err_raw, check_frontend_raw(
        "raw autocorrelation, 48 kHz, fft_size 4096",
        PackedFrontend(FS48, FeatureConfig(mfcc=FFT4096.mfcc, lpc=LPCC),
                       dev), s48p, l48p))
    fe96c = PackedFrontend(FS96, FeatureConfig(mfcc=FFT8192.mfcc, lpc=LPCC),
                           dev)
    err_raw = max(err_raw, check_frontend_raw(
        "raw autocorrelation, 96 kHz, fft_size 8192", fe96c, s96, l96))

    # 3. bank-scoring kernel vs plain, on real features
    feats, mask = fe8(bench_sig, bench_len)
    d = fcfg.dim
    bench_bank = random_bank(rng, 4, 32, d, dev, uniform_weights=True)
    err_gmm = check_scoring("bench bank 4 x 32, B=512", bench_bank, feats, mask)
    ubm_bank = random_bank(rng, 80, 256, d, dev)
    err_gmm = max(err_gmm, check_scoring(
        "UBM-scale bank 80 x 256, B=8", ubm_bank, feats[:8].contiguous(),
        mask[:8].contiguous()))
    # more components than one block's shared memory holds at once
    k1024_bank = random_bank(rng, 4, 1024, d, dev)
    f64, m64 = feats[:64].contiguous(), mask[:64].contiguous()
    err_gmm = max(err_gmm, check_scoring("bank 4 x 1024, B=64", k1024_bank,
                                         f64, m64))
    # d = 102: bob's 19 cepstra + LPC-15 with two deltas, the tensor route
    # in chunks of 8 k-steps
    cfg102 = FeatureConfig(mfcc=bob_mfcc_config(), n_deltas=2)
    f102, m102 = extract.extract_batch(s16, l16, 16000, cfg102)
    bank102 = random_bank(rng, 4, 32, cfg102.dim, dev)
    err_gmm = max(err_gmm, check_scoring(
        f"bank 4 x 32 at d = {cfg102.dim} (16 kHz)", bank102, f102, m102))
    # the checks of K2's routes below draw from a stream of their own, so
    # that the phases after them see the same data as without them
    k2_rng = np.random.RandomState(args.seed + 1)
    # d = 200: past the tensor route, one frame a lane (the wide route)
    f200 = torch.from_numpy(k2_rng.randn(16, 311, 200).astype(
        np.float32)).to(dev)
    err_gmm = max(err_gmm, check_scoring(
        "bank 4 x 32 at d = 200 (the wide route)",
        random_bank(k2_rng, 4, 32, 200, dev), f200,
        torch.ones((16, 311), dtype=torch.bool, device=dev)))
    # a contiguous view one float into its storage: rows off the 16-byte
    # boundary the vector loads need
    err_gmm = max(err_gmm, check_scoring(
        "bench bank 4 x 32, B=64, features 4 bytes off alignment",
        bench_bank, off_alignment(f64), m64))
    # the benchmark cells' banks on CMVN'd-scale features, one frame far
    # from every mean (under the -745 floor)
    cell_x = torch.from_numpy(k2_rng.randn(
        BENCH_B, CELL_FRAMES, CELL_DIM).astype(np.float32)).to(dev)
    cell_x[0, 3] = 40.0
    cell_m = torch.ones((BENCH_B, CELL_FRAMES), dtype=torch.bool, device=dev)
    cell_banks = {}
    for S_c, K_c in CELL_BANKS:
        cell_banks[S_c, K_c] = random_bank(k2_rng, S_c, K_c, CELL_DIM, dev)
        err_gmm = max(err_gmm, check_scoring(
            f"a benchmark cell's bank {S_c} x {K_c} at d = {CELL_DIM}, "
            f"{BENCH_B} x {CELL_FRAMES} frames", cell_banks[S_c, K_c],
            cell_x, cell_m, f64_gate=True))

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
        "frontend": time_ms(lambda: gpu_frontend.packed_from_signals(
            *fe_args, fft=fe8.fft)),
        "frontend_plain": time_ms(
            lambda: gpu_frontend.packed_from_signals_reference(*fe_args)),
        "frontend_plain_fft": time_ms(
            lambda: gpu_frontend.packed_from_signals_fft_reference(
                fe_args[0], fe_args[1], fe8.fft, fe8.dct, fe8.floor,
                fe8.frame_shift, fe8.cmvn)),
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
    t["gmm_k1024"] = time_ms(lambda: gpu_gmm.batch_bank_avg_loglik(
        k1024_bank, f64, m64))
    t["gmm_k1024_plain"] = time_ms(
        lambda: gpu_gmm.batch_bank_avg_loglik_reference(k1024_bank, f64, m64))
    rate = BENCH_B * BENCH_SEC / (t["predict"] / 1e3)
    print(f"phase 5 [{card}] predict_scores 512 x 5 s, 4 x 32 bank: "
          f"{t['predict']:.3f} ms = {rate:.0f} audio-s/s", flush=True)
    for k in ("frontend", "gmm"):
        print(f"phase 5 [{card}] {k} kernel {t[k]:.3f} ms, plain "
              f"{t[k + '_plain']:.3f} ms (bench geometry)")
    print(f"phase 5 [{card}] frontend FFT route plain "
          f"{t['frontend_plain_fft']:.3f} ms (bench geometry)")
    print(f"phase 5 [{card}] gmm kernel, bench geometry: " + device_times(
        lambda: gpu_gmm.batch_bank_avg_loglik(bench_bank, feats, mask)))
    print(f"phase 5 [{card}] gmm kernel 80 x 256 bank, B=8: "
          f"{t['gmm_ubm']:.3f} ms, plain {t['gmm_ubm_plain']:.3f} ms; "
          f"4 x 1024 bank, B=64: {t['gmm_k1024']:.3f} ms, plain "
          f"{t['gmm_k1024_plain']:.3f} ms")
    # K2's tensor route at the benchmark cells' shapes; its bound the three
    # TF32 passes of the product at the TF32 peak (perfbench/yardstick)
    for (S_c, K_c), cbank in cell_banks.items():
        k2_before = (gpu_gmm.TENSOR_LAUNCHES, gpu_gmm.LAUNCHES)
        k2 = time_ms(lambda: gpu_gmm.batch_bank_avg_loglik(cbank, cell_x,
                                                            cell_m))
        on_route = (gpu_gmm.TENSOR_LAUNCHES - k2_before[0],
                    gpu_gmm.LAUNCHES - k2_before[1])
        plain = time_ms(lambda: gpu_gmm.batch_bank_avg_loglik_reference(
            cbank, cell_x, cell_m))
        b = bound(0.0, 4.0 * BENCH_B * CELL_FRAMES * (CELL_DIM + 1),
                  tf32_flops=3 * 4.0 * CELL_DIM * S_c * K_c * BENCH_B
                  * CELL_FRAMES)
        print(f"phase 5 [{card}] K2 tensor route {S_c} x {K_c} bank, d = "
              f"{CELL_DIM}, {BENCH_B} x {CELL_FRAMES} frames: {k2:.3f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{100 * b['bound_ms'] / k2:.1f}% of it), plain {plain:.3f} ms; "
              f"tensor-route launches {on_route[0]} of {on_route[1]}",
              flush=True)
        if on_route[0] != on_route[1] or on_route[0] < 1:
            raise AssertionError(f"K2 at {S_c} x {K_c}: {on_route[0]} of "
                                 f"{on_route[1]} launches on the tensor route")

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
            ("one speaker", random_bank(rng, 1, 32, d, dev), x5, m5, False),
            ("features 4 bytes off alignment", serial_banks["bench"],
             off_alignment(x5), m5, False),
            ("1024 components + UBM", random_bank(rng, 5, 1024, d, dev), x5,
             m5, False),
            ("1024 components + UBM, 150 s clip (rows restaged for each "
             "chunk of frames)", random_bank(rng, 5, 1024, d, dev), x150,
             m150, False),
            (f"d = {cfg102.dim}, 3 s @ 16 kHz",
             random_bank(rng, 5, 32, cfg102.dim, dev),
             *utterance(f102[0], int(m102[0].sum()), dev), False),
            ("d = 200 (frame left in device memory)",
             random_bank(rng, 5, 32, 200, dev),
             *utterance(torch.from_numpy(rng.randn(311, 200).astype(
                 np.float32)), 311, dev), False)):
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
    # a feature dimension past 96, which the serial kernel used to refuse
    open_set("phase 8 open set @ 16 kHz, bob's MFCC + LPC + two deltas",
             16000, PipelineConfig(features=cfg102), dev, n_mixtures=8)

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
    print(f"phase 9 [{card}] serial kernel, bench bank + UBM, 5 s: "
          + device_times(lambda: gpu_gmm.bank_avg_loglik(sb, x5, m5)))
    print(f"phase 9 [{card}] serial kernel, 80 x 256 + UBM, 3 s: "
          f"{t['serial_ubm']:.4f} ms, plain {t['serial_ubm_plain']:.4f} ms")
    print(f"phase 9 [{card}] predict_with_rejection, one 5 s utterance: "
          f"{t['reject']:.3f} ms")
    print(f"phase 9 [{card}] ModelInterface.train, 3 speakers x 12 s, "
          f"GMM-32: {t['train']:.3f} ms, {tl['iterations']} iterations, "
          f"{tl['host_syncs']} host syncs", flush=True)

    # 10. full-spectrum kernel vs plain
    err_full = err_chirp = 0.0
    L48 = int(FS48 * BENCH_SEC)
    lens48 = [L48 - int(rng.randint(0, 3 * FS48)) for _ in range(63)] + [L48]
    fe48 = FullFrontend(FS48, fcfg, dev)
    s48, l48 = signals_batch(rng, lens48, padded(L48), dev)
    err_full = check_frames(10, "64 x 5 s @ 48 kHz, ragged", fe48, s48, l48)
    del s48, l48
    fe44 = FullFrontend(44100, fcfg, dev)
    s44, l44 = signals_batch(rng, [44100, 30000, 5000], padded(44100), dev)
    s48b, l48b = signals_batch(rng, [FS48, 40000], padded(FS48), dev)
    err_full = max(err_full, check_frames(
        10, f"44.1 kHz (flen {fe44.frame_len}, fshift {fe44.frame_shift})",
        fe44, s44, l44))
    fe256 = FullFrontend(BENCH_FS, FeatureConfig(
        mfcc=MfccConfig(fft_size=256)), dev)
    err_full = max(err_full, check_frames(
        10, "8 kHz, fft_size 256", fe256, bench_sig[:8], bench_len[:8]))
    # a frame of 512 samples folds onto the 256-point FFT
    err_full = max(err_full, check_frames(
        10, "16 kHz, fft_size 256 (frame 512 > fft)", FullFrontend(
            16000, FeatureConfig(mfcc=MfccConfig(fft_size=256)), dev), s16,
        l16))
    # not a power of two: the chirp-z kernel, on its own counter, also with
    # 128 mel filters + LPC (144 outputs); 44.1 kHz with fft_size 1411 (the
    # frame: M = 4096) and a 48 kHz frame folded onto fft_size 1000 (M =
    # 2048)
    for n_filters in (50, 128):
        err_chirp = max(err_chirp, check_frames(
            10, f"8 kHz, fft_size 1500, {n_filters} mel filters (chirp-z "
            "kernel)", FullFrontend(BENCH_FS, FeatureConfig(mfcc=MfccConfig(
                fft_size=1500, n_filters=n_filters)), dev),
            bench_sig[:8], bench_len[:8]))
    for fs_c, n_c, sig_c, len_c in ((44100, 1411, s44, l44),
                                    (FS48, 1000, s48b, l48b)):
        fe_c = FullFrontend(fs_c, FeatureConfig(mfcc=MfccConfig(
            fft_size=n_c)), dev)
        err_chirp = max(err_chirp, check_frames(
            10, f"{fs_c / 1e3:g} kHz, fft_size {n_c} (flen "
            f"{fe_c.frame_len}, M {gpu_frontend.chirp_size(n_c, fe_c.frame_len)}"
            ", chirp-z kernel)", fe_c, sig_c, len_c))
    # a 4096-point FFT (16-frame tiles), and 144 outputs (256 columns)
    for fs_p, sig_p, len_p in ((FS48, s48p, l48p), (44100, s44p, l44p)):
        err_full = max(err_full, check_frames(
            10, f"{fs_p / 1e3:g} kHz, fft_size 4096",
            FullFrontend(fs_p, FFT4096, dev), sig_p, len_p))
    err_full = max(err_full, check_frames(
        10, "48 kHz, 128 mel filters + LPC", FullFrontend(
            FS48, FeatureConfig(mfcc=MfccConfig(n_filters=128)), dev), s48p,
        l48p))
    err_full = max(err_full, check_frames(
        10, "48 kHz, fft_size 4096, 250 mel filters + LPC (266 outputs)",
        FullFrontend(FS48, WIDE266, dev), s48p, l48p))
    # 8192- and 16384-point FFTs; at 192 kHz fft_size 8192 is the default
    # route (8192 < 2 * frame_len), a frame of 6144 samples
    sfull, lfull = s96[:4].contiguous(), l96[:4]
    s192f, l192f = s192[:2].contiguous(), l192[:2]
    for fs_p, cfg_p, sig_p, len_p in ((FS96, FFT8192, sfull, lfull),
                                      (FS192, FFT16384, s192f, l192f),
                                      (FS192, FFT8192, s192f, l192f)):
        err_full = max(err_full, check_frames(
            10, f"{fs_p / 1e3:g} kHz, fft_size {cfg_p.mfcc.fft_size}",
            FullFrontend(fs_p, cfg_p, dev), sig_p, len_p))
    os.environ["SRTPU_FRONTEND"] = "full"
    fe_env = extract.frontend(BENCH_FS, fcfg, dev)
    del os.environ["SRTPU_FRONTEND"]
    if not isinstance(fe_env, FullFrontend):
        raise AssertionError("SRTPU_FRONTEND=full did not take the full route")
    err_full = max(err_full, check_frames(
        10, "8 kHz, SRTPU_FRONTEND=full", fe_env, bench_sig[:8],
        bench_len[:8]))
    for name, cfg in (("bob's config @ 48 kHz",
                       FeatureConfig(mfcc=bob_mfcc_config())),
                      ("MFCC only @ 48 kHz", FeatureConfig(use_lpc=False))):
        err_full = max(err_full, check_frames(
            10, name, FullFrontend(FS48, cfg, dev), s48b, l48b))
    s0, l0 = signals_batch(rng, [FS48, 1000], padded(FS48), dev)
    err_full = max(err_full, check_frames(
        10, "an utterance with no valid frame @ 48 kHz", fe48, s0, l0))

    # 11. frame-level packed kernel vs plain, LPC cepstra: its own path,
    # which no serving route takes any more (check_frames demands both of
    # its launches; the kernels record reads the serving count, 0)
    dense_before = gpu_frontend.FULL_DENSE_LAUNCHES
    err_frames = check_frames(11, "bench 512 x 5 s @ 8 kHz, n_lpcc 16", fe8c,
                              bench_sig, bench_len)
    err_frames = max(err_frames, check_frames(
        11, "16 kHz, n_lpcc 16", PackedFrontend(16000, lpcc_cfg, dev), s16,
        l16))
    err_frames = max(err_frames, check_frames(
        11, "96 kHz, fft_size 8192, n_lpcc 16", fe96c, sfull, lfull))
    err_frames = max(err_frames, check_frames(
        11, "192 kHz, fft_size 16384, n_lpcc 16", PackedFrontend(
            FS192, FeatureConfig(mfcc=FFT16384.mfcc, lpc=LPCC), dev), s192f,
        l192f))
    err_frames = max(err_frames, check_frames(
        11, "48 kHz, fft_size 4096, 250 mel filters, n_lpcc 16",
        PackedFrontend(FS48, FeatureConfig(mfcc=WIDE266.mfcc, lpc=LPCC), dev),
        s48p, l48p))
    if gpu_frontend.FULL_DENSE_LAUNCHES != dense_before:
        raise AssertionError("the frame-level packed frontend ran a dense "
                             "product")
    # serving sends LPC cepstra through K1's LPC-cepstra kernel (csrc/
    # frontend_lpcc_signals.cu), never K1's tile or K4
    before = (gpu_frontend.LPCC_SIGNAL_LAUNCHES, gpu_frontend.FRAMES_LAUNCHES,
              gpu_frontend.LAUNCHES)
    feats_c, mask_c = extract.extract_batch(bench_sig, bench_len, BENCH_FS,
                                            lpcc_cfg)
    routed = (gpu_frontend.LPCC_SIGNAL_LAUNCHES - before[0],
              gpu_frontend.FRAMES_LAUNCHES - before[1],
              gpu_frontend.LAUNCHES - before[2])
    plain_c, plain_m = fe8c.finish(
        *gpu_frontend.packed_from_signals_reference(
            *frontend_args(fe8c, bench_sig, bench_len), fuse_lpc=False),
        framing.frame_validity_mask(bench_len, feats_c.shape[1],
                                    fe8c.frame_len, fe8c.frame_shift),
        cmvn_done=True)
    d_mfcc, d_lpcc, lpcc_bad = feature_errors(feats_c, plain_c, mask_c,
                                              fcfg.mfcc.n_ceps)
    print(f"phase 11 extract_batch, n_lpcc 16: features "
          f"{tuple(feats_c.shape)} vs the plain route: mfcc max|d| "
          f"{d_mfcc:.3e} (tol {MFCC_ATOL}) lpcc max|d| {d_lpcc:.3e} (over "
          f"tol: {lpcc_bad}); K1's tile launches {routed[2]}; launches K1 "
          f"{routed[0]}, K4 {routed[1]}", flush=True)
    if (feats_c.shape[-1] != lpcc_cfg.dim or not torch.equal(mask_c, plain_m)
            or not torch.isfinite(feats_c).all() or d_mfcc > MFCC_ATOL
            or lpcc_bad or routed != (1, 0, 0)):
        raise AssertionError("extract_batch with LPC cepstra")
    del feats_c, mask_c, plain_c, plain_m

    # 12. slice 3 through the entry points on the card
    exp48 = synth.expected(synth.EXPECTED48)
    utts48 = synth.fixture_utterances(exp48)
    truth48 = [u["label"] for u in exp48["utterances"]]
    gpu_frontend.LAUNCHES = gpu_frontend.FRAMES_LAUNCHES = 0
    gpu_frontend.FULL_LAUNCHES = gpu_frontend.FULL_DENSE_LAUNCHES = 0
    gpu_frontend.FULL_SIGNAL_LAUNCHES = 0
    gpu_gmm.LAUNCHES = gpu_gmm.SERIAL_LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        dirs = synth.write_training_wavs(tmp, FS48)
        test_dir = os.path.join(tmp, "test")
        os.makedirs(test_dir)
        for i, (label, sig) in enumerate(zip(truth48, utts48)):
            wavfile.write(os.path.join(test_dir, f"{i:02d}_{label}.wav"),
                          FS48, sig)
        model = os.path.join(tmp, "enrolled48.out")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-t", "enroll", "-i", " ".join(dirs), "-m", model,
                      "--device", "cuda"])
        predict_out = io.StringIO()
        with contextlib.redirect_stdout(predict_out):
            cli.main(["-t", "predict", "-i", os.path.join(test_dir, "*.wav"),
                      "-m", model, "--device", "cuda"])
    labels48 = [ln.rpartition(" -> ")[2]
                for ln in predict_out.getvalue().strip().splitlines()]
    print(f"phase 12 cli enroll + predict @ 48 kHz: {labels48}", flush=True)
    if labels48 != truth48:
        raise AssertionError(f"48 kHz cli labels {labels48} != {truth48}")
    m48 = ModelInterface.load(synth.SESSION48, device=dev)
    scores48, valid48 = m48.scores_batch(FS48, utts48)
    want48 = np.asarray(exp48["scores"])
    rel48 = float(np.max(np.abs(scores48 - want48) / np.abs(want48)))
    same48 = m48.predict_batch(FS48, utts48) == truth48 and \
        bool((scores48.argmax(-1) == want48.argmax(-1)).all())
    print(f"phase 12 JAX-enrolled 48 kHz session: scores {scores48.shape} "
          f"vs JAX max rel {rel48:.3e} (tol {SLICE_RTOL}), labels identical "
          f"{same48}", flush=True)
    if not valid48.all() or rel48 > SLICE_RTOL or not same48:
        raise AssertionError("48 kHz session disagrees with the JAX package")
    open_set("phase 12 open set @ 48 kHz", FS48, PipelineConfig(), dev)
    # the 48 kHz frontend is the kernel from the signals (phase 22); the
    # frame-level K5 has no serving caller at a power-of-two fft_size
    launches3 = {"frontend": gpu_frontend.LAUNCHES,
                 "frames": gpu_frontend.FRAMES_LAUNCHES,
                 "full": gpu_frontend.FULL_LAUNCHES,
                 "full_signals": gpu_frontend.FULL_SIGNAL_LAUNCHES,
                 "full_dense": gpu_frontend.FULL_DENSE_LAUNCHES,
                 "gmm": gpu_gmm.LAUNCHES, "serial": gpu_gmm.SERIAL_LAUNCHES}
    print(f"phase 12 launches @ 48 kHz: {launches3}", flush=True)
    if (launches3["frontend"] != 0 or launches3["full_dense"] != 0
            or launches3["frames"] != 0 or launches3["full"] != 0
            or min(launches3["full_signals"], launches3["gmm"],
                   launches3["serial"]) < 1):
        raise AssertionError(f"slice 3 launches {launches3}")

    # fft_size 4096 at 48 kHz: the packed route, K1 on a 4096-point FFT;
    # the CLI's enroll task with that config, then `cli -t predict` on the
    # session it dumps
    gpu_frontend.LAUNCHES = gpu_frontend.FULL_LAUNCHES = 0
    gpu_gmm.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        dirs = synth.write_training_wavs(tmp, FS48)
        test_dir = os.path.join(tmp, "test")
        os.makedirs(test_dir)
        for i, (label, sig) in enumerate(zip(truth48, utts48)):
            wavfile.write(os.path.join(test_dir, f"{i:02d}_{label}.wav"),
                          FS48, sig)
        model = os.path.join(tmp, "enrolled48_fft4096.out")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.task_enroll(" ".join(dirs), model, dev.type,
                            PipelineConfig(features=FFT4096))
        predict_out = io.StringIO()
        with contextlib.redirect_stdout(predict_out):
            cli.main(["-t", "predict", "-i", os.path.join(test_dir, "*.wav"),
                      "-m", model, "--device", "cuda"])
        served = ModelInterface.load(model, device=dev).config.features
    labels4096 = [ln.rpartition(" -> ")[2]
                  for ln in predict_out.getvalue().strip().splitlines()]
    launches4096 = {"frontend": gpu_frontend.LAUNCHES,
                    "full": gpu_frontend.FULL_LAUNCHES,
                    "gmm": gpu_gmm.LAUNCHES}
    print(f"phase 12 cli enroll + predict @ 48 kHz, fft_size 4096: "
          f"{labels4096}; launches {launches4096}", flush=True)
    if (labels4096 != truth48 or served != FFT4096
            or launches4096["full"] != 0
            or min(launches4096["frontend"], launches4096["gmm"]) < 1):
        raise AssertionError(f"48 kHz fft_size 4096 cli labels {labels4096}, "
                             f"launches {launches4096}")

    # 96 kHz with fft_size 8192 (40 mel filters): K1 on an 8192-point FFT,
    # enroll then predict through the CLI, on the fixture's utterances at
    # 96 kHz
    utts96 = [synth.synth_utterance(u["label"], u["seconds"], u["seed"], FS96)
              for u in exp48["utterances"]]
    gpu_frontend.LAUNCHES = gpu_frontend.FULL_LAUNCHES = 0
    gpu_gmm.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        dirs = synth.write_training_wavs(tmp, FS96)
        test_dir = os.path.join(tmp, "test")
        os.makedirs(test_dir)
        for i, (label, sig) in enumerate(zip(truth48, utts96)):
            wavfile.write(os.path.join(test_dir, f"{i:02d}_{label}.wav"),
                          FS96, sig)
        model = os.path.join(tmp, "enrolled96_fft8192.out")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.task_enroll(" ".join(dirs), model, dev.type,
                            PipelineConfig(features=CLI96))
        predict_out = io.StringIO()
        with contextlib.redirect_stdout(predict_out):
            cli.main(["-t", "predict", "-i", os.path.join(test_dir, "*.wav"),
                      "-m", model, "--device", "cuda"])
        served96 = ModelInterface.load(model, device=dev).config.features
    labels96 = [ln.rpartition(" -> ")[2]
                for ln in predict_out.getvalue().strip().splitlines()]
    launches96 = {"frontend": gpu_frontend.LAUNCHES,
                  "full": gpu_frontend.FULL_LAUNCHES, "gmm": gpu_gmm.LAUNCHES}
    print(f"phase 12 cli enroll + predict @ 96 kHz, fft_size 8192, 40 mel "
          f"filters: "
          f"{labels96}; launches {launches96}", flush=True)
    if (labels96 != truth48 or served96 != CLI96
            or launches96["full"] != 0
            or min(launches96["frontend"], launches96["gmm"]) < 1):
        raise AssertionError(f"96 kHz fft_size 8192 cli labels {labels96}, "
                             f"launches {launches96}")

    # the LPC-cepstra slice at 8 kHz: enroll, train, predict, dump, the CLI
    # on the dumped session, and the open set, all on K1's LPC-cepstra
    # kernel (csrc/frontend_lpcc_signals.cu), never on K1's tile
    gpu_frontend.LAUNCHES = gpu_frontend.FRAMES_LAUNCHES = 0
    gpu_frontend.LPCC_SIGNAL_LAUNCHES = 0
    gpu_gmm.LAUNCHES = gpu_gmm.SERIAL_LAUNCHES = 0
    lpcc_pcfg = PipelineConfig(features=lpcc_cfg)
    lpcc_model = ModelInterface(lpcc_pcfg, device=dev)
    for label, sigs in train_sigs.items():
        for sig in sigs:
            lpcc_model.enroll(label, synth.FS, sig)
    lpcc_model.train()
    labels_lpcc = lpcc_model.predict_batch(synth.FS, utts)
    scores_lpcc, _ = lpcc_model.scores_batch(synth.FS, utts)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, sig) in enumerate(zip(truth, utts)):
            wavfile.write(os.path.join(tmp, f"{i:02d}_{label}.wav"),
                          synth.FS, sig)
        model = os.path.join(tmp, "lpcc.out")
        lpcc_model.dump(model)
        predict_out = io.StringIO()
        with contextlib.redirect_stdout(predict_out):
            cli.main(["-t", "predict", "-i", os.path.join(tmp, "*.wav"),
                      "-m", model, "--device", "cuda"])
        # the same session through the plain route, on the CPU
        plain_scores, _ = ModelInterface.load(
            model, device="cpu").scores_batch(synth.FS, utts)
    cli_lpcc = [ln.rpartition(" -> ")[2]
                for ln in predict_out.getvalue().strip().splitlines()]
    rel_lpcc = float(np.max(np.abs(scores_lpcc - plain_scores)
                            / np.abs(plain_scores)))
    print(f"phase 12 ModelInterface with LPC cepstra @ 8 kHz: {labels_lpcc}; "
          f"cli on the dumped session: {cli_lpcc}; scores vs the plain route "
          f"on the CPU max rel {rel_lpcc:.3e} (tol {SLICE_RTOL})", flush=True)
    if labels_lpcc != truth or cli_lpcc != truth or rel_lpcc > SLICE_RTOL:
        raise AssertionError(f"LPCC labels {labels_lpcc}, cli {cli_lpcc}")
    # 8 components: at 32 the 36 s of synthetic audio leave the UBM of
    # these features no margin between the genuine and the impostor
    open_set("phase 12 open set @ 8 kHz with LPC cepstra", synth.FS,
             lpcc_pcfg, dev, n_mixtures=8)
    launches5 = {"frontend": gpu_frontend.LPCC_SIGNAL_LAUNCHES,
                 "k1_tile": gpu_frontend.LAUNCHES,
                 "frames": gpu_frontend.FRAMES_LAUNCHES,
                 "gmm": gpu_gmm.LAUNCHES, "serial": gpu_gmm.SERIAL_LAUNCHES}
    print(f"phase 12 launches of the LPC-cepstra slice: {launches5}",
          flush=True)
    if launches5["frames"] != 0 or launches5["k1_tile"] != 0 or min(
            launches5["frontend"], launches5["gmm"],
            launches5["serial"]) < 1:
        raise AssertionError(f"LPC-cepstra slice launches {launches5}")

    # timing of slice 3's kernels and of predict at 48 kHz
    fe_args = frames_args(fe8c, bench_sig)[0]
    t["frames"] = time_ms(lambda: gpu_frontend.packed_from_frames(
        *fe_args, fft=fe8c.fft))
    t["frames_plain"] = time_ms(
        lambda: gpu_frontend.packed_from_frames_reference(*fe_args))
    t["frames_plain_fft"] = time_ms(
        lambda: gpu_frontend.packed_from_frames_fft_reference(
            fe_args[0], fe8c.fft, fe8c.dct, fe8c.floor))
    del fe_args
    # K1's raw-autocorrelation mode beside its plain version, and LPCC
    # predict (K1's LPC-cepstra mode) beside the route before the raw mode
    # (a copied frame matrix, K4, CMVN, Levinson and the LPCC recursion in
    # torch; the same scoring kernel after it), taking turns
    raw_args = frontend_args(fe8c, bench_sig, bench_len)
    lpcc_bank = random_bank(rng, 4, 32, lpcc_cfg.dim, dev,
                            uniform_weights=True)

    def lpcc_predict_k4():
        fa, B, T = frames_args(fe8c, bench_sig)
        ceps, r = gpu_frontend.packed_from_frames(*fa, fft=fe8c.fft)
        f, m = fe8c.finish(ceps.view(B, T, -1), r.view(B, T, -1),
                           framing.frame_validity_mask(
                               bench_len, T, fe8c.frame_len,
                               fe8c.frame_shift))
        return gpu_gmm.batch_bank_avg_loglik(lpcc_bank, f, m)

    t.update(time_interleaved({
        "frontend_raw": lambda: gpu_frontend.packed_from_signals(
            *raw_args, fft=fe8c.fft, fuse_lpc=False),
        "frontend_raw_plain": lambda:
            gpu_frontend.packed_from_signals_reference(*raw_args,
                                                       fuse_lpc=False),
        "lpcc_predict": lambda: fastpath.predict_scores(
            bench_sig, bench_len, lpcc_bank, BENCH_FS, lpcc_cfg),
        "lpcc_predict_k4": lpcc_predict_k4}))
    # the torch steps after the kernel: Levinson, the LPCC recursion, mask
    raw_c, raw_r = gpu_frontend.packed_from_signals(*raw_args, fft=fe8c.fft,
                                                    fuse_lpc=False)
    raw_mask = framing.frame_validity_mask(bench_len, raw_c.shape[1],
                                           fe8c.frame_len, fe8c.frame_shift)
    print(f"phase 12 [{card}] Levinson + LPCC recursion in torch after the "
          "kernel, 512 x 5 s @ 8 kHz: " + device_times(
              lambda: fe8c.finish(raw_c, raw_r, raw_mask, cmvn_done=True)),
          flush=True)
    del raw_c, raw_r, raw_mask
    sig48, len48 = signals_batch(rng, [L48] * BENCH_B, padded(L48), dev)
    fe_args = frames_args(fe48, sig48)[0]
    # K5 beside the dense kernel on the same frames, and cuFFT's spectrum
    # alone as a yardstick for the FFT stage (not the whole function)
    t.update(time_interleaved({
        "full": lambda: gpu_frontend.mfcc_from_frames(*fe_args, fe48.n_fft),
        "full_dense": lambda: gpu_frontend.mfcc_from_frames_dense(*fe_args),
        "rfft": lambda: torch.fft.rfft(fe_args[0], n=fe48.n_fft)}))
    t["full_plain"] = time_ms(
        lambda: gpu_frontend.mfcc_from_frames_reference(*fe_args))
    t["full_plain_fft"] = time_ms(
        lambda: gpu_frontend.mfcc_from_frames_fft_reference(
            fe_args[0], fe48.mel, fe48.dct, fe48.floor, fe48.acorr,
            fe48.n_fft))
    del fe_args
    torch.cuda.empty_cache()
    t["predict48"] = time_ms(lambda: fastpath.predict_scores(
        sig48, len48, bench_bank, FS48, fcfg))
    rate48 = BENCH_B * BENCH_SEC / (t["predict48"] / 1e3)
    print(f"phase 12 [{card}] frame-level packed kernel, 512 x 5 s @ 8 kHz, "
          f"n_lpcc 16: {t['frames']:.3f} ms, plain {t['frames_plain']:.3f} ms, "
          f"plain FFT {t['frames_plain_fft']:.3f} ms")
    print(f"phase 12 [{card}] signal frontend kernel, raw-autocorrelation "
          f"mode, 512 x 5 s @ 8 kHz: {t['frontend_raw']:.3f} ms, plain "
          f"{t['frontend_raw_plain']:.3f} ms; predict_scores with n_lpcc 16 "
          f"(K1's LPC-cepstra mode) {t['lpcc_predict']:.3f} ms, through the "
          f"frame-level kernel in the same trials {t['lpcc_predict_k4']:.3f} "
          "ms")
    print(f"phase 12 [{card}] full-spectrum kernel (FFT), 512 x 5 s @ "
          f"48 kHz: {t['full']:.3f} ms; in the same interleaved trials the "
          f"dense kernel {t['full_dense']:.3f} ms and torch.fft.rfft alone "
          f"{t['rfft']:.3f} ms; plain dense {t['full_plain']:.3f} ms, plain "
          f"FFT {t['full_plain_fft']:.3f} ms")
    print(f"phase 12 [{card}] predict_scores 512 x 5 s @ 48 kHz, 4 x 32 "
          f"bank: {t['predict48']:.3f} ms = {rate48:.0f} audio-s/s",
          flush=True)

    del sig48, len48
    torch.cuda.empty_cache()
    # K1, K4 and K5 at 96 kHz on 8192-point FFTs, beside their plain
    # versions: the packed route of fft_size 8192 (K1; K4 on its frames
    # with LPC cepstra) and the full route at fft_size 8192
    a96 = frontend_args(fe96, s96, l96)
    fa96 = frames_args(fe96c, s96)[0]
    fe96f = FullFrontend(FS96, FFT8192, dev)
    ff96 = frames_args(fe96f, s96)[0]
    t.update({f"{k}96": v for k, v in time_interleaved({
        "frontend": lambda: gpu_frontend.packed_from_signals(*a96,
                                                             fft=fe96.fft),
        "frontend_plain": lambda: gpu_frontend.packed_from_signals_reference(
            *a96),
        "frames": lambda: gpu_frontend.packed_from_frames(*fa96,
                                                          fft=fe96c.fft),
        "frames_plain": lambda: gpu_frontend.packed_from_frames_reference(
            *fa96),
        "full": lambda: gpu_frontend.mfcc_from_frames(*ff96, fe96f.n_fft),
        "full_plain": lambda: gpu_frontend.mfcc_from_frames_reference(*ff96),
    }).items()})
    B96, Lp96 = s96.shape
    T96 = n_frames(Lp96, fe96.frame_len, fe96.frame_shift)
    v96 = int(a96[1].sum())
    bounds96 = {
        "frontend": bound(
            frontend_flops(v96, fe96.n_fft, (fe96.fft_mel, fe96.fft_acorr),
                           fe96.dct.shape[1], order=fe96.A.shape[1] - 1,
                           window=3 * fe96.frame_len),
            4 * B96 * Lp96 + 4 * B96 * T96 * fcfg.dim),
        "frames": bound(
            frontend_flops(B96 * T96, fe96c.n_fft,
                           (fe96c.fft_mel, fe96c.fft_acorr),
                           fe96c.dct.shape[1], window=3 * fe96c.frame_len),
            4 * B96 * T96 * (fe96c.frame_len + fe96c.dct.shape[1]
                             + fe96c.A.shape[1])),
        "full": bound(
            frontend_flops(B96 * T96, fe96f.n_fft, (fe96f.mel, fe96f.acorr),
                           fe96f.dct.shape[1]),
            4 * B96 * T96 * (fe96f.frame_len + fe96f.dct.shape[1]
                             + fe96f.acorr.shape[1])),
    }
    for k, name in (("frontend", "signal frontend kernel (K1)"),
                    ("frames", "frame-level packed kernel (K4), n_lpcc 16"),
                    ("full", "full-spectrum kernel (K5)")):
        print(f"phase 12 [{card}] {name} @ 96 kHz, fft_size 8192, {B96} x "
              f"{HIGH_SEC:g} s: {t[k + '96']:.3f} ms, plain "
              f"{t[k + '_plain96']:.3f} ms, bound "
              f"{bounds96[k]['bound_ms']:.4f} ms ({bounds96[k]['bound_by']})",
              flush=True)
    del a96, fa96, ff96
    torch.cuda.empty_cache()

    # 13. the fused predict monolith (K6 and K7) on the card: f32 on the
    # FFT tile (fft=), bf16 on the dense tile
    args13 = fused_args(fe8, bench_sig, bench_len, bench_bank)
    gpu_predict.LAUNCHES = gpu_predict.WIDE_LAUNCHES = 0
    gpu_predict.BF16_LAUNCHES = 0
    k6 = gpu_predict.fused_bank_predict(*args13, fft=fe8.fft)
    k6_bf16 = gpu_predict.fused_bank_predict(*args13, mm_bf16=True)
    k7 = gpu_predict.fused_bank_predict_wide(*args13, fft=fe8.fft)
    torch.cuda.synchronize()
    launches4 = {"fused": gpu_predict.LAUNCHES,
                 "wide": gpu_predict.WIDE_LAUNCHES,
                 "bf16": gpu_predict.BF16_LAUNCHES}
    print(f"phase 13 launches: {launches4}", flush=True)
    if min(launches4.values()) < 1:
        raise AssertionError(f"the monolith was not launched: {launches4}")
    plain13 = fused_plain(fe8, args13)
    err_k6 = check_fused("K6 bench 512 x 5 s @ 8 kHz (FFT tile)", k6, plain13)
    err_k6 = max(err_k6, check_fused(
        "K6 bench vs the dense plain version", k6,
        gpu_predict.fused_bank_predict_reference(*args13)))
    err_bf16 = check_fused(
        "K6 bf16 DFT operands (dense tile)", k6_bf16,
        gpu_predict.fused_bank_predict_reference(*args13, mm_bf16=True))
    tile13 = gpu_predict.bf16_tile(fe8.frame_len, fe8.frame_shift,
                                   fe8.W.shape[1] + fe8.A.shape[1], d)
    print(f"phase 13 K6 bf16 tile at the bench shape: {tile13}", flush=True)
    err_k7 = check_fused("K7 bench 512 x 5 s @ 8 kHz (FFT tile)", k7, plain13)
    two = fastpath.predict_scores(bench_sig, bench_len, bench_bank, BENCH_FS,
                                  fcfg)
    err_k6 = max(err_k6, check_fused("K6 vs predict_scores (K1 + K2)", k6,
                                     two))
    again = gpu_predict.fused_bank_predict(*args13, fft=fe8.fft)
    torch.cuda.synchronize()
    bitwise = (torch.equal(k6, again)
               and torch.equal(k7, gpu_predict.fused_bank_predict_wide(
                   *args13, fft=fe8.fft))
               and torch.equal(k6_bf16, gpu_predict.fused_bank_predict(
                   *args13, mm_bf16=True)))
    print(f"phase 13 two calls bitwise equal: {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError("the monolith is not deterministic")
    del plain13, two, again
    clip_sig, clip_len = signals_batch(rng, [150 * BENCH_FS, BENCH_FS],
                                       padded(150 * BENCH_FS), dev)
    fe8m = PackedFrontend(BENCH_FS, FeatureConfig(use_lpc=False), dev)
    fe48p = PackedFrontend(FS48, FFT4096, dev)
    fe102 = PackedFrontend(BENCH_FS, D102, dev)
    f64_sig = bench_sig[:64].contiguous()
    args0 = fused_args(fe8, bench_sig[:4], bench_len[:4], bench_bank)
    args0 = (args0[0], args0[1] * torch.tensor([0, 1, 1, 1], device=dev,
                                               dtype=torch.int32)) + args0[2:]
    for name, fe, args in (
            (f"48 kHz, fft_size 4096 (flen {fe48p.frame_len})", fe48p,
             fused_args(fe48p, s48p, l48p, bench_bank)),
            (f"96 kHz, fft_size 8192 (flen {fe96.frame_len})", fe96,
             fused_args(fe96, s96[:8].contiguous(), l96[:8], bench_bank)),
            ("bank 4 x 1024, 64 utterances", fe8,
             fused_args(fe8, f64_sig, bench_len[:64], k1024_bank)),
            (f"d = {D102.dim}", fe102,
             fused_args(fe102, bench_sig[:32].contiguous(), bench_len[:32],
                        random_bank(rng, 4, 32, D102.dim, dev))),
            ("80 x 256 bank, 8 utterances", fe8,
             fused_args(fe8, bench_sig[:8].contiguous(), bench_len[:8],
                        ubm_bank)),
            ("150 s clip + 1 s clip", fe8,
             fused_args(fe8, clip_sig, clip_len, bench_bank)),
            ("MFCC only", fe8m,
             fused_args(fe8m, f64_sig, bench_len[:64],
                        random_bank(rng, 4, 32, fe8m.dct.shape[1], dev))),
            (f"16 kHz (flen {fe16.frame_len}; a 0.01 s utterance)", fe16,
             fused_args(fe16, s16, l16, bench_bank)),
            ("LPC order 40, 40 cepstra", fe40,
             fused_args(fe40, bench_sig[:16].contiguous(), bench_len[:16],
                        random_bank(rng, 4, 32, ORDER40.dim, dev))),
            ("n_valid = 0", fe8, args0)):
        e6, e7 = check_fused_case(name, fe, args)
        err_k6, err_k7 = max(err_k6, e6), max(err_k7, e7)
    del clip_sig, clip_len, f64_sig
    if (gpu_predict.fused_bank_predict(*args0, fft=fe8.fft)[0] != 0).any():
        raise AssertionError("an utterance with no valid frame must score 0")

    t13 = time_interleaved({
        "fused": lambda: gpu_predict.fused_bank_predict(*args13, fft=fe8.fft),
        "fused_bf16": lambda: gpu_predict.fused_bank_predict(*args13,
                                                             mm_bf16=True),
        "wide": lambda: gpu_predict.fused_bank_predict_wide(*args13,
                                                            fft=fe8.fft),
        "fused_plain": lambda: fused_plain(fe8, args13),
        "fused_plain_dense": lambda: gpu_predict.fused_bank_predict_reference(
            *args13),
        "fused_plain_bf16": lambda: gpu_predict.fused_bank_predict_reference(
            *args13, mm_bf16=True),
        "predict": lambda: fastpath.predict_scores(
            bench_sig, bench_len, bench_bank, BENCH_FS, fcfg)})
    t.update(t13)
    # where the monolith's time goes, from what the API can switch off:
    # without CMVN (phase 2), then also with a one-component bank (phase
    # 3's work ~0), beside the frontend kernel alone (phase 1's code) and
    # the bank-scoring kernel on the same features
    no_cmvn = args13[:9] + (False,)
    tiny = random_bank(rng, 1, 1, d, dev)
    fe_args8 = frontend_args(fe8, bench_sig, bench_len)
    fe_nocmvn = fe_args8[:-1] + (False,)
    t_parts = time_interleaved({
        "fused": lambda: gpu_predict.fused_bank_predict(*args13, fft=fe8.fft),
        "fused, no CMVN": lambda: gpu_predict.fused_bank_predict(
            *no_cmvn, fft=fe8.fft),
        "fused, no CMVN, 1 x 1 bank": lambda: gpu_predict.fused_bank_predict(
            *no_cmvn[:2], tiny, *no_cmvn[3:], fft=fe8.fft),
        "frontend kernel, no CMVN": lambda: gpu_frontend.packed_from_signals(
            *fe_nocmvn, fft=fe8.fft),
        "frontend kernel + CMVN kernel": lambda:
            gpu_frontend.packed_from_signals(*fe_args8, fft=fe8.fft),
        "bank-scoring kernel": lambda: gpu_gmm.batch_bank_avg_loglik(
            bench_bank, feats, mask)})
    print(f"phase 13 [{card}] breakdown, 512 x 5 s @ 8 kHz: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in t_parts.items()), flush=True)
    print(f"phase 13 [{card}] K6 on the FFT tile " + device_times(
        lambda: gpu_predict.fused_bank_predict(*args13, fft=fe8.fft)),
        flush=True)
    entries13 = phase13_lifted(rng, dev, card, bench_bank)

    # 14. the grid: more utterances, and speakers, than a launch takes
    gsig, glen = signals_batch(rng, [int(0.1 * BENCH_FS)] * GRID_B,
                               LENGTH_BUCKET, dev)
    gpu_frontend.LAUNCHES = gpu_gmm.LAUNCHES = gpu_gmm.SERIAL_LAUNCHES = 0
    err_fe = max(err_fe, check_frontend(
        f"{GRID_B} utterances x 0.1 s @ 8 kHz", fe8, gsig, glen, phase=14))
    gfeats, gmask = fe8(gsig, glen)
    del gsig, glen
    err_gmm = max(err_gmm, check_scoring(
        f"bench bank 4 x 32, B={GRID_B}", bench_bank, gfeats, gmask,
        phase=14))
    del gfeats, gmask
    torch.cuda.empty_cache()
    err_serial = max(err_serial, check_serial(
        f"{GRID_B} speakers x 4 components, 5 s",
        random_bank(rng, GRID_B, 4, d, dev), x5, m5, phase=14,
        per_call=-(-GRID_B // 65535)))
    launches14 = {"frontend": gpu_frontend.LAUNCHES, "gmm": gpu_gmm.LAUNCHES,
                  "serial": gpu_gmm.SERIAL_LAUNCHES}
    print(f"phase 14 launches: {launches14}", flush=True)
    if min(launches14.values()) < 1:
        raise AssertionError(f"the grid phase missed a kernel: {launches14}")

    # 15. the live path: K5 at fft_size 1500 past 192 outputs (the chirp-z
    # kernel, and the dense template it replaced there), the VAD and
    # k-means on the card, then noise -> filtered enrollment ->
    # k-means-seeded training -> streaming decisions through the GUI
    fe216 = FullFrontend(BENCH_FS, DENSE216, dev)
    if gpu_frontend.chirp_size(fe216.n_fft, fe216.frame_len) != 1024:
        raise AssertionError("fft_size 1500 did not take a 1024-point chirp")
    err_chirp = max(err_chirp, check_frames(
        15, "8 kHz, fft_size 1500, 200 mel filters + LPC (216 outputs, "
        f"chirp-z kernel), {BENCH_B} x {BENCH_SEC:g} s", fe216, bench_sig,
        bench_len))
    args216, B216, T216 = frames_args(fe216, bench_sig)
    # the dense template on the same frames, launched directly: it now
    # serves only past the chirp-z route's reach (M > 2^23)
    err_dense = check_dense(15, "216 outputs", fe216, bench_sig, bench_len)
    # an output's arithmetic does not depend on how many there are: 144
    # outputs equal their copies among 216 bitwise, on both kernels
    fe144 = FullFrontend(BENCH_FS, FeatureConfig(mfcc=MfccConfig(
        fft_size=1500, n_filters=128)), dev)
    args144, _, _ = frames_args(fe144, bench_sig)
    ac = args144[-1]
    wide = torch.cat([ac, torch.from_numpy(rng.rand(ac.shape[0], 72).astype(
        np.float32)).to(dev)], dim=1).contiguous()
    for which, fn in (("chirp-z", lambda *a: gpu_frontend.mfcc_from_frames(
                           *a, fe144.n_fft)),
                      ("dense", gpu_frontend.mfcc_from_frames_dense)):
        a144 = args144 if which == "chirp-z" else (
            args144[0][:8 * T216].contiguous(), *args144[1:])
        c144, r144 = fn(*a144)
        c216, r216 = fn(*a144[:-1], wide)
        torch.cuda.synchronize()
        inside = (torch.equal(c144, c216)
                  and torch.equal(r144, r216[:, :ac.shape[1]]))
        print(f"phase 15 {which} kernel: 144 outputs bitwise equal inside "
              f"216: {inside}", flush=True)
        if not inside:
            raise AssertionError(f"the {which} kernel's outputs depend on "
                                 "the output count")
    del args144, wide, c144, r144, c216, r216
    # extract_batch at 216 outputs takes the chirp-z kernel once and the
    # dense template never, and its features match the dense plain
    # version's
    launches_chirp, err216 = extract_vs_dense(
        15, f"8 kHz, fft_size 1500, 216 outputs (SRTPU_FRONTEND=full), "
        f"{BENCH_B} x {BENCH_SEC:g} s", fe216, DENSE216, bench_sig, bench_len,
        "FULL_CHIRP_LAUNCHES")
    err_chirp = max(err_chirp, err216)
    # the chirp-z route on the cluster: fft_size 16000 (M = 16384, one
    # block) on 64 bench utterances (its M-point plain version takes 2.7 GB
    # a tensor there) and 33000 (M = 32768, two blocks) on 8 utterances, each against the three plain versions, two calls
    # bitwise, through extract_batch (the chirp counter once, the dense
    # template never), timed beside the dense template on the same frames,
    # the plain versions and cuFFT's rfft (the spectral stage's yardstick)
    chirp_routes = []
    for n in CHIRP_CLUSTER_FFTS:
        cfg = FeatureConfig(mfcc=MfccConfig(fft_size=n))
        fe = FullFrontend(BENCH_FS, cfg, dev)
        M = gpu_frontend.chirp_size(n, fe.frame_len)
        if M != {16000: 16384, 33000: 32768}[n] or fe.C is not None and \
                dev.type == "cuda":
            raise AssertionError(f"fft_size {n}: M {M}, not the cluster's")
        Bc = BIG_B if n == 16000 else 8
        sc, lc = bench_sig[:Bc].contiguous(), bench_len[:Bc].contiguous()
        nm = (f"8 kHz, fft_size {n} (chirp-z on the cluster, M {M}), {Bc} x "
              f"{BENCH_SEC:g} s")
        err_c = check_frames(15, nm, fe, sc, lc)
        launched_c = drive_extract(
            nm, BENCH_FS, cfg, sc, lc, {"FULL_CHIRP_LAUNCHES": 1}, full=True,
            phase=15)["FULL_CHIRP_LAUNCHES"]
        fargs, Bn, Tn = frames_args(fe, sc)
        kern, plains, _ = frames_kernel(fe)
        tc = time_interleaved({
            "kernel": lambda: kern(*fargs),
            "dense": lambda: gpu_frontend.mfcc_from_frames_dense(*fargs),
            "plain": lambda: plains["fft"](*fargs),
            "plain_chirp": lambda: plains["chirp"](*fargs),
            "plain_dense": lambda: plains["dense"](*fargs),
            "rfft": lambda: torch.fft.rfft(fargs[0], n=n)}, *ROUTE_TRIALS)
        bc = frames_work(fe, Bn * Tn, 4 * fargs[0].numel())
        print(f"phase 15 [{card}] {nm} ({tuple(fargs[0].shape)} frames): "
              f"chirp-z kernel {tc['kernel']:.3f} ms, dense template "
              f"{tc['dense']:.3f} ms; plain: FFT route {tc['plain']:.3f} ms, "
              f"chirp-z {tc['plain_chirp']:.3f} ms, dense "
              f"{tc['plain_dense']:.3f} ms; cuFFT's torch.fft.rfft(frames, "
              f"n={n}) alone {tc['rfft']:.3f} ms; bound {bc['bound_ms']:.4f} "
              f"ms ({bc['bound_by']}); device ms a call by kernel "
              f"{kernel_times(lambda: kern(*fargs))}", flush=True)
        chirp_routes.append((f"mfcc_from_frames_chirp_m{M}",
                             "frontend_chirp_cluster.cu",
                             "pallas_frontend.py:50", launched_c, err_c,
                             tc["kernel"], tc["plain"], bc))
        if n == 16000:  # the dense template directly, as at 216 outputs
            err_dense = max(err_dense, check_dense(
                15, f"8 kHz, fft_size {n}, {Bc} x {BENCH_SEC:g} s", fe, sc,
                lc))
        del fargs, fe
        torch.cuda.empty_cache()
    # past the cluster's reach (fft_size 261634: M = 262144) the chirp-z
    # route on the device-memory passes, through extract_batch (the chirp
    # and passes counters once, the dense template never) and directly, on
    # 2 utterances, held to the chirp-z, dense and FFT plain versions;
    # timed beside the dense template called directly on the same frames
    # (what served this shape before), the plain versions and cuFFT's rfft
    past = FeatureConfig(mfcc=MfccConfig(fft_size=PAST_CLUSTER_FFT))
    fe_past = FullFrontend(BENCH_FS, past, dev)
    M = gpu_frontend.chirp_size(PAST_CLUSTER_FFT, fe_past.frame_len)
    if M != 262144 or fe_past.C is not None and dev.type == "cuda":
        raise AssertionError(f"fft_size {PAST_CLUSTER_FFT}: M {M}, not the "
                             "passes'")
    sp, lp = bench_sig[:2].contiguous(), bench_len[:2].contiguous()
    nm = (f"8 kHz, fft_size {PAST_CLUSTER_FFT} (chirp-z on the passes, M "
          f"{M}), 2 x {BENCH_SEC:g} s")
    launches_past = drive_extract(
        nm, BENCH_FS, past, sp, lp,
        {"FULL_CHIRP_LAUNCHES": 1, "BIG_PASSES_LAUNCHES": 1}, full=True,
        phase=15)["FULL_CHIRP_LAUNCHES"]
    extract._frontend.cache_clear()
    err_past = check_frames(15, nm, fe_past, sp, lp)
    fargs, Bp, Tp = frames_args(fe_past, sp)
    kern, plains, _ = frames_kernel(fe_past)
    nb_past = PAST_CLUSTER_FFT // 2 + 1
    S_past = fused_split(Bp * Tp, nb_past, dev)
    tp = time_interleaved({
        "kernel": lambda: kern(*fargs),
        "dense": lambda: gpu_frontend.mfcc_from_frames_dense(*fargs),
        "plain": lambda: plains["fft"](*fargs),
        "plain_chirp": lambda: plains["chirp"](*fargs),
        "plain_dense": lambda: plains["dense"](*fargs),
        "rfft": lambda: torch.fft.rfft(fargs[0], n=PAST_CLUSTER_FFT)},
        *SMALL_TRIALS)
    bp = frames_work(fe_past, Bp * Tp, 4 * fargs[0].numel())
    print(f"phase 15 [{card}] {nm} ({tuple(fargs[0].shape)} frames, the "
          f"fused pass split in S {S_past}): chirp-z kernel "
          f"{tp['kernel']:.3f} ms, dense template {tp['dense']:.3f} ms; "
          f"plain: FFT route {tp['plain']:.3f} ms, chirp-z "
          f"{tp['plain_chirp']:.3f} ms, dense {tp['plain_dense']:.3f} ms; "
          f"cuFFT's torch.fft.rfft(frames, n={PAST_CLUSTER_FFT}) alone "
          f"{tp['rfft']:.3f} ms; bound {bp['bound_ms']:.4f} ms "
          f"({bp['bound_by']}); device ms a call by kernel "
          f"{kernel_times(lambda: kern(*fargs))}", flush=True)
    chirp_routes.append((f"mfcc_from_frames_chirp_m{M}",
                         "frontend_chirp_cluster.cu", "pallas_frontend.py:50",
                         launches_past, err_past, tp["kernel"], tp["plain"],
                         bp))
    del fargs, fe_past
    torch.cuda.empty_cache()
    # past the chirp-z route's reach the dense template, through
    # extract_batch (its launches on the main path) and directly
    Lr = PAST_REACH_LENGTHS
    sr, lr = signals_batch(rng, list(Lr), Lr[0], dev)
    fe_reach = FullFrontend(BENCH_FS, PAST_REACH, dev)
    if gpu_frontend.chirp_size(PAST_REACH_FFT, fe_reach.frame_len):
        raise AssertionError(f"fft_size {PAST_REACH_FFT}: on the chirp-z "
                             "route")
    nm = (f"8 kHz, fft_size {PAST_REACH_FFT} (the dense template past the "
          f"chirp-z reach), frames of two samples, 2 filters, no LPC, 2 x "
          f"{Lr[0]} samples")
    launches_dense, err_reach = extract_vs_dense(
        15, nm, fe_reach, PAST_REACH, sr, lr, "FULL_DENSE_LAUNCHES")
    extract._frontend.cache_clear()
    err_dense = max(err_dense, err_reach,
                    check_dense(15, nm, fe_reach, sr, lr))
    rargs, _, _ = frames_args(fe_reach, sr)
    tr = time_interleaved({
        "kernel": lambda: gpu_frontend.mfcc_from_frames_dense(*rargs),
        "plain": lambda: gpu_frontend.mfcc_from_frames_reference(*rargs)},
        *SMALL_TRIALS)
    br = frames_work(fe_reach, rargs[0].shape[0], 4 * rargs[0].numel())
    print(f"phase 15 [{card}] {nm} ({tuple(rargs[0].shape)} frames): dense "
          f"template {tr['kernel']:.3f} ms, its plain version "
          f"{tr['plain']:.3f} ms, bound {br['bound_ms']:.4f} ms "
          f"({br['bound_by']})", flush=True)
    del sr, lr, rargs, fe_reach
    torch.cuda.empty_cache()
    # the chirp-z kernel beside the dense template, the FFT route's plain
    # version (the chirp kernel's plain version: torch.fft.rfft at 1500
    # points), the chirp's own plain version (torch.fft.fft at M), the
    # dense plain version, and cuFFT's spectrum alone (the spectral stage's
    # yardstick, not the whole function), interleaved
    wp216, mel216, dct216, ac216 = (args216[0], args216[3], args216[4],
                                    args216[6])
    t.update(time_interleaved({
        "chirp216": lambda: gpu_frontend.mfcc_from_frames(*args216, 1500),
        "dense216": lambda: gpu_frontend.mfcc_from_frames_dense(*args216),
        "chirp216_plain": lambda: gpu_frontend.mfcc_from_frames_fft_reference(
            wp216, mel216, dct216, fe216.floor, ac216, 1500),
        "chirp216_plain_chirp": lambda:
            gpu_frontend.mfcc_from_frames_chirp_reference(
                wp216, mel216, dct216, fe216.floor, ac216, 1500),
        "dense216_plain": lambda: gpu_frontend.mfcc_from_frames_reference(
            *args216),
        "rfft1500": lambda: torch.fft.rfft(wp216, n=1500)}))
    print(f"phase 15 [{card}] {BENCH_B} x {BENCH_SEC:g} s @ 8 kHz, fft_size "
          f"1500, 216 outputs ({tuple(wp216.shape)} frames): chirp-z kernel "
          f"{t['chirp216']:.3f} ms, dense template {t['dense216']:.3f} ms; "
          f"plain: FFT route {t['chirp216_plain']:.3f} ms, chirp-z "
          f"{t['chirp216_plain_chirp']:.3f} ms, dense "
          f"{t['dense216_plain']:.3f} ms; cuFFT's torch.fft.rfft(frames, "
          f"n=1500) alone {t['rfft1500']:.3f} ms", flush=True)
    print(f"phase 15 [{card}] chirp-z kernel " + device_times(
        lambda: gpu_frontend.mfcc_from_frames(*args216, 1500)), flush=True)
    n_frames216 = wp216.shape[0]
    del args216, wp216

    # the VAD on the card at f32 against the CPU's plain torch at f64
    fs = synth.FS
    noise = synth.noise_clip()
    sig5 = synth.conversation_stream()[:5 * fs]
    vads = {}
    for where, d_, dt_ in (("card", dev, torch.float32),
                           ("cpu", "cpu", torch.float64)):
        v = ltsd.LtsdVad(device=d_, dtype=dt_)
        v.init_params_by_noise(fs, noise)
        vads[where] = (v, v.scores(sig5), v.filter(sig5)[1])
    (vg, sg, ig), (vc, sc, ic) = vads["card"], vads["cpu"]
    d_ltsd = float(np.abs(sg - sc).max())
    margin = float(min(np.abs(sc - vc.lambda0).min(),
                       np.abs(sc - vc.lambda1).min()))
    print(f"phase 15 LTSD, 5 s @ 8 kHz: scores {sg.shape} max|d| "
          f"{d_ltsd:.3e} dB (tol {LTSD_ATOL}), lambda0 {vg.lambda0:.6f} / "
          f"{vc.lambda0:.6f}, least margin to a threshold {margin:.3f} dB, "
          f"intervals {ig} identical {ig == ic}", flush=True)
    if d_ltsd > LTSD_ATOL or ig != ic or not ig or margin <= LTSD_ATOL:
        raise AssertionError("the LTSD VAD on the card disagrees with the "
                             "CPU's")
    nr = noisered.NoiseReduction(device=dev)
    nr.init_noise(fs, noise)
    ws = nr.window_size
    gates = [noisered.spectral_gate(sig5, nr.profile, ws, nr.amount, dev)
             for _ in range(2)]
    want = noisered.spectral_gate(sig5, nr.profile, ws, nr.amount, "cpu",
                                  torch.float64)
    d_gate = float(np.abs(gates[0] - want).max() / np.abs(want).max())
    gate_bits = np.array_equal(gates[0], gates[1])
    print(f"phase 15 spectral gate, 5 s @ 8 kHz: max|d| / peak "
          f"{d_gate:.3e} (tol {GATE_RTOL}), two calls bitwise equal "
          f"{gate_bits}", flush=True)
    if d_gate > GATE_RTOL or not gate_bits:
        raise AssertionError("the spectral gate on the card disagrees")

    # k-means on the card: Lloyd's from one init against the CPU at f64
    Xb = blobs(rng, 16, 100, 28)
    C0 = Xb[np.arange(16) * 100 + rng.randint(100, size=16)]  # one a blob
    mb = np.ones(len(Xb), bool)
    got, _ = kmeans.lloyd(torch.tensor(Xb, dtype=torch.float32, device=dev),
                          torch.from_numpy(mb).to(dev), C0)
    want, _ = kmeans.lloyd(torch.from_numpy(Xb), torch.from_numpy(mb), C0)
    d_lloyd = float((got.double().cpu() - want).abs().max())
    print(f"phase 15 lloyd, 1600 x 28, K 16, f32 card vs f64 CPU: "
          f"centroids max|d| {d_lloyd:.3e} (tol {LLOYD_ATOL})", flush=True)
    if d_lloyd > LLOYD_ATOL:
        raise AssertionError("lloyd on the card disagrees with the CPU")
    # k-means|| over 8 seeds: one call, 8 speakers of the same features
    # (24 s of a noisy speaker)
    feats = np.concatenate([extract.mix_feature(
        fs, synth.noisy_utterance("alice", 8.0, 70 + j), device=dev)
        for j in range(3)])
    Xs = np.repeat(feats[None], 8, axis=0)
    ms = np.ones(Xs.shape[:2], bool)
    _, in_card = kmeans.kmeansii_device(
        torch.tensor(Xs, dtype=torch.float32, device=dev),
        torch.from_numpy(ms).to(dev), 32)
    _, in_cpu = kmeans.kmeansii_device(torch.tensor(Xs), torch.from_numpy(ms),
                                       32)
    ratio = in_card.double().cpu() / in_cpu.median()
    print(f"phase 15 kmeansii_device, 8 seeds, {Xs.shape[1]} x {d} "
          f"features, K 32: inertia / "
          f"CPU median {[round(float(x), 4) for x in ratio]} (tol "
          f"{KMEANS_FACTOR})", flush=True)
    if not bool((ratio <= KMEANS_FACTOR).all()):
        raise AssertionError("k-means|| seeding collapsed on the card")
    # seeding + EM at the UBM-scale bank: KM_SPEAKERS x KM_SECONDS, GMM-256
    n_km = n_frames(int(KM_SECONDS * fs), fe8.frame_len, fe8.frame_shift)
    Xu = torch.tensor(np.stack([blobs(rng, 64, -(-n_km // 64), d, 1.0, 2.0)
                                [:n_km] for _ in range(KM_SPEAKERS)]),
                      dtype=torch.float32, device=dev)
    mu_ = torch.ones(Xu.shape[:2], dtype=torch.bool, device=dev)
    ubm_set = GMMSet(gmm_order=KM_K, config=GmmConfig(
        n_mixtures=KM_K, init_with_kmeans=True), device=dev)
    for s_ in range(KM_SPEAKERS):
        ubm_set.fit_new(Xu[s_].cpu().numpy(), f"s{s_}")
    ubm_set.train()  # through the entry point, once
    tl = ubm_set.train_log
    if not np.isfinite(ubm_set.params.means).all():
        raise AssertionError("the UBM-scale k-means-seeded bank is not "
                             "finite")
    klog = {}
    kmeans.kmeansii_device(Xu, mu_, KM_K, log=klog)
    # warm, median of 7: the seeding alone, by stage, and with EM as
    # GMMSet.train runs it on the uploaded bank
    t["seed_ubm"] = time_ms(lambda: kmeans.kmeansii_device(Xu, mu_, KM_K),
                            reps=1)
    stages = seeding_stages(lambda: kmeans.kmeansii_device(Xu, mu_, KM_K))
    t["train_ubm"] = time_ms(lambda: gmm.fit_with_init(
        Xu, mu_, ubm_set.config), reps=1)
    print(f"phase 15 [{card}] k-means|| seeding, {KM_SPEAKERS} speakers x "
          f"{KM_SECONDS:g} s ({n_km} frames, d {d}), K {KM_K}: "
          f"{t['seed_ubm']:.1f} ms ({klog['rounds']} rounds, "
          f"{klog['iterations']} Lloyd iterations, {klog['host_syncs']} "
          "host syncs; by stage " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in stages.items())
          + f"); with EM (fit_with_init, as GMMSet.train): "
          f"{t['train_ubm']:.1f} ms, k-means {tl['kmeans_rounds']} rounds / "
          f"{tl['kmeans_iterations']} iterations / "
          f"{tl['kmeans_host_syncs']} syncs, EM {tl['iterations']} "
          f"iterations / {tl['host_syncs']} syncs", flush=True)
    del Xu, mu_, ubm_set

    # the live path through the port's GUI server
    exp_conv = synth.expected(synth.CONV_EXPECTED)
    app = gui.GuiApp(model=ModelInterface(PipelineConfig(gmm=GmmConfig(
        init_with_kmeans=True)), device=dev), device=dev)
    srv, _ = gui.make_server(port=0, app=app)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with plain_calls() as plain15:
            http(base, "/api/noise", wav_bytes(noise, fs))
            kept = [http(base, f"/api/enroll?name={label}",
                         wav_bytes(clip, fs))["kept"]
                    for label, clip in synth.enrollment_clips()]
            http(base, "/api/train", b"")
            train_log = dict(app.model.gmmset.train_log)
            sec, seed0 = synth.HELDOUT_CONV
            heldout = [http(base, "/api/predict?filter=1", wav_bytes(
                synth.noisy_utterance(label, sec, seed0 + i), fs))["label"]
                for i, label in enumerate(synth.SPEAKER_FREQS)]
            print(f"phase 15 GUI: noise, {len(kept)} filtered enrollments "
                  f"(kept {min(kept)}-{max(kept)} samples), k-means-seeded "
                  f"train {train_log}, held-out labels {heldout}",
                  flush=True)
            if heldout != list(synth.SPEAKER_FREQS):
                raise AssertionError("the k-means-seeded bank mislabels "
                                     "held-out clips")
            http(base, "/api/load", json.dumps(
                {"path": synth.CONV_SESSION}).encode())
            http(base, "/api/conv/start?fs=8000", b"")
            gpu_frontend.LAUNCHES = gpu_gmm.LAUNCHES = 0
            stream = synth.conversation_stream()
            step = int(ConversationSession.CONV_INTERVAL * fs)
            bad_ticks = []
            ticks = 0
            for i in range(0, len(stream), step):
                before = (gpu_frontend.LAUNCHES, gpu_gmm.LAUNCHES)
                r = http(base, "/api/conv/feed",
                         stream[i:i + step].astype("<i2").tobytes())
                grew = (gpu_frontend.LAUNCHES - before[0],
                        gpu_gmm.LAUNCHES - before[1])
                # one launch of each a tick that predicted, none else
                new = app.conv.result_list[ticks:r["ticks"]]
                ticks = r["ticks"]
                n_new = sum(lab is not None for lab in new)
                if grew != (n_new, n_new):
                    bad_ticks.append((ticks, grew))
            timeline = http(base, "/api/conv/timeline")["timeline"]
            labels = list(app.conv.result_list)
            launches15 = {"frontend": gpu_frontend.LAUNCHES,
                          "gmm": gpu_gmm.LAUNCHES}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    want_tl = [{"time": tt, "label": lab} for tt, lab in exp_conv["timeline"]]
    n_pred = sum(lab is not None for lab in labels)
    print(f"phase 15 conversation, {len(stream) / fs:g} s in "
          f"{len(labels)} ticks ({n_pred} predicting): timeline "
          f"{[(e['time'], e['label']) for e in timeline]} equals the JAX "
          f"package's {timeline == want_tl}; per-tick labels equal "
          f"{labels == [k['label'] for k in exp_conv['ticks']]}; launches "
          f"{launches15}, ticks off one launch a predicting tick "
          f"{bad_ticks}; plain versions run {plain15}", flush=True)
    if (timeline != want_tl or bad_ticks
            or labels != [k["label"] for k in exp_conv["ticks"]]
            or launches15 != {"frontend": n_pred, "gmm": n_pred}
            or (dev.type == "cuda" and plain15)):
        raise AssertionError("the live path disagrees with the JAX "
                             "package's timeline or its launches")

    # timing of the live path on the JAX-calibrated session
    live = ModelInterface.load(synth.CONV_SESSION, device=dev)
    window = stream[int(2.0 * fs):int(3.5 * fs)].astype(np.float64)
    tick = lambda: live.predict(fs, live.filter(fs, window))  # noqa: E731
    # K1 and K2 at the shapes a tick gives them, against their plain
    # versions on the padded batch the tick built
    batches = []
    predict_scores = fastpath.predict_scores
    fastpath.predict_scores = lambda *a: batches.append(a) or \
        predict_scores(*a)
    try:
        tick()
    finally:
        fastpath.predict_scores = predict_scores
    sig_t, len_t, bank_t, fs_t, cfg_t = batches[0][:5]
    fe_t = extract.frontend(fs_t, cfg_t, dev)
    if not isinstance(fe_t, PackedFrontend) or len(batches) != 1:
        raise AssertionError("a tick did not take the packed route once")
    err_fe = max(err_fe, check_frontend(
        f"a tick's batch {tuple(sig_t.shape)}", fe_t, sig_t, len_t,
        phase=15))
    feats_t, mask_t = fe_t(sig_t, len_t)
    err_gmm = max(err_gmm, check_scoring(
        f"the session's bank {bank_t.n_speakers} x {bank_t.n_mixtures}, a "
        f"tick's batch", bank_t, feats_t, mask_t, phase=15))
    want_t = gpu_gmm.batch_bank_avg_loglik_reference(
        bank_t, gpu_frontend.packed_from_signals_reference(
            *frontend_args(fe_t, sig_t, len_t)), mask_t)
    check_fused("a tick's predict_scores vs the plain versions",
                predict_scores(*batches[0]), want_t, phase=15)
    del batches, feats_t, mask_t, want_t
    t["tick"] = time_ms(tick, reps=1)
    t["init_noise"] = time_ms(lambda: live.init_noise(fs, noise), reps=1)
    print(f"phase 15 [{card}] conversation tick (filter + predict of a "
          f"1.5 s window): {t['tick']:.3f} ms; " + device_times(tick),
          flush=True)
    print(f"phase 15 [{card}] init_noise ({synth.NOISE_SECONDS:g} s): "
          f"{t['init_noise']:.3f} ms", flush=True)
    trainers = {}
    for name, km in (("train_kmeans", True), ("train_plain", False)):
        trainers[name] = ModelInterface(PipelineConfig(gmm=GmmConfig(
            init_with_kmeans=km)), device=dev)
        trainers[name].init_noise(fs, noise)
        for label, clip in synth.enrollment_clips():
            trainers[name].enroll(label, fs,
                                  trainers[name].filter(fs, clip))
    t.update(time_interleaved({k: m.train for k, m in trainers.items()},
                              reps=1))
    Xe, me = _pad_stack([np.concatenate(f) for f in
                         trainers["train_kmeans"].features.values()])
    Xe = torch.tensor(Xe, dtype=torch.float32, device=dev)
    me = torch.from_numpy(me).to(dev)
    t["seed_conv"] = time_ms(lambda: kmeans.kmeansii_device(Xe, me, 32),
                             reps=1)
    tk_, tp_ = (trainers[k].gmmset.train_log for k in trainers)
    print(f"phase 15 [{card}] ModelInterface.train, 3 speakers x 12 s "
          f"filtered, GMM-32: k-means-seeded {t['train_kmeans']:.3f} ms "
          f"({tk_}), plain init {t['train_plain']:.3f} ms ({tp_}), in the "
          f"same trials; the seeding alone {t['seed_conv']:.3f} ms "
          f"({t['seed_conv'] / t['train_kmeans']:.1%} of k-means-seeded "
          "training)", flush=True)

    entries16, routes16 = phase16(rng, dev, card, bench_sig, bench_len)
    phase17(rng, dev, card, bench_sig, bench_len)
    phase18(dev, card, seed)
    feats19 = phase19(dev, card)
    entries20 = phase20(dev, card, feats19)
    bench_feats, bench_mask = fe8(bench_sig, bench_len)
    entries21 = phase21(
        rng, dev, card, bench_sig, bench_len, fe8, fe8c, bench_bank,
        {"bench_feats": (bench_feats, bench_mask),
         "cases": (("UBM-scale bank 80 x 256, B=8", ubm_bank,
                    bench_feats[:8].contiguous(),
                    bench_mask[:8].contiguous()),
                   ("bank 4 x 1024, B=64", k1024_bank, f64, m64),
                   (f"bank 4 x 32 at d = {cfg102.dim} (16 kHz)", bank102,
                    f102, m102))},
        {"cases": (("bench bank 4 x 32 + UBM, 5 s", serial_banks["bench"],
                    x5, m5),
                   ("80 x 256 bank + UBM, 3 s", serial_banks["ubm"], x3, m3),
                   ("1024 components + UBM, 5 s",
                    random_bank(rng, 5, 1024, d, dev), x5, m5),
                   ("1024 components + UBM, 150 s clip",
                    random_bank(rng, 5, 1024, d, dev), x150, m150)),
         "timed": (serial_banks["bench"], x5, m5)},
        (s48p, l48p))

    # 22. the full-spectrum frontend from the signals, the LPC cepstra in
    # the signal kernels' tail
    entries22 = phase22(rng, dev, card, bench_sig, bench_len, fe8,
                        bench_bank, t)

    # the kernels' bounds, from this run's shapes
    B8, Lp8 = bench_sig.shape
    T8 = n_frames(Lp8, fe8.frame_len, fe8.frame_shift)
    valid8 = int(args13[1].sum())
    nmel, nceps = fe8.dct.shape
    nac = fe8.A.shape[1]
    SK = bench_bank.n_speakers * bench_bank.n_mixtures
    # window and pre-emphasis: 3 FLOPs a sample
    fe_work = frontend_flops(valid8, fe8.n_fft, (fe8.fft_mel, fe8.fft_acorr),
                             nceps, order=nac - 1, window=3 * fe8.frame_len)
    op_bytes = 4 * sum(x.numel() for x in (fe8.D, fe8.W, fe8.dct, fe8.A))
    T48 = n_frames(padded(L48), fe48.frame_len, fe48.frame_shift)
    bank_bytes = 4 * (bench_bank.op.numel() + bench_bank.cw.numel())
    bounds = {
        "packed_frontend": bound(fe_work, 4 * B8 * Lp8 + op_bytes
                                 + 4 * B8 * T8 * d),
        "packed_frontend_raw": bound(
            frontend_flops(valid8, fe8c.n_fft, (fe8c.fft_mel, fe8c.fft_acorr),
                           nceps, window=3 * fe8c.frame_len),
            4 * B8 * Lp8 + op_bytes + 4 * B8 * T8 * (nceps + nac)),
        # K2's tensor route: the product in three TF32 passes
        "bank_avg_loglik": bound(0.0, 4 * B8 * T8 * d + B8 * T8 + bank_bytes
                                 + 4 * B8 * bench_bank.n_speakers,
                                 tf32_flops=3 * score_flops(valid8, d, SK)),
        "bank_sum_loglik": bound(
            score_flops(int(m5.sum()), d, sb.n_speakers * sb.n_mixtures),
            4 * x5.numel() + m5.numel() + 4 * (sb.op.numel() + sb.cw.numel())
            + 4 * sb.n_speakers),
        "packed_from_frames": bound(
            frontend_flops(B8 * T8, fe8c.n_fft,
                           (fe8c.fft_mel, fe8c.fft_acorr), nceps,
                           window=3 * fe8c.frame_len),
            4 * B8 * T8 * (fe8c.frame_len + nceps + fe8c.A.shape[1])
            + 4 * sum(x.numel() for x in (fe8c.D, fe8c.W, fe8c.dct,
                                          fe8c.A))),
        "mfcc_from_frames": bound(
            frontend_flops(BENCH_B * T48, fe48.n_fft, (fe48.mel, fe48.acorr),
                           nceps),
            4 * BENCH_B * T48 * (fe48.frame_len + nceps
                                 + fe48.acorr.shape[1])
            + 4 * sum(x.numel() for x in (fe48.mel, fe48.dct, fe48.acorr))),
        # the dense template and the chirp-z kernel compute one function
        # on the same frames (K5 at fft_size 1500, 216 outputs)
        "mfcc_from_frames_1500": bound(
            frontend_flops(n_frames216, fe216.n_fft,
                           (fe216.mel, fe216.acorr), fe216.dct.shape[1]),
            4 * n_frames216 * (fe216.frame_len + fe216.dct.shape[1]
                               + fe216.acorr.shape[1])
            + 4 * sum(x.numel() for x in (fe216.mel, fe216.dct,
                                          fe216.acorr))),
        "fused": bound(fe_work + score_flops(valid8, d, SK),
                       4 * B8 * Lp8 + 4 * B8 + op_bytes + bank_bytes
                       + 4 * B8 * bench_bank.n_speakers),
    }
    for k in ("fused", "fused_bf16", "wide", "fused_plain",
              "fused_plain_dense", "fused_plain_bf16", "predict"):
        share = bounds["fused"]["bound_ms"] / t[k]
        print(f"phase 13 [{card}] {k}: {t[k]:.3f} ms, FP32 roofline share "
              f"{share:.1%} (bound {bounds['fused']['bound_ms']:.3f} ms, "
              f"{bounds['fused']['bound_by']}), 512 x 5 s @ 8 kHz, 4 x 32 "
              "bank", flush=True)

    def entry(name, source, replaces, launched, err, ms, plain_ms, key):
        return {"name": name, "route": "cuda",
                "source": f"speaker_recognition_tpu_torch/csrc/{source}",
                "replaces": f"speaker_recognition_tpu/ops/{replaces}",
                "launches": launched, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, **bounds[key], "library_ms": None}

    print(f"run: {time.perf_counter() - t_start:.1f} s in all, of it the "
          f"build {_build.build_seconds:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        entry("packed_frontend", "frontend.cu", "pallas_frontend.py:231",
              launches["frontend"], err_fe, t["frontend"],
              t["frontend_plain"], "packed_frontend"),
        entry("packed_frontend_raw_autocorr", "frontend.cu",
              "pallas_frontend.py:231", launches5["k1_tile"], err_raw,
              t["frontend_raw"], t["frontend_raw_plain"],
              "packed_frontend_raw"),
        entry("bank_avg_loglik", "gmm_score.cu", "pallas_gmm.py:154",
              launches["gmm"], err_gmm, t["gmm"], t["gmm_plain"],
              "bank_avg_loglik"),
        entry("bank_sum_loglik", "gmm_serial.cu", "pallas_gmm.py:47",
              launches2["serial"], err_serial, t["serial"],
              t["serial_plain"], "bank_sum_loglik"),
        entry("packed_from_frames", "frontend_frames_fft.cu",
              "pallas_frontend.py:111", launches5["frames"], err_frames,
              t["frames"], t["frames_plain"], "packed_from_frames"),
        entry("mfcc_from_frames", "frontend_fft.cu",
              "pallas_frontend.py:50", launches3["full"], err_full,
              t["full"], t["full_plain"], "mfcc_from_frames"),
        entry("fused_bank_predict", "predict_fused.cuh",
              "pallas_predict.py:91", launches4["fused"], err_k6,
              t["fused"], t["fused_plain"], "fused"),
        entry("fused_bank_predict_wide", "predict_fused.cuh",
              "pallas_predict.py:215", launches4["wide"], err_k7, t["wide"],
              t["fused_plain"], "fused"),
        entry("fused_bank_predict_bf16", "predict_fused.cuh",
              "pallas_predict.py:91", launches4["bf16"], err_bf16,
              t["fused_bf16"], t["fused_plain_bf16"], "fused"),
        entry("mfcc_from_frames_dense", "frontend_frames.cu",
              "pallas_frontend.py:50", launches_dense, err_dense,
              t["dense216"], t["dense216_plain"], "mfcc_from_frames_1500"),
        entry("mfcc_from_frames_chirp", "frontend_chirp.cu",
              "pallas_frontend.py:50", launches_chirp, err_chirp,
              t["chirp216"], t["chirp216_plain"], "mfcc_from_frames_1500"),
    ] + [{"name": name, "route": "cuda",
          "source": f"speaker_recognition_tpu_torch/csrc/{source}",
          "replaces": f"speaker_recognition_tpu/ops/{replaces}",
          "launches": launched, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, **b, "library_ms": None}
         for name, source, replaces, launched, err, ms, plain_ms, b
         in entries16 + entries13 + entries20 + entries21 + routes16
         + chirp_routes + entries22]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
