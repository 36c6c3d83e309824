"""chip_smoke.py rehearsed on the CPU, at 16 utterances where it takes 512
(and 0.5 s where the 96, 192 and 384 kHz batches take 5 s, 70 utterances
and speakers where the grid phase takes 70,000, 4 speakers x 3 s where the
UBM-scale k-means seeding of phase 15 takes 80 x 30 s, and phase 18's JFA
corpus and model cut from 200 background speakers x 3 x 10 s, K = 32, nv =
32, nu = 16 to 12 x 3 x 2 s, K = 8, nv = 4, nu = 2, and one trial of one
call where the timings of the chirp on the cluster, the dense template
past it and the four-step route's small cases take 7 x 3 or 5 x 1: on the
CPU their plain versions are dense products of many GFLOP; and 2 x 6
samples where the dense template past the chirp-z reach takes 2 x 96:
its C and S hold 8,388,612 bins).

    python tests/test_torch_chip_smoke.py    # ~3 min
    python tests/test_torch_chip_smoke.py phase16   # one phase function
    python tests/test_torch_chip_smoke.py phase19_20  # the RBM family and
                                                      # multi-device phases
    python tests/test_torch_chip_smoke.py phase21   # the bf16 modes
    python tests/test_torch_chip_smoke.py phase22   # K5 from the signals,
                                                    # the LPC cepstra in K1

Every kernel wrapper is replaced by its plain torch version (for the
frontends, by the wrapper itself, which on CPU tensors runs its plain
version; past 512 outputs K1's and K4's by the FFT route's plain
version), which counts its calls in the wrapper's launch counter and
asserts that every tensor argument is contiguous (a kernel reads raw
pointers; the plain versions accept views); CUDA events time on the host clock, and the CLI runs with
`--device cpu`. This finds wrong paths, shapes, arguments and control flow
in the on-card check without a card; the numbers it prints are CPU
numbers, none of them a device metric. The test runs it in a subprocess
(it patches torch.cuda) and reads its last two lines. Phase 21's bank of
80 voices is cut to 8 voices x 2 s, each tested once on 1 s.
"""

import functools
import json
import os
import subprocess
import sys
import time
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from speaker_recognition_tpu_torch import _build  # noqa: E402
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    gpu_frontend, gpu_gmm, gpu_predict)

# chip_smoke.py's text -> the rehearsal's
EDITS = [
    ("BENCH_B, BENCH_FS, BENCH_SEC = 512, 8000, 5.0",
     "BENCH_B, BENCH_FS, BENCH_SEC = 16, 8000, 5.0"),
    ('dev = torch.device("cuda", 0)', 'dev = torch.device("cpu")'),
    ("if not torch.cuda.is_available():", "if False:"),
    ('"--device", "cuda"', '"--device", "cpu"'),
    ("GRID_B = 70000", "GRID_B = 70"),
    ("HIGH_SEC = BENCH_SEC", "HIGH_SEC = 0.5"),
    ("KM_SPEAKERS, KM_SECONDS, KM_K = 80, 30.0, 256",
     "KM_SPEAKERS, KM_SECONDS, KM_K = 4, 3.0, 256"),
    ("JFA_BG, JFA_BG_SESSIONS, JFA_SEC = 200, 3, 10.0",
     "JFA_BG, JFA_BG_SESSIONS, JFA_SEC = 12, 3, 2.0"),
    ("JFA_EVAL, JFA_ENROLL, JFA_TESTS, JFA_TEST_SEC = 20, 2, 10, 3.0",
     "JFA_EVAL, JFA_ENROLL, JFA_TESTS, JFA_TEST_SEC = 4, 2, 2, 1.5"),
    ("JFA_K, JFA_NV, JFA_NU, JFA_ITERS, JFA_UBM_ITERS = 32, 32, 16, 20, 100",
     "JFA_K, JFA_NV, JFA_NU, JFA_ITERS, JFA_UBM_ITERS = 8, 4, 2, 5, 10"),
    ("CRBM_SPEAKERS, CRBM_SEC, CRBM_TESTS, CRBM_TEST_SEC = 4, 16.0, 3, 3.0",
     "CRBM_SPEAKERS, CRBM_SEC, CRBM_TESTS, CRBM_TEST_SEC = 4, 4.0, 2, 2.0"),
    ("CRBM_CLI_EPOCHS = 100", "CRBM_CLI_EPOCHS = 10"),
    ("MULTI_ITERS, MULTI_S, SEQ_SEC = 50, 16, 60.0",
     "MULTI_ITERS, MULTI_S, SEQ_SEC = 10, 16, 6.0"),
    ("SCALING_FRAMES = 262_144", "SCALING_FRAMES = 4096"),
    ("ROUTE_TRIALS, SMALL_TRIALS = (7, 3), (5, 1)",
     "ROUTE_TRIALS, SMALL_TRIALS = (1, 1), (1, 1)"),
    ("PAST_REACH_LENGTHS = (96, 64)", "PAST_REACH_LENGTHS = (6, 4)"),
    ("SIGNAL_TRIALS = (7, 3)", "SIGNAL_TRIALS = (1, 1)"),
    ("FLIP_SPEAKERS, FLIP_SEC, FLIP_TESTS, FLIP_TEST_SEC = 80, 30.0, 2, 3.0",
     "FLIP_SPEAKERS, FLIP_SEC, FLIP_TESTS, FLIP_TEST_SEC = 8, 2.0, 1, 1.0"),
]


class _HostEvent:
    """torch.cuda.Event on the host clock."""

    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counting(mod, name: str, plain, counter):
    """Replace mod.name by `plain`, counted in mod.counter (or in the
    counters that counter(*args, **kw) names)."""
    @functools.wraps(plain)
    def wrapper(*args, **kw):
        for i, a in enumerate([*args, *kw.values()]):
            tensors = [a] if isinstance(a, torch.Tensor) else [
                getattr(a, f) for f in ("op", "cw", "window", "mel", "acorr")
                if isinstance(getattr(a, f, None), torch.Tensor)]
            for t in tensors:
                assert t.is_contiguous(), (name, i, tuple(t.shape))
        for c in (counter(*args, **kw) if callable(counter) else (counter,)):
            setattr(mod, c, getattr(mod, c) + 1)
        return plain(*args, **kw)
    setattr(mod, name, wrapper)


def _tile_counters(n_fft: int, nout: int, tile: str, big: str):
    """The counters an FFT kernel's launch moves on the card: the four-step
    route's from N = 32768 on (and BIG_PASSES_LAUNCHES past the cluster's
    reach), else the tile's (and CHUNKED_LAUNCHES past 512 outputs)."""
    if n_fft >= gpu_frontend.BIG_N:
        if n_fft > gpu_frontend.CLUSTER_MAX_N:
            gpu_frontend.BIG_PASSES_LAUNCHES += 1
        return (big,)
    return (tile, "CHUNKED_LAUNCHES") if nout > 512 else (tile,)


def _signals_counter(*args, fft=None, mm_bf16=False, n_lpcc=0, **kw):
    """K1's counters: the bf16 kernel's, the LPC-cepstra kernel's below
    BIG_N (csrc/frontend_lpcc_signals.cu), else the tile's or the
    four-step route's."""
    if mm_bf16:
        return ("BF16_LAUNCHES",)
    tile = ("LPCC_SIGNAL_LAUNCHES" if n_lpcc > 0
            and fft.n_fft < gpu_frontend.BIG_N else "LAUNCHES")
    return _tile_counters(fft.n_fft, fft.mel.shape[1] + fft.acorr.shape[1],
                          tile, "BIG_LAUNCHES")


def _frames_counter(*args, fft=None, mm_bf16=False, **kw):
    if mm_bf16:
        return ("FRAMES_BF16_LAUNCHES",)
    return _tile_counters(fft.n_fft, fft.mel.shape[1] + fft.acorr.shape[1],
                          "FRAMES_LAUNCHES", "FRAMES_BIG_LAUNCHES")


def _precision_counter(f32: str, bf16: str):
    """The counter a scoring wrapper's kernel moves at its precision."""
    return lambda *a, precision="f32", **kw: (
        (bf16,) if precision == "bf16" else (f32,))


def _batch_counter(bank, feats, mask, precision="f32"):
    """The counters K2's launch moves: BF16_LAUNCHES at bf16, else
    LAUNCHES, and TENSOR_LAUNCHES too where its depth takes the tensor
    route (d <= gpu_gmm.TENSOR_MAX_DIM)."""
    if precision == "bf16":
        return ("BF16_LAUNCHES",)
    if feats.shape[-1] <= gpu_gmm.TENSOR_MAX_DIM:
        return ("LAUNCHES", "TENSOR_LAUNCHES")
    return ("LAUNCHES",)


def _fft_past_512(name, fft_plain):
    """gpu_frontend.name, but past 512 mel + autocorrelation outputs the FFT
    route's plain version: what the card's chunked kernel computes, held
    to both plain versions by chip_smoke.py phase 16."""
    dense = getattr(gpu_frontend, name)

    @functools.wraps(dense)
    def run(*args, fft=None, mm_bf16=False, **kw):
        if (not mm_bf16 and fft is not None
                and fft.mel.shape[1] + fft.acorr.shape[1] > 512):
            return fft_plain(*args, fft=fft, **kw)
        return dense(*args, fft=fft, mm_bf16=mm_bf16, **kw)
    return run


def _signals_fft(signals, n_valid, D, W, dct, A, floor, fshift, cmvn,
                 fft=None, fuse_lpc=True, n_lpcc=0):
    return gpu_frontend.packed_from_signals_fft_reference(
        signals, n_valid, fft, dct, floor, fshift, cmvn, fuse_lpc, n_lpcc)


def _frames_fft(frames, D, W, dct, floor, A, fft=None):
    return gpu_frontend.packed_from_frames_fft_reference(frames, fft, dct,
                                                         floor)


def _full_counter(wp, C, S, mel, dct, floor, acorr, n_fft):
    """The counters of the kernel mfcc_from_frames takes on the card (the
    chirp-z route past M = 131072 on the device-memory passes, counted in
    BIG_PASSES_LAUNCHES as well)."""
    if n_fft & (n_fft - 1):
        M = gpu_frontend.chirp_size(n_fft, wp.shape[-1])
        if M > gpu_frontend.CHIRP_CLUSTER_M:
            return ("FULL_CHIRP_LAUNCHES", "BIG_PASSES_LAUNCHES")
        return ("FULL_CHIRP_LAUNCHES",) if M else ("FULL_DENSE_LAUNCHES",)
    return _tile_counters(n_fft, mel.shape[1] + acorr.shape[1],
                          "FULL_LAUNCHES", "FULL_BIG_LAUNCHES")


def _full_signals_counter(signals, n_valid, fft, *args, **kw):
    """The counters mfcc_from_signals' kernel moves: its own, and
    CHUNKED_LAUNCHES past 512 outputs."""
    nout = fft.mel.shape[1] + fft.acorr.shape[1]
    return (("FULL_SIGNAL_LAUNCHES", "CHUNKED_LAUNCHES") if nout > 512
            else ("FULL_SIGNAL_LAUNCHES",))


def _chirp_past_cluster(wp, C, S, mel, dct, floor, acorr, n_fft):
    """gpu_frontend.mfcc_from_frames, but on the chirp-z route past M =
    131072 the FFT route's plain version: the function the card's kernel on
    the passes computes, held to the dense and chirp-z plain versions by
    chip_smoke.py phase 15 (on the CPU the wrapper runs the dense plain
    version: 85 GFLOP a call at fft_size 261634)."""
    if gpu_frontend.chirp_size(n_fft, wp.shape[-1]) > \
            gpu_frontend.CHIRP_CLUSTER_M:
        return gpu_frontend.mfcc_from_frames_fft_reference(
            wp, mel, dct, floor, acorr, n_fft)
    return _mfcc_from_frames(wp, C, S, mel, dct, floor, acorr, n_fft)


_mfcc_from_frames = gpu_frontend.mfcc_from_frames


def _fused(fn_name, counter):
    """The monolith's wrapper as the card runs it: f32 on the FFT route
    (fft=), its plain version counted in `counter` (in BIG_LAUNCHES from
    N = 32768 on, and in CHUNKED_LAUNCHES as well past 512 outputs); bf16
    on the dense route, counted in BF16_LAUNCHES."""
    def plain(signals, n_valid, bank, fshift, D, W, dct_t, floor, A,
              cmvn=True, mm_bf16=False, fft=None):
        if mm_bf16:
            gpu_predict.BF16_LAUNCHES += 1
            return gpu_predict.fused_bank_predict_reference(
                signals, n_valid, bank, fshift, D, W, dct_t, floor, A, cmvn,
                mm_bf16=True)
        assert fft is not None, "the f32 kernel runs the FFT route"
        for c in _tile_counters(fft.n_fft,
                                fft.mel.shape[1] + fft.acorr.shape[1],
                                counter, "BIG_LAUNCHES"):
            setattr(gpu_predict, c, getattr(gpu_predict, c) + 1)
        return gpu_predict.fused_bank_predict_fft_reference(
            signals, n_valid, bank, fshift, dct_t, floor, fft, cmvn)

    def wrapper(*args, **kw):
        for i, a in enumerate([*args, *kw.values()]):
            tensors = [a] if isinstance(a, torch.Tensor) else [
                getattr(a, f) for f in ("op", "cw", "window", "mel", "acorr")
                if isinstance(getattr(a, f, None), torch.Tensor)]
            for t in tensors:
                assert t.is_contiguous(), (fn_name, i, tuple(t.shape))
        return plain(*args, **kw)
    setattr(gpu_predict, fn_name, wrapper)


def main():
    torch.set_num_threads(2)
    _build.load = lambda: None
    _build.build_log = os.devnull
    torch.cuda.Event = _HostEvent
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
    torch.cuda.device_count = lambda: 0
    torch.cuda.empty_cache = lambda: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    # the frontend wrappers take their kernels' operators beside the plain
    # versions' (the FFT route's, n_fft): on CPU tensors they run the plain
    # versions themselves
    stand_ins = {"packed_from_signals": _fft_past_512("packed_from_signals",
                                                      _signals_fft),
                 "packed_from_frames": _fft_past_512("packed_from_frames",
                                                     _frames_fft),
                 "mfcc_from_frames": _chirp_past_cluster}
    for name, counter in (("packed_from_signals", _signals_counter),
                          ("packed_from_frames", _frames_counter),
                          ("mfcc_from_frames", _full_counter),
                          ("mfcc_from_signals", _full_signals_counter),
                          ("mfcc_from_frames_dense", "FULL_DENSE_LAUNCHES")):
        _counting(gpu_frontend, name,
                  stand_ins.get(name, getattr(gpu_frontend, name)), counter)
    for mod, name, counter in (
            (gpu_gmm, "batch_bank_avg_loglik", _batch_counter),
            (gpu_gmm, "bank_sum_loglik",
             _precision_counter("SERIAL_LAUNCHES", "SERIAL_BF16_LAUNCHES")),
            (gpu_gmm, "bank_avg_loglik", "SERIAL_LAUNCHES")):
        _counting(mod, name, getattr(mod, name + "_reference"), counter)
    _fused("fused_bank_predict", "LAUNCHES")
    _fused("fused_bank_predict_wide", "WIDE_LAUNCHES")
    gpu_predict.bf16_tile = lambda flen, fshift, nout, d: "not built (CPU)"

    path = os.path.join(REPO, "chip_smoke.py")
    with open(path) as f:
        src = f.read()
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"chip_smoke.py no longer has {old!r}")
        src = src.replace(old, new)
    smoke = types.ModuleType("chip_smoke")
    smoke.__file__ = path
    exec(compile(src, path, "exec"), smoke.__dict__)
    smoke.smi = lambda: "CPU rehearsal, no power limit"
    smoke.device_times = lambda fn, calls=20: "device not measured (CPU)"
    smoke.kernels_per_call = lambda fn, **kw: {"serial_kernel": 1.0}
    smoke.kernel_times = lambda fn, **kw: "not measured (CPU)"
    smoke.occupancy = lambda *a, **kw: "occupancy not measured (CPU)"
    smoke.signal_occupancy = lambda *a: "occupancy not measured (CPU)"
    if len(sys.argv) > 1:  # one phase function: phase16, 17 or 18
        import numpy as np
        rng, dev, card = (np.random.RandomState(0), torch.device("cpu"),
                          "CPU rehearsal")
        bench = smoke.signals_batch(rng, [40000] * 16, 40960, dev)
        args = {"phase13_lifted": (rng, dev, card,
                                   smoke.random_bank(rng, 4, 32, 28, dev)),
                "phase16": (rng, dev, card, *bench),
                "phase17": (rng, dev, card, *bench),
                "phase18": (dev, card)}.get(sys.argv[1])
        if sys.argv[1] == "phase19_20":
            smoke.phase20(dev, card, smoke.phase19(dev, card))
            return
        if sys.argv[1] == "phase21":
            _phase21(smoke, rng, dev, card, bench)
            return
        if sys.argv[1] == "phase22":
            from speaker_recognition_tpu_torch.config import FeatureConfig
            from speaker_recognition_tpu_torch.features.extract import (
                PackedFrontend)
            smoke.phase22(rng, dev, card, *bench,
                          PackedFrontend(8000, FeatureConfig(), dev),
                          smoke.random_bank(rng, 4, 32, 28, dev),
                          {"frontend": 1.0})
            return
        getattr(smoke, sys.argv[1])(*args)
        return
    smoke.main([])


def _phase21(smoke, rng, dev, card, bench):
    """Phase 21 alone, on stand-ins for main's banks and utterances."""
    from speaker_recognition_tpu_torch.config import FeatureConfig, LpcConfig
    from speaker_recognition_tpu_torch.features.extract import PackedFrontend

    fe8 = PackedFrontend(8000, FeatureConfig(), dev)
    fe8c = PackedFrontend(8000, FeatureConfig(lpc=LpcConfig(n_lpcc=16)),
                          dev)
    feats, mask = fe8(*bench)
    bank = smoke.random_bank(rng, 4, 32, 28, dev)
    x5, m5 = smoke.utterance(feats[0], int(mask[0].sum()), dev)
    s48, l48 = smoke.signals_batch(rng, [48000, 30000], 49152, dev)
    smoke.phase21(
        rng, dev, card, *bench, fe8, fe8c, bank,
        {"bench_feats": (feats, mask),
         "cases": (("bank 6 x 16, B=4", smoke.random_bank(rng, 6, 16, 28,
                                                          dev),
                    feats[:4].contiguous(), mask[:4].contiguous()),)},
        {"cases": (("bank 5 x 32", bank, x5, m5),), "timed": (bank, x5, m5)},
        (s48, l48))


KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_chip_smoke_rehearses_on_the_cpu():
    """All twenty-two phases pass on the CPU; the kernels record lists the
    seven TPU kernels (K1 in both its modes, K6 in both its routes, K5's
    dense template and its chirp-z kernel), then the routes of phase 16 (K1, K4 and K5 on the
    four-step FFT of N >= 32768 and past 512 outputs, K6's lifted bf16
    route), phase 13's lifted f32 monolith (N = 32768 on the four-step
    route's single block, 65536 on a cluster of 2, 616 outputs), phase
    20's multi-device path (K3 on the bank-sharded scoring, K1 on the
    sequence-sharded features), phase 21's bf16 operand modes (K1, K4, K2,
    K3), then the four-step route's other sizes (K1 at 65536, K5 at 262144
    on a cluster of 8 and at 524288 on the device-memory passes) and
    phase 15's chirp-z route on the cluster (M = 16384 and 32768) and past
    it on the device-memory passes (M = 262144), then phase 22's kernels
    (K5 from the signals, K1's LPC-cepstra mode on its own source, csrc/
    frontend_lpcc_signals.cu), with every key, each launched on its path
    but K4, K1's raw-autocorrelation mode and K5's frame-level FFT kernel
    at a power-of-two fft_size, which no serving path takes (their
    launches against their plain versions are demanded by phases 10, 11
    and 16 themselves), K1 and K5 with their FFT kernels' sources; the 8192-
    and 16384-point FFTs, 266 outputs, the 96 kHz CLI slice, the
    monolith's cases, the grid phase, the live path (216 outputs on the
    chirp-z kernel, the dense template beside it and at 16000, the chirp
    on the passes at 261634, the dense template past the chirp's reach
    through extract_batch, the VAD, k-means, the GUI's conversation with
    the JAX package's
    timeline), the lifted limits, float64 on the device, JFA
    with its CLI, the RBM family with crbm_cli and the multi-device
    programs at world size 1 all run."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                          capture_output=True, text=True, timeout=900,
                          cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is True
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["replaces"].rsplit("/", 1)[1] for k in kernels] == [
        "pallas_frontend.py:231", "pallas_frontend.py:231",
        "pallas_gmm.py:154", "pallas_gmm.py:47",
        "pallas_frontend.py:111", "pallas_frontend.py:50",
        "pallas_predict.py:91", "pallas_predict.py:215",
        "pallas_predict.py:91", "pallas_frontend.py:50",
        "pallas_frontend.py:50",
        "pallas_frontend.py:231", "pallas_frontend.py:111",
        "pallas_frontend.py:50", "pallas_frontend.py:50",
        "pallas_frontend.py:231", "pallas_frontend.py:111",
        "pallas_frontend.py:50", "pallas_predict.py:91",
        "pallas_predict.py:91", "pallas_predict.py:91",
        "pallas_predict.py:91",
        "pallas_gmm.py:47", "pallas_frontend.py:231",
        "pallas_frontend.py:231", "pallas_frontend.py:111",
        "pallas_gmm.py:154", "pallas_gmm.py:47",
        "pallas_frontend.py:231", "pallas_frontend.py:50",
        "pallas_frontend.py:50", "pallas_frontend.py:50",
        "pallas_frontend.py:50", "pallas_frontend.py:50",
        "pallas_frontend.py:50", "pallas_frontend.py:231"]
    assert [k["name"] for k in kernels[11:]] == [
        "packed_frontend_n32768", "packed_from_frames_n32768",
        "mfcc_from_frames_n32768", "mfcc_from_frames_n65536",
        "packed_frontend_616_outputs",
        "packed_from_frames_616_outputs", "mfcc_from_frames_616_outputs",
        "fused_bank_predict_bf16_lifted", "fused_bank_predict_n32768",
        "fused_bank_predict_n65536",
        "fused_bank_predict_616_outputs", "bank_sum_loglik_sharded",
        "packed_frontend_seqshard", "packed_frontend_bf16",
        "packed_from_frames_bf16", "bank_avg_loglik_bf16",
        "bank_sum_loglik_bf16", "packed_frontend_n65536",
        "mfcc_from_frames_n262144", "mfcc_from_frames_n524288",
        "mfcc_from_frames_chirp_m16384", "mfcc_from_frames_chirp_m32768",
        "mfcc_from_frames_chirp_m262144", "mfcc_from_signals",
        "packed_frontend_lpcc"]
    assert kernels[19]["source"].endswith("csrc/predict_fused_big.cu")
    assert kernels[20]["source"].endswith("csrc/predict_fused_big.cu")
    assert [k["source"].rsplit("/", 1)[1] for k in kernels[24:]] == [
        "frontend_bf16.cu", "frontend_bf16.cu", "gmm_score_bf16.cu",
        "gmm_serial_bf16.cu", "rfft_cluster.cu", "rfft_cluster.cu",
        "rfft_passes.cuh", "frontend_chirp_cluster.cu",
        "frontend_chirp_cluster.cu", "frontend_chirp_cluster.cu",
        "frontend_full_signals.cu", "frontend_lpcc_signals.cu"]
    for k in kernels:
        assert set(k) == KERNEL_KEYS, k
        if k["name"].startswith("packed_from_frames") or k["name"] in (
                "mfcc_from_frames", "mfcc_from_frames_616_outputs",
                "packed_frontend_raw_autocorr"):
            assert k["launches"] == 0, k
        else:
            assert k["launches"] >= 1, k
        assert k["bound_by"] in ("operations", "bytes"), k
        assert k["library_ms"] is None and k["route"] == "cuda", k
        assert os.path.exists(os.path.join(REPO, k["source"])), k
    assert kernels[0]["source"].endswith("csrc/frontend.cu")
    assert kernels[1]["source"].endswith("csrc/frontend.cu")
    assert kernels[4]["source"].endswith("csrc/frontend_frames_fft.cu")
    assert kernels[5]["source"].endswith("csrc/frontend_fft.cu")
    assert any(ln.startswith("phase 11 extract_batch, n_lpcc 16") and
               ln.endswith("launches K1 1, K4 0") for ln in lines)
    assert any(ln.startswith("phase 13 two calls bitwise equal: True")
               for ln in lines)
    assert sum("two calls bitwise equal: True" in ln and ln.startswith(
        "phase 2 ") for ln in lines) >= 15
    for shape in ("48 kHz, fft_size 4096", "44.1 kHz, fft_size 4096",
                  "128 mel filters + LPC", "LPC order 40"):
        assert any(ln.startswith("phase 2 ") and shape in ln
                   and "two calls bitwise equal: True" in ln
                   for ln in lines), shape
    assert sum(ln.startswith("phase 6 ") and ln.endswith(
        "device kernels a call 1") for ln in lines) == 11
    assert any(ln.startswith("phase 12 cli enroll + predict @ 48 kHz, "
                             "fft_size 4096") for ln in lines)
    assert kernels[6]["source"].endswith("csrc/predict_fused.cuh")
    assert [k["name"] for k in kernels[6:11]] == [
        "fused_bank_predict", "fused_bank_predict_wide",
        "fused_bank_predict_bf16", "mfcc_from_frames_dense",
        "mfcc_from_frames_chirp"]
    assert kernels[9]["source"].endswith("csrc/frontend_frames.cu")
    assert kernels[10]["source"].endswith("csrc/frontend_chirp.cu")
    assert [k["source"].rsplit("/", 1)[1] for k in kernels[13:15]] == [
        "frontend_big.cu", "frontend_big.cu"]
    for shape in ("96 kHz, fft_size 8192", "192 kHz, fft_size 16384",
                  "266 outputs"):
        assert any(ln.startswith("phase 2 ") and shape in ln
                   and "two calls bitwise equal: True" in ln
                   for ln in lines), shape
    for shape in ("96 kHz, fft_size 8192", "192 kHz, fft_size 16384",
                  "192 kHz, fft_size 8192", "266 outputs"):
        assert any(ln.startswith("phase 10 ") and shape in ln
                   for ln in lines), shape
    for shape in ("fft_size 1500, 50 mel filters (chirp-z kernel)",
                  "fft_size 1500, 128 mel filters (chirp-z kernel)",
                  "44.1 kHz, fft_size 1411 (flen 1411, M 4096, chirp-z",
                  "48 kHz, fft_size 1000 (flen 1536, M 2048, chirp-z"):
        assert any(ln.startswith("phase 10 ") and shape in ln
                   and "launches 2 (FULL_CHIRP_LAUNCHES)" in ln
                   for ln in lines), shape
    for shape in ("96 kHz, fft_size 8192", "192 kHz, fft_size 16384",
                  "250 mel filters"):
        assert any(ln.startswith("phase 11 ") and shape in ln
                   for ln in lines), shape
    assert any(ln.startswith("phase 12 cli enroll + predict @ 96 kHz, "
                             "fft_size 8192") for ln in lines)
    for case in ("48 kHz, fft_size 4096", "96 kHz, fft_size 8192",
                 "bank 4 x 1024", "d = 102", "80 x 256 bank",
                 "150 s clip", "n_valid = 0"):
        assert any(ln.startswith(f"phase 13 {case}") and
                   "launches (K6, K7) (2, 2), two calls bitwise equal: True"
                   in ln for ln in lines), case
    assert any(ln.startswith("phase 13 K6 bf16 DFT operands (dense tile)")
               for ln in lines)
    assert any(ln.startswith("phase 14 launches:") for ln in lines)
    for start, end in (
            ("phase 15 8 kHz, fft_size 1500, 200 mel filters + LPC (216 "
             "outputs", "bitwise True"),
            ("phase 15 dense kernel: 144 outputs bitwise equal inside 216",
             "True"),
            ("phase 15 chirp-z kernel: 144 outputs bitwise equal inside 216",
             "True"),
            ("phase 15 dense kernel (direct), 216 outputs", "bitwise True"),
            ("phase 15 extract_batch @ 8 kHz, fft_size 1500, 216 outputs",
             "{'FULL_CHIRP_LAUNCHES': 1}"),
            ("phase 15 8 kHz, fft_size 16000 (chirp-z on the cluster, M "
             "16384)", "{'FULL_CHIRP_LAUNCHES': 1}"),
            ("phase 15 8 kHz, fft_size 33000 (chirp-z on the cluster, M "
             "32768)", "{'FULL_CHIRP_LAUNCHES': 1}"),
            ("phase 15 8 kHz, fft_size 261634 (chirp-z on the passes, M "
             "262144), 2 x 5 s through extract_batch",
             "{'FULL_CHIRP_LAUNCHES': 1, 'BIG_PASSES_LAUNCHES': 1}"),
            ("phase 15 dense kernel (direct), 8 kHz, fft_size 16000",
             "bitwise True"),
            ("phase 15 extract_batch @ 8 kHz, fft_size 16777218 (the dense "
             "template past the chirp-z reach)",
             "{'FULL_DENSE_LAUNCHES': 1}"),
            ("phase 15 dense kernel (direct), 8 kHz, fft_size 16777218",
             "bitwise True"),
            ("phase 15 spectral gate", "two calls bitwise equal True"),
            ("phase 15 a tick's batch (8, 12288): two calls bitwise equal",
             "True")):
        assert any(ln.startswith(start) and ln.endswith(end)
                   for ln in lines), start
    assert any(ln.startswith("phase 15 LTSD") and "identical True" in ln
               for ln in lines)
    assert any(ln.startswith("phase 15 GUI:") and "held-out labels "
               "['alice', 'bob', 'carol']" in ln for ln in lines)
    assert any(ln.startswith("phase 15 conversation") and "equals the JAX "
               "package's True; per-tick labels equal True" in ln
               for ln in lines)
    assert any(ln.startswith("phase 15 [") and "k-means|| seeding" in ln
               and "host syncs" in ln and "rounds" in ln
               and "Lloyd's on the data" in ln for ln in lines)
    assert any(ln.startswith("phase 15 a tick's predict_scores vs the plain "
                             "versions") and "argmax identical True" in ln
               for ln in lines)
    # the fused pass's split at few frames (62 at 8 kHz, 638 at 261634),
    # printed as the library states it (tests/test_torch_cuda_standin.py
    # holds its values)
    for nm, split in (("fft_size 262144,", "S not built (CPU) over 62 frames"),
                      ("fft_size 524288,", "S not built (CPU) over 62 frames"),
                      ("fft_size 261634 (chirp-z on the passes",
                       "split in S not built (CPU))")):
        assert any(ln.startswith(("phase 15 [", "phase 16 [")) and nm in ln
                   and split in ln for ln in lines), nm
    for start, end in (
            ("phase 16 K1 384 kHz through extract_batch",
             "{'BIG_LAUNCHES': 1}"),
            ("phase 16 K5 48 kHz, fft_size 65536", "{'FULL_BIG_LAUNCHES': 1}"),
            ("phase 16 K1 384 kHz, 64 ms frames, fft_size 65536",
             "{'BIG_LAUNCHES': 1}"),
            ("phase 16 K5 8 kHz, fft_size 262144", "{'FULL_BIG_LAUNCHES': 1}"),
            ("phase 16 K5 8 kHz, fft_size 524288",
             "{'FULL_BIG_LAUNCHES': 1, 'BIG_PASSES_LAUNCHES': 1}"),
            ("phase 16 K5 48 kHz, fft_size 524288, 2 x 0.512 s (the "
             "device-memory passes with their column pass)",
             "on the card only"),
            ("phase 16 K1 8 kHz, 200 ms frames, fft_size 4096, 600 mel",
             "{'LAUNCHES': 1, 'CHUNKED_LAUNCHES': 1}"),
            ("phase 16 K1 and K5: 512 outputs bitwise equal inside 616",
             "'K5 cepstra': True, 'K5 lags': False}: False"),
            ("phase 16 K6 bf16 8 kHz", "launches 1, two calls bitwise True"),
            ("phase 16 K6 bf16 96 kHz", "launches 1, two calls bitwise True"),
            ("phase 17 float64 on cpu", "'K1': 0, 'K2': 0, 'K3': 0, "
             "'extract_f64': 29, 'gmm_f64': 23}"),
            ("phase 17 f32 after f64", "K2 1"),
            ("phase 18 jfa_pipeline CLI", "[1.0, 1.0]")):
        assert any(ln.startswith(start) and ln.endswith(end)
                   for ln in lines), start
    assert sum(ln.startswith("phase 18 [") and "JFA acc" in ln
               for ln in lines) == 2
    for start, end in (
            ("phase 13 K6/K7 384 kHz, n_fft 32768", "'BIG_LAUNCHES': 4, "
             "'CHUNKED_LAUNCHES': 0}, two calls bitwise equal True"),
            ("phase 13 K6/K7 8 kHz, n_fft 4096, 600 mel + 16 lags",
             "'BIG_LAUNCHES': 0, 'CHUNKED_LAUNCHES': 4}, two calls bitwise "
             "equal True"),
            ("phase 19 CRBM segments", "True"),
            ("phase 20 sharded_fit bitwise equal to gmm.fit", "True"),
            ("phase 20 train_ubm(mesh=...) bitwise equal", "True")):
        assert any(ln.startswith(start) and ln.endswith(end)
                   for ln in lines), start
    for start, part in (
            ("phase 13 K6/K7 384 kHz", "vs predict_scores (K1 + K2)"),
            ("phase 19 RBM family, card vs CPU", "mlp_sgd_w0"),
            ("phase 19 predict_bank", "same decisions True"),
            ("phase 19 python -m ...tools.crbm_cli", "accuracy: "),
            ("phase 20 sharded_bank_scores", "unsharded K3 call: True; K3 "
             "launches on the sharded path 1"),
            ("phase 20 sharded_mix_feature", "K1 launches on the sharded "
             "path 1"),
            ("phase 20 K1 (CMVN off) vs the float64 route", "frames past "
             "the LPC tolerance"),
            ("phase 20 fft f32 (CMVN off) vs the float64", "frames past "
             "the LPC tolerance"),
            ("phase 20 K1 (CMVN off) vs the float64 route on the voice's "
             "first", "frames past the LPC tolerance"),
            ("phase 20 K1 on the seqshard voice within 2.0x", "against"),
            ("phase 20 [CPU rehearsal", 'scaling_report: {"processes": 1'),
            ("phase 21 K2 bf16 against f32 at 8 x 256", "decisions flip"),
            ("phase 21 predict_scores(mm='bf16'), bench", "launches {'K1 "
             "f32': 0, 'K1 bf16': 1, 'K4 bf16': 0, 'K2 f32': 1, 'K2 bf16': "
             "0, 'K5': 0, 'full bf16': 0}"),
            ("phase 21 predict_scores(mm='bf16') at 48 kHz", "'K1 bf16': 0, "
             "'K4 bf16': 0, 'K2 f32': 1, 'K2 bf16': 0, 'K5': 0, 'full bf16':"
             " 1}"),
            ("phase 21 [CPU rehearsal", "predict_bf16")):
        assert any(ln.startswith(start) and part in ln
                   for ln in lines), start
    for start, n in (("phase 21 K2 bf16", 6), ("phase 21 K3 bf16", 4),
                     ("phase 21 K1 bf16", 5), ("phase 21 K4 bf16", 1)):
        assert sum(ln.startswith(start) and (
            "two calls bitwise equal True" in ln) for ln in lines) == n, start
    # each bf16 check measured how far the f32 mode (and for K2 and K3 the
    # other kernel's x^2 rounding) lies from its bf16 plain version
    for start, n, parts in (
            ("phase 21 K2 bf16", 6, ("f32 mode", "K3's x^2 rounding")),
            ("phase 21 K3 bf16", 4, ("f32 mode", "K2's x^2 rounding")),
            ("phase 21 K1 bf16", 5, ("f32 product's cepstra",)),
            ("phase 21 K4 bf16", 1, ("f32 product's cepstra",)),
            ("phase 21 predict_scores(mm='bf16')", 2, ("f32 slice",))):
        assert sum(ln.startswith(start) and all(p in ln for p in parts)
                   and "x tol: " in ln for ln in lines) == n, start


if __name__ == "__main__":
    main()
