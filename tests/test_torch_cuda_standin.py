"""The cluster FFT's CUDA sources run on the CPU: csrc/rfft_cluster.cu,
frontend_big.cu and frontend_chirp_cluster.cu compiled with g++ against the
stand-in CUDA runtime of tests/cuda_standin/ (each thread of a block an OS
thread, __syncthreads and cluster.sync() barriers, another rank's shared
memory at the same offset in its buffer), called through their C entry
points on CPU tensors: the fused pass's split rule and the scratch of
a chunk of frames (srt_big_ranges, srt_big_scratch_floats) at the shapes
the card runs, then, held to the port's plain versions, K5 on the
four-step route at N = 32768 (one block; also a frame longer than N,
folded), 65536 (a cluster of 2) and 524288 (the device-memory passes of
csrc/rfft_passes.cuh), and on the chirp-z route past M = 8192 at fft_size
16000 (M = 16384), 33000 (M = 32768, a cluster of 2) and 261634 (M =
262144, on the passes). At a few frames the fused pass splits its bins
(rfft_big::ranges), so every case runs the split and its combine. Also
csrc/frontend_full_signals.cu (the full-spectrum frontend from the
signals on csrc/signal_tile.cuh: the sample pairs and their shuffles, the
fold from the signal, the per-bin floor, the projection's TF32 mma.sync
in three terms, through the stand-in's warp exchange, LPC and the LPC
cepstra in the tail, zeros past n_valid) with CMVN off, and K1's
LPC-cepstra mode (csrc/frontend_lpcc_signals.cu: the same tile with the
power unfloored, the LPC cepstra in its tail) at 8 and 16 kHz, both
orders of the pre-emphasis, with CMVN off and on (the stand-in runs the
CMVN kernel's 2-D blocks and static shared arrays), and a model of the
four-step route's projection sums at 2^22-2^24 points. Also the batched
bank scoring, csrc/gmm_score.cu (K2: its tensor route's 3 x TF32 mma.sync
through the stand-in's warp exchange, the fused logsumexp over the
quads' butterflies, the floor; its wide route), through its C entry point
and through ops/gpu_gmm's wrapper and counters. It
checks the kernels' index maps, barriers and exchanges as the source
states them; what nvcc or the card make of them shows only on the card
(chip_smoke.py phases 15 and 16). Skips without g++."""

import ctypes
import functools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu_torch import _build  # noqa: E402
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, LpcConfig, MfccConfig, frame_geometry, n_frames)
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    FullFrontend)
from speaker_recognition_tpu_torch.models.gmm import GmmBank  # noqa: E402
from speaker_recognition_tpu_torch.ops import (  # noqa: E402
    gpu_frontend, gpu_gmm)
from speaker_recognition_tpu_torch.ops import framing, levinson  # noqa: E402
from speaker_recognition_tpu_torch.ops import frontend as operators  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402

STANDIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_standin")
SOURCES = ("rfft_cluster.cu", "frontend_big.cu", "frontend_chirp_cluster.cu",
           "frontend_full_signals.cu", "frontend.cu", "frontend_fft.cu",
           "frontend_lpcc_signals.cu", "gmm_score.cu")


def _rewrite(src: str) -> str:
    """The CUDA syntax the stand-in cannot define: extern __shared__ arrays
    (the block's buffer), static ones (cusim::block_shared, one a block),
    <<<...>>> launches (cusim::launch) and the built-in index variables
    (cusim::ctx)."""
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)cusim::ctx.block->smem.data();", src)
    src = re.sub(r"__shared__ (\w+) (\w+)((?:\[[^\]]+\])+);",
                 r"auto& \2 = cusim::block_shared<\1\3>(__LINE__);", src)
    src = re.sub(r"(\b[\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                 lambda m: f"cusim::launch({m.group(1)}, {m.group(2)})(",
                 src, flags=re.S)
    for name, field in (("threadIdx", "tid"), ("blockIdx", "bid"),
                        ("blockDim", "bdim"), ("gridDim", "gdim")):
        src = re.sub(r"(?<![.>\w])" + name + r"\b", "cusim::ctx." + field,
                     src)
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources against the stand-in")
    d = str(tmp_path_factory.mktemp("cuda_standin"))
    for name in os.listdir(_build.CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, name)) as f:
                src = _rewrite(f.read())
            with open(os.path.join(d, name), "w") as f:
                f.write(src)
    flags = ["-std=c++20", "-O1", "-fPIC", "-I", STANDIN]
    objs, procs = [], []
    for src in [os.path.join(d, s) for s in SOURCES] + [
            os.path.join(STANDIN, "standin.cc")]:
        objs.append(os.path.join(d, os.path.basename(src) + ".o"))
        procs.append(subprocess.Popen(
            [gxx, *flags, "-x", "c++", "-c", src, "-o", objs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate()[0]
        assert p.returncode == 0, out[-3000:]
    so = os.path.join(d, "libstandin.so")
    subprocess.run([gxx, "-shared", "-o", so, *objs, "-lpthread"],
                   check=True)
    lib = ctypes.CDLL(so)
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.srt_big_fft_frames.argtypes = [p_] * 6 + [i_] * 6 + [f_, i_, p_]
    lib.srt_big_operator_shape.argtypes = [i_, i_, ip, ip, ip]
    lib.srt_big_scratch_floats.argtypes = [i_, i_, i_]
    lib.srt_big_scratch_floats.restype = ctypes.c_longlong
    lib.srt_chirp_scratch_floats.argtypes = [i_] * 4
    lib.srt_chirp_scratch_floats.restype = ctypes.c_longlong
    lib.srt_chirp_cluster_frontend.argtypes = [p_] * 8 + [i_] * 6 + [f_, i_,
                                                                     p_]
    lib.srt_big_ranges.argtypes = [i_, i_]
    lib.srt_full_signals_frontend.argtypes = [p_] * 7 + [i_] * 9 + [
        f_, i_, f_, i_, i_, p_]
    lib.srt_packed_frontend.argtypes = [p_] * 7 + [i_] * 9 + [
        f_, i_, f_, i_, i_, p_]
    lib.srt_lpcc_signals_frontend.argtypes = [p_] * 7 + [i_] * 9 + [
        f_, i_, f_, i_, i_, p_]
    lib.srt_fft_operator_shape.argtypes = [i_, i_, ip, ip, ip]
    lib.srt_full_signals_operator_shape.argtypes = [i_, i_, ip, ip, ip, ip]
    lib.srt_fft_wide_floats.argtypes = [ctypes.c_longlong, i_]
    lib.srt_fft_wide_floats.restype = ctypes.c_longlong
    lib.srt_bank_avg_loglik.argtypes = [p_] * 5 + [i_] * 6 + [p_]
    lib.srt_bank_tensor_row.argtypes = [i_]
    lib.srt_bank_warp_frames.argtypes = [i_]
    return lib


def _batch_frames(fs, B, seconds):
    """Frames of B utterances of `seconds` at fs with the default 32 ms
    window and 16 ms shift, padded as chip_smoke.py pads them (length
    buckets of 4096 samples)."""
    flen, shift = frame_geometry(fs, 32.0, 16.0)
    Lp = -(-int(fs * seconds) // 4096) * 4096
    return B * n_frames(Lp, flen, shift)


def test_the_split_engages_only_at_few_frames(lib):
    """The library's split rule (srt_big_ranges: rfft_big::ranges, from
    the chunk's frame and bin counts alone): S = 1 wherever ceil(frames /
    8) blocks reach 128, so phase 16's batches at 32768 and 65536 (8 x 5 s
    at 48 kHz; 4 x 5 s at 384 kHz), each one chunk of the route's scratch,
    keep their kernels' bits; the serving shapes (8 kHz and 48 kHz at the
    default fft_size) do not take the four-step route at all. At phase
    16's few frames (2 x 4096 samples at 8 kHz: 62 frames) and phase 15's
    chirp at 261634 (2 x 5 s: 638 frames) S > 1, about 256 blocks in all,
    each range at least 4096 bins."""
    default = FeatureConfig()
    for fs in (8000, 48000):
        flen, _ = frame_geometry(fs, 32.0, 16.0)
        assert max(default.mfcc.fft_size, flen) < gpu_frontend.BIG_N
    for fs, B, n in ((48000, 8, 32768), (48000, 8, 65536),
                     (384000, 4, 32768)):
        nf = _batch_frames(fs, B, 5.0)
        assert nf >= 1024
        assert gpu_frontend.big_chunk(lib, n, 66, nf) == nf
        assert lib.srt_big_ranges(nf, n // 2 + 1) == 1
    few = _batch_frames(8000, 2, 4096 / 8000)
    assert few == 62
    for n, S in ((262144, 29), (524288, 31)):
        assert lib.srt_big_ranges(few, n // 2 + 1) == S
    assert lib.srt_big_ranges(_batch_frames(8000, 2, 5.0),
                              261634 // 2 + 1) == 4
    for nfc in (1, 7, 62, 300, 1016, 1017, 5000):
        for nb in (16385, 131073, 262145, 4194305):
            S = lib.srt_big_ranges(nfc, nb)
            blocks = -(-nfc // 8)
            if blocks >= 128 or nb < 2 * 4096:
                assert S == 1
                continue
            assert S * blocks < 2 * 256 and nb // S >= 4096


def _frames(n, flen, seed):
    wp = np.random.RandomState(seed).randn(n, flen) * 1000
    wp[1] = 0.0  # a silent frame: every bin on the floor
    return torch.from_numpy(wp.astype(np.float32))


def _close(name, got, want):
    """Pre-CMVN cepstra of O(10-100) within 1e-4 (the f32 FFTs differ by
    ~1e-6 relative on the power), the raw autocorrelation within 1e-5 of
    its largest value."""
    (c, r), (wc, wr) = got, want
    assert torch.isfinite(c).all() and torch.isfinite(r).all(), name
    np.testing.assert_allclose(c.numpy(), wc.numpy(), rtol=0, atol=1e-4,
                               err_msg=name)
    np.testing.assert_allclose(r.numpy(), wr.numpy(), rtol=0,
                               atol=1e-5 * float(wr.abs().max()),
                               err_msg=name)


def _operators(fs, n_fft):
    """(frame_len, floor, mel, dct, acorr) of the full frontend at fs and
    n_fft as f32 CPU tensors, without its C and S (a frontend on the CPU
    builds them: 3 GB at 524288 points)."""
    cfg = FeatureConfig(mfcc=MfccConfig(fft_size=n_fft))
    fe = FullFrontend(fs, cfg, "meta")
    mel, dct = text._mel_dct(fs, cfg.mfcc)
    acorr = levinson.autocorr_operator(fe.frame_len, n_fft, fe.lpc_order)
    pad = ((0, fe.mel.shape[0] - mel.shape[0]), (0, 0))
    return (fe.frame_len, fe.floor,
            *(torch.from_numpy(np.ascontiguousarray(x)).float()
              for x in (np.pad(mel, pad), dct, np.pad(acorr, pad))))


@pytest.mark.parametrize("n_fft,flen,n", [(32768, 1536, 3), (32768, 40000, 3),
                                          (65536, 1536, 3),
                                          (524288, 1536, 2),
                                          (524288, 256, 2)],
                         ids=["32768_one_block", "32768_folded",
                              "65536_two_ranks", "524288_passes",
                              "524288_passes_short_frame"])
def test_the_four_step_route_on_the_cluster(lib, n_fft, flen, n):
    """srt_big_fft_frames (the spectrum kernel on a block or a cluster of
    2, or the column and row passes at 524288, the row pass alone, loading
    from the frame, for a frame of 256 samples, then the fused projection
    pass on the power rows, split over the bins) against
    mfcc_from_frames_fft_reference, 48 kHz operators, n frames; two calls
    give the same bits (one call on the passes, ~10 s in the stand-in); at
    these few frames the fused pass splits its bins."""
    _, floor, mel, dct, acorr = _operators(48000, n_fft)
    wp = _frames(n, flen, n_fft + flen)
    nmel, nceps = dct.shape
    nac = acorr.shape[1]
    nb = n_fft // 2 + 1
    assert lib.srt_big_ranges(n, nb) > 1
    op = gpu_frontend._fft_operator(mel, acorr, n_fft, lib,
                                    "srt_big_operator_shape")
    sc = torch.empty(lib.srt_big_scratch_floats(n_fft, nmel + nac, n))

    def call():
        ceps, r = torch.empty(n, nceps), torch.empty(n, nac)
        assert lib.srt_big_fft_frames(
            wp.data_ptr(), op.data_ptr(), dct.data_ptr(), ceps.data_ptr(),
            r.data_ptr(), sc.data_ptr(), n, flen, n_fft, nmel, nac, nceps,
            floor, n, None) == 0
        return ceps, r
    got = call()
    if n_fft <= gpu_frontend.CLUSTER_MAX_N:
        again = call()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(f"{n_fft}", got, gpu_frontend.mfcc_from_frames_fft_reference(
        wp, mel, dct, floor, acorr, n_fft))


@pytest.mark.parametrize("fs,n_fft,M,n", [
    (8000, 16000, 16384, 3), (8000, 33000, 32768, 3),
    (8000, 261634, 262144, 2), (48000, 261000, 262144, 1)],
    ids=["16000_M16384", "33000_M32768", "261634_M262144_passes",
         "48k_261000_M262144_column_pass"])
def test_the_chirp_route_on_the_cluster(lib, fs, n_fft, M, n):
    """srt_chirp_cluster_frontend (on the cluster: the forward FFT, the
    pointwise product with the decimated Bh and the inverse in one buffer a
    rank; at M = 262144 the passes: the row pass with Bh as [M1][M2] and
    the second transform's rows, its values straight from a short frame
    (256 samples at 8 kHz) or from the column pass over a = x c (1536 at
    48 kHz), the column pass into power rows; then the fused projection)
    against mfcc_from_frames_chirp_reference on the same tables, n
    frames."""
    flen, floor, mel, dct, acorr = _operators(fs, n_fft)
    assert gpu_frontend.chirp_size(n_fft, flen) == M
    wp = _frames(max(n, 2), flen, n_fft)[:n].contiguous()
    nmel, nceps = dct.shape
    nac = acorr.shape[1]
    nb = n_fft // 2 + 1
    rows = -(-nb // 64) * 64  # the fused pass's chunk up to 72 outputs
    op = torch.zeros(rows, 72)
    op[:nb, :nmel + nac] = torch.cat([mel[:nb], acorr[:nb]], 1)
    cz, _ = gpu_frontend.chirp_tables(n_fft, flen)
    bh = gpu_frontend.chirp_cluster_bh(n_fft, flen)
    sc = torch.empty(lib.srt_chirp_scratch_floats(n_fft, flen, nmel + nac,
                                                  n))
    ceps, r = torch.empty(n, nceps), torch.empty(n, nac)
    assert lib.srt_chirp_cluster_frontend(
        wp.data_ptr(), cz.data_ptr(), bh.data_ptr(), op.data_ptr(),
        dct.data_ptr(), ceps.data_ptr(), r.data_ptr(), sc.data_ptr(), n,
        flen, n_fft, nmel, nac, nceps, floor, n, None) == 0
    _close(f"chirp {n_fft}", (ceps, r),
           gpu_frontend.mfcc_from_frames_chirp_reference(
               wp, mel, dct, floor, acorr, n_fft))


def _signal_batch(fs, L, lengths, seed):
    """[B, L] f32 signals of white noise at the given lengths (zeros past
    them), a silent stretch of 4 frames in the first, and [B] lengths."""
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = rng.randn(n) * 3000
    flen, shift = frame_geometry(fs, 32.0, 16.0)
    sig[0, shift:shift + 4 * flen] = 0.0
    return torch.from_numpy(sig), torch.tensor(lengths, dtype=torch.int32)


def _lpc_close(name, got, want, nceps, lpcc, silent=None):
    """Pre-CMVN cepstra of O(10-100) within 1e-3 (f32 FFTs in another
    order, ~1e-6 relative on the power), LPC within 1e-3, LPC cepstra
    within 1e-3 of their frame's largest; zeros where the plain version
    has them, except in the LPC columns of the frames of a [B, T] mask
    `silent`, which the tolerances alone hold."""
    got, want = got.numpy(), want.numpy()
    assert np.isfinite(got).all(), name
    same = (got == 0) == (want == 0)
    if silent is not None:
        same[silent.numpy(), nceps:] = True
    assert same.all(), name
    np.testing.assert_allclose(got[..., :nceps], want[..., :nceps], rtol=0,
                               atol=1e-3, err_msg=name)
    scale = (np.abs(want[..., nceps:]).max(axis=-1, keepdims=True)
             if lpcc else 1.0)
    assert (np.abs(got[..., nceps:] - want[..., nceps:])
            <= 1e-3 * scale).all(), name


@pytest.mark.parametrize("fs,fft_size,n_lpcc,n_filters", [
    (48000, 2048, 0, None), (48000, 2048, 16, None), (44100, 4096, 16, None),
    (96000, 2048, 0, None), (48000, 4096, 0, 600)],
    ids=["48k_lpc", "48k_lpcc", "44k_fft4096_lpcc", "96k_folded",
         "48k_fft4096_616_outputs"])
def test_the_full_spectrum_kernel_from_the_signals(lib, fs, fft_size,
                                                   n_lpcc, n_filters):
    """srt_full_signals_frontend (csrc/signal_tile.cuh: the loader's sample
    pairs on the signal, windowed and pre-emphasized per sample, the
    previous sample by a shuffle, at 44.1 kHz every other frame on the
    scalar pair path, a 96 kHz frame of 3072 samples folded onto 2048
    points; the per-bin floor; the power rows over the FFT buffers; the
    projection as 3 x TF32 mma.sync products from the packed block list,
    split over the warps and added in order, past 512 outputs (600 mel
    filters + LPC) in chunks to device rows; LPC or the LPC cepstra with
    their coefficients in registers; a tile past n_valid written as zeros)
    against
    mfcc_from_signals_reference with CMVN off, two calls bitwise: a long
    utterance with a silent stretch (its all-floor frames give LPC cepstra
    of 0), a short one and one with no valid frame."""
    mf = MfccConfig(fft_size=fft_size)
    if n_filters:
        mf = MfccConfig(fft_size=fft_size, n_filters=n_filters)
    cfg = FeatureConfig(mfcc=mf, lpc=LpcConfig(n_lpcc=n_lpcc))
    fe = FullFrontend(fs, cfg, "cpu")
    assert fe.signal_route
    L = 4096 * (-(-int(0.25 * fs) // 4096))
    sig, lens = _signal_batch(fs, L, [L, L // 3, fe.frame_len - 1], 31)
    T = n_frames(L, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(lens, T)
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    op = gpu_frontend.signal_operator(lib, fe.mel, fe.acorr, fft_size)
    w = n_lpcc - 1 if n_lpcc else nac - 1
    nw = lib.srt_fft_wide_floats(3 * T, nmel + nac)
    assert (nw > 0) == (nmel + nac > 512)
    wsums = torch.empty(nw) if nw else None

    def call():
        feat = torch.full((3, T, nceps + w), float("nan"))
        assert lib.srt_full_signals_frontend(
            sig.data_ptr(), nv.data_ptr(), fe.window.data_ptr(),
            op.data_ptr(), fe.dct.data_ptr(), feat.data_ptr(),
            wsums.data_ptr() if nw else None, 3, L, T,
            fe.frame_len, fe.frame_shift, fft_size, nmel, nac, nceps,
            fe.pre_emph, int(fe.preemph_first), fe.floor, 0, n_lpcc,
            None) == 0
        return feat
    got = call()
    assert torch.equal(got, call())
    want = gpu_frontend.mfcc_from_signals_reference(
        sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, False, n_lpcc)
    # on a frame of zeros (every power bin at the floor) the plain
    # version's odd lags cancel to exact zeros (f32 sums of subnormal
    # products, in bin order), which the kernel's 3 x TF32 sums do not
    # repeat bit for bit: its LPC is held to the tolerances there
    wp = framing.window_preemph(framing.frame_signal(sig, fe.frame_len,
                                                     fe.frame_shift),
                                fe.frame_len, fe.pre_emph, fe.preemph_first)
    silent = (wp == 0).all(-1) & (torch.arange(T)[None] < nv[:, None])
    _lpc_close(f"{fs} {fft_size} {n_lpcc}", got, want, nceps, n_lpcc > 0,
               silent)
    if n_lpcc:
        assert (got[0, 2:4, nceps:] == 0).all()


def _k1_lpcc(lib, fe, sig, nv, L, T, cmvn):
    """srt_lpcc_signals_frontend (K1's LPC-cepstra mode, n_lpcc = 16) on
    a [3, L] batch, its output written over NaN."""
    nmel, nceps = fe.dct.shape
    nac = fe.fft_acorr.shape[1]
    op = gpu_frontend.signal_operator(lib, fe.fft_mel, fe.fft_acorr, fe.n_fft)
    feat = torch.full((3, T, nceps + 15), float("nan"))
    assert lib.srt_lpcc_signals_frontend(
        sig.data_ptr(), nv.data_ptr(), fe.window.data_ptr(), op.data_ptr(),
        fe.dct.data_ptr(), feat.data_ptr(), None, 3, L, T, fe.frame_len,
        fe.frame_shift, fe.n_fft, nmel, nac, nceps, fe.pre_emph,
        int(fe.preemph_first), fe.floor, int(cmvn), 16, None) == 0
    return feat


def test_k1_lpcc_mode_on_the_tile(lib):
    """K1's LPC-cepstra mode (srt_lpcc_signals_frontend, n_lpcc = 16: the
    signal tile with the power unfloored, Levinson and the recursion on
    the unzeroed coefficients in its tail) at 8 kHz against
    packed_from_signals_fft_reference with CMVN off; the silent stretch's
    frames (r = 0) give 0."""
    fe = text.PackedFrontend(8000, FeatureConfig(lpc=LpcConfig(
        n_lpcc=16)), "cpu")
    L = 8192
    sig, lens = _signal_batch(8000, L, [L, 3000, 255], 37)
    T = n_frames(L, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(lens, T)
    nceps = fe.dct.shape[1]
    feat = _k1_lpcc(lib, fe, sig, nv, L, T, False)
    want = gpu_frontend.packed_from_signals_fft_reference(
        sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, False, True, 16)
    _lpc_close("K1 lpcc", feat, want, nceps, True)
    assert (feat[0, 2:8, nceps:] == 0).all()


@pytest.mark.parametrize("cmvn", [False, True], ids=["cmvn_off", "cmvn"])
@pytest.mark.parametrize("preemph_first", [False, True],
                         ids=["window_first", "preemph_first"])
@pytest.mark.parametrize("fs", [8000, 16000], ids=["n512", "n1024"])
def test_k1_lpcc_kernel_from_the_signals(lib, fs, preemph_first, cmvn):
    """csrc/frontend_lpcc_signals.cu at N = 512 (8 kHz) and 1024 (16 kHz),
    the pre-emphasis after the window or before it, CMVN off and on (its
    2-D blocks and static shared arrays in the stand-in), against
    packed_from_signals_fft_reference: a long utterance whose silent
    stretch gives LPC cepstra of 0, a short one, one with no valid frame
    (zeros), frames past n_valid zeros; two calls give the same bits."""
    cfg = FeatureConfig(mfcc=MfccConfig(preemph_first=preemph_first),
                        lpc=LpcConfig(n_lpcc=16))
    fe = text.PackedFrontend(fs, cfg, "cpu")
    assert fe.n_fft == {8000: 512, 16000: 1024}[fs]
    L = 8192 * fs // 8000
    sig, lens = _signal_batch(fs, L, [L, L // 3, fe.frame_len - 1], 41)
    T = n_frames(L, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(lens, T)
    assert int(nv[2]) == 0 and int(nv[1]) < T
    nceps = fe.dct.shape[1]
    got = _k1_lpcc(lib, fe, sig, nv, L, T, cmvn)
    assert torch.equal(got, _k1_lpcc(lib, fe, sig, nv, L, T, cmvn))
    want = gpu_frontend.packed_from_signals_fft_reference(
        sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, cmvn, True, 16)
    _lpc_close(f"K1 lpcc {fs} {preemph_first} {cmvn}", got, want, nceps,
               True)
    mask = torch.arange(T)[None] < nv[:, None]
    assert (got[~mask] == 0).all()
    wp = framing.window_preemph(framing.frame_signal(sig, fe.frame_len,
                                                     fe.frame_shift),
                                fe.frame_len, fe.pre_emph, fe.preemph_first)
    silent = (wp == 0).all(-1) & mask
    assert int(silent.sum()) >= 2
    assert (got[silent][:, nceps:] == 0).all()


@pytest.mark.parametrize("mfcc,lpc", [
    (MfccConfig(), LpcConfig(n_lpc=40, n_lpcc=41)),
    (MfccConfig(fft_size=4096, n_filters=600), LpcConfig(n_lpcc=16))],
    ids=["order40_tail", "616_outputs_chunked"])
def test_k1_lpcc_kernel_wide_shapes(lib, mfcc, lpc):
    """csrc/frontend_lpcc_signals.cu past the register tail and past one
    output chunk, at 8 kHz (N = 512) with CMVN on: LPC order 40 with 40
    LPC cepstra (the tail's local-array recursion, tile_features'
    lpcc_frames) and 600 mel filters at fft_size 4096 (616 outputs: the
    projection onto two chunks of 512 columns, the sums in device rows),
    against packed_from_signals_fft_reference."""
    fe = text.PackedFrontend(8000, FeatureConfig(mfcc=mfcc, lpc=lpc), "cpu")
    assert fe.n_fft == 512
    nmel, nceps = fe.dct.shape
    nac = fe.fft_acorr.shape[1]
    L = 8192
    sig, lens = _signal_batch(8000, L, [L, 3000, 255], 43)
    T = n_frames(L, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(lens, T)
    nw = lib.srt_fft_wide_floats(3 * T, nmel + nac)
    assert (nw > 0) == (nmel + nac > 512)
    wsums = torch.empty(nw) if nw else None
    op = gpu_frontend.signal_operator(lib, fe.fft_mel, fe.fft_acorr, fe.n_fft)
    feat = torch.full((3, T, nceps + lpc.n_lpcc - 1), float("nan"))
    assert lib.srt_lpcc_signals_frontend(
        sig.data_ptr(), nv.data_ptr(), fe.window.data_ptr(), op.data_ptr(),
        fe.dct.data_ptr(), feat.data_ptr(),
        wsums.data_ptr() if nw else None, 3, L, T, fe.frame_len,
        fe.frame_shift, fe.n_fft, nmel, nac, nceps, fe.pre_emph,
        int(fe.preemph_first), fe.floor, 1, lpc.n_lpcc, None) == 0
    want = gpu_frontend.packed_from_signals_fft_reference(
        sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, True, True,
        lpc.n_lpcc)
    _lpc_close(f"K1 lpcc {nmel} {nac}", feat, want, nceps, True)
    assert (feat[0, 2:8, nceps:] == 0).all()


def _lpc64(r):
    """Levinson in float64: a_1 .. a_p of r [p + 1]."""
    p = len(r) - 1
    a, e = np.zeros(p + 1), r[0]
    a[0] = 1.0
    for i in range(1, p + 1):
        k = -(r[i] + np.dot(a[1:i], r[1:i][::-1])) / e
        a[1:i] = a[1:i] + k * a[1:i][::-1]
        a[i] = k
        e *= 1.0 - k * k
    return a[1:]


@pytest.mark.parametrize("lg", [22, 23, 24])
def test_projection_sums_hold_at_the_four_step_reach(lib, lg):
    """The four-step route's projection (rfft::project_bins: one f32
    running sum an output over its bins in order) at N = 2^lg, modelled in
    numpy on a 48 kHz frame of a voice (1536 samples) zero-padded to N,
    against the float64 sums. A chunk of frames there is what BIG_SCRATCH_BYTES hold
    (the library's big_chunk: under 128 frames at 2^22, as few as ~30 at
    2^24), never the 1,017 frames from which the fused pass stops
    splitting, so the bins always split into ranges (srt_big_ranges: S =
    16-64 of ~131k bins) whose f32 partials are added in order: their
    autocorrelation and mel sums stay within 3e-4 of the sums' magnitudes
    and the LPC within the card's gate (1e-2, or 1e-3 relative) of the
    float64 sums' LPC. One running sum over all bins (S = 1), the other
    order, would part from them past that gate at 2^24; each 128-bin chunk
    in f32 and the chunks in float64 (csrc/frontend_frames.cu's order)
    would hold to 1e-7."""
    N = 1 << lg
    nb = N // 2 + 1
    nfc = gpu_frontend.big_chunk(lib, N, 26 + 16, 1 << 20)
    S = lib.srt_big_ranges(nfc, nb)
    assert nfc < 1017 and S > 1
    rb = -(-nb // S)
    rb = -(-rb // 512) * 512
    fs, flen, order = 48000, 1536, 15
    voice = synth.synth_utterance("alice", 0.1, lg, fs)[None, 1536:3072]
    x = framing.window_preemph(torch.from_numpy(voice.astype(np.float64)),
                               flen, 0.97)[0].numpy()
    p = np.maximum(np.abs(np.fft.rfft(x, n=N)) ** 2, 1e-35).astype(np.float32)
    k = np.arange(nb, dtype=np.float64)
    # the widest mel filter (the top one of 26 at 16384 points) stretched
    # over N's bins
    mel = operators.mel_filterbank(fs, 1 << 14, 26)
    top = np.interp(k * (1 << 14) / N, np.arange(mel.shape[1]), mel[-1])
    sums = {"exact": [], "split": [], "one": [], "chunks": []}
    for j in range(order + 2):
        if j <= order:
            w = 2 * np.cos(2 * np.pi * j * k / N) / (N * flen)
            w[0] /= 2
            w[-1] /= 2
        else:
            w = top
        t = p * w.astype(np.float32)
        mag = float(np.dot(p.astype(np.float64), np.abs(w)))
        exact = float(np.dot(p.astype(np.float64), w.astype(np.float32)))
        parts = np.array([np.cumsum(t[s:s + rb], dtype=np.float32)[-1]
                          for s in range(0, nb, rb)], np.float32)
        split = float(np.cumsum(parts, dtype=np.float32)[-1])
        one = float(np.cumsum(t, dtype=np.float32)[-1])
        ch = np.cumsum(np.pad(t, (0, -nb % 128)).reshape(-1, 128), axis=1,
                       dtype=np.float32)[:, -1]
        chunks = float(np.sum(ch.astype(np.float64)))
        assert abs(split - exact) <= 3e-4 * mag
        assert abs(chunks - exact) <= 1e-7 * mag
        for name, v in (("exact", exact), ("split", split), ("one", one),
                        ("chunks", chunks)):
            sums[name].append(v)
    ex = _lpc64(np.array(sums["exact"][:-1]))
    gate = np.maximum(1e-2, 1e-3 * np.abs(ex))
    assert (np.abs(_lpc64(np.array(sums["split"][:-1])) - ex) <= gate).all()
    if lg == 24:
        assert (np.abs(_lpc64(np.array(sums["one"][:-1])) - ex) > gate).any()


def _k2_case(S, K, d, n_valid, T, seed):
    """A bank of S x K (the chip's random_bank: Dirichlet weights, Gaussian
    means, sigmas in [0.5, 1.5]), [B, T, d] Gaussian features with
    n_valid[b] valid frames and, in the first utterance, one frame far from
    every mean (its logsumexp under the -745 floor)."""
    rng = np.random.RandomState(seed)
    bank = GmmBank.from_numpy(
        rng.dirichlet(np.ones(K), size=S).astype(np.float32),
        rng.randn(S, K, d).astype(np.float32),
        (0.5 + rng.rand(S, K, d)).astype(np.float32), "cpu")
    x = rng.randn(len(n_valid), T, d).astype(np.float32)
    x[0, 3] = 60.0
    mask = np.arange(T)[None] < np.asarray(n_valid)[:, None]
    return bank, torch.from_numpy(x), torch.from_numpy(mask)


def _k2_call(lib, bank, x, mask):
    """srt_bank_avg_loglik on the bank as the route of d reads it, the
    output and scratch written over NaN."""
    B, T, d = x.shape
    S, K = bank.n_speakers, bank.n_mixtures
    row = lib.srt_bank_tensor_row(d)
    comp = (bank.tf32_operator(row, -(-K // 8) * 8) if row > 0
            else bank.component_operator(2 * (-(-d // 4) * 4) + 4))
    nw = max(1, -(-T // lib.srt_bank_warp_frames(d)))
    buf = torch.full((B * S + B * nw * (S + 1),), float("nan"))
    assert lib.srt_bank_avg_loglik(
        x.data_ptr(), mask.data_ptr(), comp.data_ptr(),
        buf.data_ptr() + 4 * B * S, buf.data_ptr(), B, T, d, S, K, 0,
        None) == 0
    return buf[:B * S].view(B, S).clone()


def test_k2_routes_by_depth(lib):
    """The tensor route takes 2d <= 256 (gpu_gmm.TENSOR_MAX_DIM), its
    k-steps of 8 padded with zero terms to an instance's depth (5, 10, 20,
    then multiples of 2), two m16 tiles (32 frames) a warp up to 2d = 80
    and one (16 frames) beyond; the wide route takes the rest, 32 frames a
    warp."""
    for d in range(1, 200):
        row = lib.srt_bank_tensor_row(d)
        assert (row > 0) == (d <= gpu_gmm.TENSOR_MAX_DIM), d
        if row > 0:
            ks = -(-2 * d // 8)
            padded = next((n for n in (5, 10, 20) if ks <= n),
                          -(-ks // 2) * 2)
            assert row == 128 * padded + 8
        assert lib.srt_bank_warp_frames(d) == (16 if 40 < d <= 128 else 32)
    assert lib.srt_bank_tensor_row(0) == -1


@pytest.mark.parametrize("S,K,d,n_valid,T", [
    (5, 32, 38, [70, 33, 0], 70), (1, 5, 38, [40, 17], 40),
    (3, 40, 38, [40, 17], 40), (3, 32, 28, [40, 9], 40),
    (2, 32, 80, [40, 17], 40), (2, 32, 100, [40, 17], 40),
    (2, 8, 128, [40, 17], 40), (2, 8, 132, [40, 17], 40)],
    ids=["ragged_padded_tiles_groups", "one_speaker_k5", "k40_groups",
         "d28", "deepest_in_registers", "chunked", "largest_depth", "wide"])
def test_k2_on_the_standin(lib, S, K, d, n_valid, T):
    """srt_bank_avg_loglik against batch_bank_avg_loglik_reference: a ragged
    batch with wholly padded warp tiles (a block whose one live tile's
    speakers its 4 warps share) and an utterance with no valid frame (0),
    T not a multiple of a warp's frames, S not a multiple of
    the speaker group (the stand-in's 4 SMs split 5 speakers 3 + 2 over
    grid.z), one speaker, K = 5 padded to 8 with PAD_CW, K = 40 (a
    speaker's 5 n8 tiles: a group of 4, then one tile, the logsumexp
    carried between them), d = 38 (the cells'), d = 28, the deepest d whose
    fragments stay in registers (80, one m16 tile a warp), d = 100 (25
    k-steps in chunks of 8: a partial last chunk), the route's largest d
    (128) and d = 132 on the wide route; the far frame at the floor; two
    calls bitwise."""
    bank, x, mask = _k2_case(S, K, d, n_valid, T, S * 100 + K + d)
    got = _k2_call(lib, bank, x, mask)
    assert torch.equal(got, _k2_call(lib, bank, x, mask))
    want = gpu_gmm.batch_bank_avg_loglik_reference(bank, x, mask)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (got[torch.tensor(n_valid) == 0] == 0).all()


def _chip_smoke_constant(name):
    """A constant of chip_smoke.py (the card's gates)."""
    path = os.path.join(os.path.dirname(STANDIN), os.pardir, "chip_smoke.py")
    with open(path) as f:
        return float(re.search(rf"^{name} = (\S+)$", f.read(), re.M)[1])


@pytest.mark.parametrize("d", [38, 128])
def test_k2_tensor_route_holds_float64(lib, d):
    """The tensor route on the stand-in's model of the tensor cores' adder
    (each mma.sync's terms aligned to the largest and cut toward zero,
    which the card does) against the float64 averages of the same f32
    operands, within chip_smoke.py's TENSOR_F64_ATOL: at the cells' d = 38
    and at the route's largest d, where sums carried across 32 k-steps in
    the accumulators would err ~1e-3 (csrc/tf32_mma.cuh)."""
    bank, x, mask = _k2_case(2, 8, d, [48, 31], 48, 11 + d)
    got = _k2_call(lib, bank, x, mask).double()
    x64, m = x.double(), mask.double()
    B, T, _ = x.shape
    lp = (torch.cat([x64 * x64, x64], -1) @ bank.op.double()
          + bank.cw.double()).reshape(B, T, 2, 8)
    lse = torch.logsumexp(lp, -1)
    lse = torch.where(lse > -745.0, lse, torch.full_like(lse, np.log(1e-15)))
    exact = torch.einsum("bts,bt->bs", lse, m) / m.sum(-1)[:, None]
    err = (got - exact).abs().max().item()
    print(f"d = {d}: the tensor route against float64 {err:.2e}")
    assert err <= _chip_smoke_constant("TENSOR_F64_ATOL")


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports the card, to reach a wrapper's kernel
    branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _K2Lib:
    """The stand-in library's batched scoring for ops/gpu_gmm, the entry
    points it lacks (the serial and bf16 kernels' layouts and launches)
    recorded instead of run."""

    def __init__(self, lib):
        self.lib, self.recorded = lib, []
        self.srt_bank_avg_loglik = lib.srt_bank_avg_loglik
        self.srt_bank_tensor_row = lib.srt_bank_tensor_row
        self.srt_bank_warp_frames = lib.srt_bank_warp_frames

    def __getattr__(self, name):
        if name.endswith("_loglik") or name.endswith("_loglik_bf16"):
            return lambda *a: self.recorded.append(name) or 0
        raise AttributeError(name)

    @staticmethod
    def srt_component_row(d):
        return 2 * (-(-d // 4) * 4) + 4

    @staticmethod
    def srt_mma_row(d):
        return 2 * ((2 * d + 15) // 16 * 16 // 2 + 4)

    @staticmethod
    def srt_mma_components(K):
        return -(-K // 8) * 8

    @staticmethod
    def srt_bank_bf16_warp_frames():
        return 32


def test_k2_route_counter(lib, monkeypatch):
    """TENSOR_LAUNCHES moves on every batched f32 call whose depth the
    tensor route takes (batch_bank_avg_loglik, and batch_scores, the
    serving path's call), beside LAUNCHES, and not on the wide route; the
    serial kernel's, the bf16 kernels' and the fused monolith's counters
    do not move, and those calls leave TENSOR_LAUNCHES alone. The wrapper
    runs the stand-in's kernel on the tensor route's operator, which it
    packs once per bank (GmmBank.tf32_operator)."""
    from speaker_recognition_tpu_torch.ops import gpu_predict
    fake = _K2Lib(lib)
    monkeypatch.setattr(_build, "load", lambda: fake)
    monkeypatch.setattr(gpu_gmm, "_stream", lambda plan: 0)
    for name in ("empty", "zeros"):  # the allocations on plan.device
        monkeypatch.setattr(torch, name, functools.partial(
            lambda f, *a, device=None, **k: f(*a, **k), getattr(torch, name)))

    def cuda(bank, x, mask):
        return (GmmBank(bank.op.as_subclass(_CudaTyped),
                        bank.cw.as_subclass(_CudaTyped), bank.n_speakers,
                        bank.n_mixtures),
                x.as_subclass(_CudaTyped), mask.as_subclass(_CudaTyped))

    names = ("LAUNCHES", "TENSOR_LAUNCHES", "BF16_LAUNCHES",
             "SERIAL_LAUNCHES", "SERIAL_BF16_LAUNCHES")
    fused = ("LAUNCHES", "WIDE_LAUNCHES", "BF16_LAUNCHES")

    def moved(fn):
        before = [getattr(gpu_gmm, n) for n in names]
        before_fused = [getattr(gpu_predict, n) for n in fused]
        out = fn()
        assert [getattr(gpu_predict, n) for n in fused] == before_fused
        return out, {n: getattr(gpu_gmm, n) - b
                     for n, b in zip(names, before)
                     if getattr(gpu_gmm, n) != b}

    plain = _k2_case(3, 32, 38, [40, 17], 40, 7)
    bank, x, mask = cuda(*plain)
    want = gpu_gmm.batch_bank_avg_loglik_reference(*plain)
    for fn in (gpu_gmm.batch_bank_avg_loglik, gpu_gmm.batch_scores):
        got, counts = moved(lambda: fn(bank, x, mask))
        assert counts == {"LAUNCHES": 1, "TENSOR_LAUNCHES": 1}
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    op = bank.scoring_plan(gpu_gmm._make_plan).tensor
    assert op.shape == (3, 4, 128 * 10 + 8)
    moved(lambda: gpu_gmm.batch_bank_avg_loglik(bank, x, mask))
    assert bank.scoring_plan(gpu_gmm._make_plan).tensor is op  # cached
    wide = _k2_case(2, 8, 132, [40, 17], 40, 8)
    got, counts = moved(lambda: gpu_gmm.batch_bank_avg_loglik(
        *cuda(*wide)))
    assert counts == {"LAUNCHES": 1}
    np.testing.assert_allclose(
        got.numpy(), gpu_gmm.batch_bank_avg_loglik_reference(*wide).numpy(),
        rtol=1e-5, atol=1e-5)
    _, counts = moved(lambda: gpu_gmm.batch_bank_avg_loglik(
        bank, x, mask, precision="bf16"))
    assert counts == {"BF16_LAUNCHES": 1}
    x1, m1 = x[0].as_subclass(_CudaTyped), mask[0].as_subclass(_CudaTyped)
    _, counts = moved(lambda: gpu_gmm.bank_avg_loglik(bank, x1, m1))
    assert counts == {"SERIAL_LAUNCHES": 1}
    _, counts = moved(lambda: gpu_gmm.bank_sum_loglik(bank, x1, m1,
                                                      precision="bf16"))
    assert counts == {"SERIAL_BF16_LAUNCHES": 1}
    assert fake.recorded == ["srt_bank_avg_loglik_bf16",
                             "srt_bank_sum_loglik",
                             "srt_bank_sum_loglik_bf16"]
