"""The cluster FFT's CUDA sources run on the CPU: csrc/rfft_cluster.cu,
frontend_big.cu and frontend_chirp_cluster.cu compiled with g++ against the
stand-in CUDA runtime of tests/cuda_standin/ (each thread of a block an OS
thread, __syncthreads and cluster.sync() barriers, another rank's shared
memory at the same offset in its buffer), called through their C entry
points on CPU tensors and held to the port's plain versions: K5 on the
four-step route at N = 32768 (one block; also a frame longer than N,
folded) and 65536 (a cluster of 2), and on the chirp-z route past M = 8192
at fft_size 16000 (M = 16384) and 33000 (M = 32768, a cluster of 2). It
checks the kernels' index maps, barriers and exchanges as the source
states them; what nvcc or the card make of them shows only on the card
(chip_smoke.py phases 15 and 16). Skips without g++."""

import ctypes
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
    FeatureConfig, MfccConfig)
from speaker_recognition_tpu_torch.features.extract import (  # noqa: E402
    FullFrontend)
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402

STANDIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_standin")
SOURCES = ("rfft_cluster.cu", "frontend_big.cu", "frontend_chirp_cluster.cu")


def _rewrite(src: str) -> str:
    """The CUDA syntax the stand-in cannot define: extern __shared__ arrays
    (the block's buffer), <<<...>>> launches (cusim::launch) and the
    built-in index variables (cusim::ctx)."""
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)cusim::ctx.block->smem.data();", src)
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
    return lib


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


@pytest.mark.parametrize("n_fft,flen", [(32768, 1536), (32768, 40000),
                                        (65536, 1536)],
                         ids=["32768_one_block", "32768_folded",
                              "65536_two_ranks"])
def test_the_four_step_route_on_the_cluster(lib, n_fft, flen):
    """srt_big_fft_frames (the spectrum kernel on a block or a cluster of
    2, then the fused projection pass on its power rows) against
    mfcc_from_frames_fft_reference, 48 kHz operators, 3 frames; two calls
    give the same bits."""
    fe = FullFrontend(48000, FeatureConfig(mfcc=MfccConfig(fft_size=n_fft)),
                      "cpu")
    wp = _frames(3, flen, n_fft + flen)
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    op = gpu_frontend._fft_operator(fe.mel, fe.acorr, n_fft, lib,
                                    "srt_big_operator_shape")
    sc = torch.empty(lib.srt_big_scratch_floats(n_fft, nmel + nac, 3))

    def call():
        ceps, r = torch.empty(3, nceps), torch.empty(3, nac)
        assert lib.srt_big_fft_frames(
            wp.data_ptr(), op.data_ptr(), fe.dct.data_ptr(), ceps.data_ptr(),
            r.data_ptr(), sc.data_ptr(), 3, flen, n_fft, nmel, nac, nceps,
            fe.floor, 3, None) == 0
        return ceps, r
    got = call()
    again = call()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(f"{n_fft}", got, gpu_frontend.mfcc_from_frames_fft_reference(
        wp, fe.mel, fe.dct, fe.floor, fe.acorr, n_fft))


@pytest.mark.parametrize("n_fft,M", [(16000, 16384), (33000, 32768)],
                         ids=["16000_M16384", "33000_M32768"])
def test_the_chirp_route_on_the_cluster(lib, n_fft, M):
    """srt_chirp_cluster_frontend (the forward FFT, the pointwise product
    with the decimated Bh and the inverse in one buffer a rank, the power
    rows, the fused projection) against mfcc_from_frames_chirp_reference
    on the same tables, 8 kHz operators, 3 frames."""
    fe = FullFrontend(8000, FeatureConfig(mfcc=MfccConfig(fft_size=n_fft)),
                      "cpu")
    flen = fe.frame_len
    assert gpu_frontend.chirp_size(n_fft, flen) == M
    wp = _frames(3, flen, n_fft)
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    nb = n_fft // 2 + 1
    rows = -(-nb // 64) * 64  # the fused pass's chunk up to 72 outputs
    op = torch.zeros(rows, 72)
    op[:nb, :nmel + nac] = torch.cat([fe.mel[:nb], fe.acorr[:nb]], 1)
    cz, _ = gpu_frontend.chirp_tables(n_fft, flen)
    bh = gpu_frontend.chirp_cluster_bh(n_fft, flen)
    sc = torch.empty(lib.srt_chirp_scratch_floats(n_fft, flen, nmel + nac,
                                                  3))
    ceps, r = torch.empty(3, nceps), torch.empty(3, nac)
    assert lib.srt_chirp_cluster_frontend(
        wp.data_ptr(), cz.data_ptr(), bh.data_ptr(), op.data_ptr(),
        fe.dct.data_ptr(), ceps.data_ptr(), r.data_ptr(), sc.data_ptr(), 3,
        flen, n_fft, nmel, nac, nceps, fe.floor, 3, None) == 0
    _close(f"chirp {n_fft}", (ceps, r),
           gpu_frontend.mfcc_from_frames_chirp_reference(
               wp, fe.mel, fe.dct, fe.floor, fe.acorr, n_fft))
