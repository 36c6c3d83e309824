"""Build and load the package's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface, loaded
with ctypes. The library lands in `_build/` beside this file, named by a
hash of the sources, the headers they share (csrc/*.cuh) and the flags, so
an unchanged checkout builds once and a changed source or header
rebuilds. A missing nvcc or a failed build raises: there is
no other path to the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# No --use_fast_math: it may fold isfinite() away and swaps logf for
# __logf; the frontends rely on both (see csrc/frontend*.cu).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# seconds the last load() spent compiling (0.0 when the cached library was
# reused), and the path of nvcc's log for that build
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of speaker_recognition_tpu_torch cannot be built")
    return found


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    ll = ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.srt_packed_frontend.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, i, i, i, f, i, f, i, i, p]
    lib.srt_packed_frontend.restype = i
    lib.srt_lpcc_signals_frontend.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                              i, i, i, i, i, i, f, i, f, i,
                                              i, p]
    lib.srt_lpcc_signals_frontend.restype = i
    lib.srt_lpcc_signals_occupancy.argtypes = [i, i, ip]
    lib.srt_lpcc_signals_occupancy.restype = i
    lib.srt_big_packed_frontend.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, i, i, i, f, i, f, i, i,
                                            i, p, i, p]
    lib.srt_big_packed_frontend.restype = i
    lib.srt_full_signals_frontend.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                              i, i, i, i, i, i, f, i, f, i,
                                              i, p]
    lib.srt_full_signals_frontend.restype = i
    lib.srt_full_signals_operator_shape.argtypes = [i, i, ip, ip, ip, ip]
    lib.srt_full_signals_operator_shape.restype = i
    lib.srt_full_signals_occupancy.argtypes = [i, i, ip]
    lib.srt_full_signals_occupancy.restype = i
    lib.srt_fft_operator_shape.argtypes = [i, i, ip, ip, ip]
    lib.srt_fft_operator_shape.restype = i
    lib.srt_fft_wide_floats.argtypes = [ll, i]
    lib.srt_fft_wide_floats.restype = ll
    lib.srt_big_scratch_floats.argtypes = [i, i, i]
    lib.srt_big_scratch_floats.restype = ll
    lib.srt_big_operator_shape.argtypes = [i, i, ip, ip, ip]
    lib.srt_big_operator_shape.restype = i
    lib.srt_big_ranges.argtypes = [i, i]
    lib.srt_big_ranges.restype = i
    lib.srt_chirp_operator_shape.argtypes = [i, i, i, ip, ip, ip]
    lib.srt_chirp_operator_shape.restype = i
    lib.srt_chirp_frames_frontend.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                              i, i, i, i, f, p]
    lib.srt_chirp_frames_frontend.restype = i
    lib.srt_chirp_cluster_frontend.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                               i, i, i, i, f, i, p]
    lib.srt_chirp_cluster_frontend.restype = i
    lib.srt_chirp_scratch_floats.argtypes = [i, i, i, i]
    lib.srt_chirp_scratch_floats.restype = ll
    lib.srt_fft_frames_frontend.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            i, f, p]
    lib.srt_fft_frames_frontend.restype = i
    lib.srt_big_fft_frames.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       f, i, p]
    lib.srt_big_fft_frames.restype = i
    lib.srt_fft_packed_frames.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                          i, f, i, f, p]
    lib.srt_fft_packed_frames.restype = i
    lib.srt_big_packed_frames.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, f, i, f, i, p]
    lib.srt_big_packed_frames.restype = i
    lib.srt_frames_frontend.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                        i, i, i, f, p]
    lib.srt_frames_frontend.restype = i
    lib.srt_frames_scratch_floats.argtypes = [i, i]
    lib.srt_frames_scratch_floats.restype = ll
    lib.srt_bank_avg_loglik.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.srt_bank_avg_loglik.restype = i
    lib.srt_bank_warp_frames.argtypes = [i]
    lib.srt_bank_warp_frames.restype = i
    lib.srt_bank_tensor_row.argtypes = [i]
    lib.srt_bank_tensor_row.restype = i
    lib.srt_bank_sum_loglik.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.srt_bank_sum_loglik.restype = i
    lib.srt_component_row.argtypes = [i]
    lib.srt_component_row.restype = i
    lib.srt_bank_avg_loglik_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                             i, p]
    lib.srt_bank_avg_loglik_bf16.restype = i
    lib.srt_bank_sum_loglik_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.srt_bank_sum_loglik_bf16.restype = i
    lib.srt_bank_bf16_warp_frames.argtypes = []
    lib.srt_bank_bf16_warp_frames.restype = i
    lib.srt_mma_row.argtypes = [i]
    lib.srt_mma_row.restype = i
    lib.srt_mma_components.argtypes = [i]
    lib.srt_mma_components.restype = i
    lib.srt_frontend_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                      i, i, i, i, f, i, i, p]
    lib.srt_frontend_bf16.restype = i
    lib.srt_frames_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f,
                                    p]
    lib.srt_frames_bf16.restype = i
    lib.srt_frontend_bf16_wide_floats.argtypes = [ll, i]
    lib.srt_frontend_bf16_wide_floats.restype = ll
    lib.srt_frontend_bf16_occupancy.argtypes = [i, i, i, ip]
    lib.srt_frontend_bf16_occupancy.restype = i
    lib.srt_bank_bf16_occupancy.argtypes = [i, i, i, i, i, ip]
    lib.srt_bank_bf16_occupancy.restype = i
    lib.srt_fused_predict.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i,
                                      i, i, i, i, i, i, i, i, i, i, i, f, i,
                                      f, i, i, p]
    lib.srt_fused_predict.restype = i
    lib.srt_fused_predict_big.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                          i, i, i, i, i, i, i, i, i, f, i, f,
                                          i, i, p]
    lib.srt_fused_predict_big.restype = i
    lib.srt_fused_component_row.argtypes = [i]
    lib.srt_fused_component_row.restype = i
    lib.srt_fused_bf16_wide_floats.argtypes = [i, i, i]
    lib.srt_fused_bf16_wide_floats.restype = ll
    lib.srt_fused_bf16_tile.argtypes = [i, i, i, i, ip]
    lib.srt_fused_bf16_tile.restype = i
    lib.srt_fused_scratch_floats.argtypes = [i, i, i, i]
    lib.srt_fused_scratch_floats.restype = ll
    lib.srt_error_string.argtypes = [i]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The kernels' ctypes library, compiled on the first call."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + b"\0" + f.read())
        name = f"libsrt_kernels_{h.hexdigest()[:16]}.so"
        path = os.path.join(BUILD_DIR, name)
        build_log = path[:-3] + ".log"
        build_seconds = 0.0
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                log = _compile_and_link(srcs, tmp, os.path.join(tmp, name))
                build_seconds = time.perf_counter() - t0
                with open(build_log, "w") as f:
                    f.write(log)
                # atomic: concurrent builds agree
                os.replace(os.path.join(tmp, name), path)
        _lib = _bind(ctypes.CDLL(path))
        return _lib


def _compile_and_link(srcs: list[str], tmp: str, out: str) -> str:
    """nvcc -c for every source at once, then one link into `out`; returns
    nvcc's combined output (ptxas -v lines included) or raises."""
    nvcc = _nvcc()
    objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    outs, secs = [""] * len(procs), [0.0] * len(procs)

    def drain(i):  # each pipe read as it fills, each source timed alone
        outs[i] = procs[i].communicate()[0]
        secs[i] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(i,))
               for i in range(len(procs))]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    log = "".join(f"== {s} ({t:.1f} s)\n{o}"
                  for s, o, t in zip(srcs, outs, secs))
    failed = [(s, p.returncode, o) for s, p, o in zip(srcs, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{s} ({rc}):\n{o[-4000:]}" for s, rc, o in failed))
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr[-4000:]}")
    return log


def check_tensor(t, name: str, dtype, ndim: int, device):
    """Raise unless `t` is a contiguous `ndim`-D `dtype` tensor on
    `device`: what a kernel's raw pointer assumes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(err: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().srt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
