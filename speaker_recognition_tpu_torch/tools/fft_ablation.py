"""Where the FFT frontend kernels spend their time, on the card.

    python -m speaker_recognition_tpu_torch.tools.fft_ablation

Builds csrc/frontend_fft.cu (K5) and csrc/frontend.cu (K1) once as they
are and once for each variant below, which switches one stage of the FFT
tile (csrc/rfft_tile.cuh) off in a copy of the sources, and times K5 at
48 kHz (512 x 5 s) and K1 at 8 kHz (512 x 5 s) for each, in turns, two
rounds. The outputs of a variant are wrong by construction; only its time
counts. The difference to `full` is what the stage costs. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from .. import _build
from ..config import FeatureConfig, n_frames
from ..features.extract import FullFrontend, PackedFrontend
from ..ops import framing, gpu_frontend

# variant -> [(text of csrc/rfft_tile.cuh, its replacement)], or
# [(file, text, replacement)] for another source
VARIANTS = {
    "full": [],
    "no_gather": [
        ("      v[q] = make_float2(load(f, p), load(f, p + 1));",
         "      v[q] = make_float2((float)p, 1.f);")],
    "no_butterflies": [
        ("  for (int s = 0; s < NS; ++s) {", "  for (int s = 0; s < 0; ++s) {"),
        ("  for (int s2 = 0; s2 < 5; ++s2) {",
         "  for (int s2 = 0; s2 < 0; ++s2) {"),
        ("      for (int t = 0; t < 32; ++t) butterfly(",
         "      for (int t = 0; t < 0; ++t) butterfly("),
        ("      for (int s = P; s + 1 < LG; s += 2) {  // stages s and s + 1",
         "      for (int s = LG; s + 1 < LG; s += 2) {"),
        ("      if ((LG - P) % 2) {  // the last stage alone",
         "      if (false) {")],
    "no_post_step": [
        ("      const int k = lane + 32 * q;\n      if (k > H) break;\n      float p;",
         "      const int k = lane + 32 * q;\n      if (k >= 0) break;\n      float p;")],
    "no_projection_fma": [
        ("#pragma unroll 4\n      for (int kk = 0; kk < kw; ++kk) {",
         "#pragma unroll 4\n      for (int kk = 0; kk < 0; ++kk) {")],
    "no_projection": [
        ("  for (int k0 = 0; k0 < NB; k0 += CK) {",
         "  for (int k0 = 0; k0 < 0; k0 += CK) {")],
    # K1's tail (csrc/packed_tile.cuh tile_features): the Levinson
    # recursion, then the DCT as well
    "no_levinson": [("packed_tile.cuh", "  if (order == 0) return;",
                     "  return;")],
    "no_levinson_dct": [
        ("packed_tile.cuh", "  if (order == 0) return;", "  return;"),
        ("packed_tile.cuh", "  for (int i = tid; i < nf * nceps; i += NTH) {",
         "  for (int i = tid; i < 0; i += NTH) {")],
}
SOURCES = ("rfft_tile.cuh", "rfft_big.cuh", "packed_tile.cuh",
           "big_signal.cuh", "frontend_fft.cu", "frontend.cu")


def bind(lib) -> None:
    """The argument types of K5's and K1's C interfaces."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srt_fft_frames_frontend.argtypes = [p_] * 6 + [i_] * 6 + [f_, p_]
    lib.srt_packed_frontend.argtypes = ([p_] * 7 + [i_] * 9
                                        + [f_, i_, f_, i_, i_, p_])


def build(tmp: str, variants=VARIANTS, sources=SOURCES,
          entries=("frontend_fft.cu", "frontend.cu"), bind=bind) -> dict:
    """One library per variant of `variants` over copies of `sources`
    (each edit a (text of csrc/rfft_tile.cuh, replacement) or a (file,
    text, replacement)), built from the `entries` files, all nvcc processes
    at once; bind(lib) sets each library's argument types."""
    nvcc = _build._nvcc()
    procs = {}
    for name, edits in variants.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in sources:
            shutil.copy(os.path.join(_build.CSRC, f), d)
        for edit in edits:
            fname, old, new = (edit if len(edit) == 3
                               else ("rfft_tile.cuh", *edit))
            path = os.path.join(d, fname)
            with open(path) as f:
                src = f.read()
            if old not in src:
                raise SystemExit(f"{name}: csrc/{fname} no longer has "
                                 f"{old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS[:-2], "-shared", "-o",
             os.path.join(d, "lib.so"),
             *(os.path.join(d, e) for e in entries)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(os.path.join(tmp, name, "lib.so"))
        bind(libs[name])
    return libs


def time_ms(fn, trials=7, reps=3) -> float:
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fft_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    fe48 = FullFrontend(48000, FeatureConfig(), dev)
    x = np.zeros((512, 245760), np.float32)
    x[:, :240000] = rng.randn(512, 240000) * 3000
    sig48 = torch.from_numpy(x).to(dev)
    wp = framing.window_preemph(
        framing.frame_signal(sig48, fe48.frame_len, fe48.frame_shift),
        fe48.frame_len, fe48.pre_emph).reshape(-1, fe48.frame_len).contiguous()
    del sig48
    n = wp.shape[0]
    nmel, nceps = fe48.dct.shape
    nac = fe48.acorr.shape[1]
    ceps = torch.empty(n, nceps, device=dev)
    r = torch.empty(n, nac, device=dev)
    op48 = gpu_frontend._packed_operator(_build.load(), fe48.mel, fe48.acorr,
                                         fe48.n_fft)

    fe8 = PackedFrontend(8000, FeatureConfig(), dev)
    x8 = np.zeros((512, 40960), np.float32)
    x8[:, :40000] = rng.randn(512, 40000) * 3000
    s8 = torch.from_numpy(x8).to(dev)
    T8 = n_frames(40960, fe8.frame_len, fe8.frame_shift)
    nv = fe8.valid_frames(torch.full((512,), 40000, device=dev), T8)
    fft = fe8.fft
    op8 = gpu_frontend._packed_operator(_build.load(), fft.mel, fft.acorr,
                                        fft.n_fft)
    nac8 = fft.acorr.shape[1]
    feat = torch.empty(512, T8, nceps + nac8 - 1, device=dev)

    def k5(lib):
        err = lib.srt_fft_frames_frontend(
            wp.data_ptr(), op48.data_ptr(), fe48.dct.data_ptr(),
            ceps.data_ptr(), r.data_ptr(), 0, n, fe48.frame_len, fe48.n_fft,
            nmel, nac, nceps, fe48.floor, stream)
        assert err == 0, err

    def k1(lib, cmvn=1):
        err = lib.srt_packed_frontend(
            s8.data_ptr(), nv.data_ptr(), fft.window.data_ptr(),
            op8.data_ptr(), fe8.dct.data_ptr(), feat.data_ptr(), 0, 512, 40960,
            T8, fe8.frame_len, fe8.frame_shift, fft.n_fft, nmel, nac8, nceps,
            fft.pre_emph, int(fft.preemph_first), fe8.floor, cmvn, 1, stream)
        assert err == 0, err

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp)
        print(f"fft_ablation [{card}]: K5 512 x 5 s @ 48 kHz, K1 512 x 5 s "
              "@ 8 kHz, median of 7 trials of 3 calls", flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                print(f"round {rnd} {name:18s} K5 {time_ms(lambda: k5(lib)):.3f}"
                      f" ms  K1 {time_ms(lambda: k1(lib)):.3f} ms", flush=True)
            print(f"round {rnd} full, K1 without its CMVN kernel "
                  f"{time_ms(lambda: k1(libs['full'], 0)):.3f} ms",
                  flush=True)


if __name__ == "__main__":
    main()
