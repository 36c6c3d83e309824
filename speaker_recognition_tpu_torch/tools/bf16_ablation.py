"""Where K1's bf16 mode spends its time, on the card.

    python -m speaker_recognition_tpu_torch.tools.bf16_ablation

Builds csrc/frontend_bf16.cu once as it is and once for each variant
below, which switches one stage of the dense bf16 tile
(csrc/packed_tile.cuh) off in a copy of the sources, and times K1 bf16 at
8 kHz (512 x 5 s, the bench batch) for each, in turns, two rounds. The
outputs of a variant are wrong by construction; only its time counts.
The difference to `full` is what the stage costs. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from .. import _build
from ..config import FeatureConfig, n_frames
from ..features.extract import PackedFrontend
from ..ops import gpu_frontend
from . import fft_ablation
from .fft_ablation import time_ms

# variant -> [(file, text, its replacement)]; each text must be there
VARIANTS = {
    "full": [],
    # stage 1: the MMAs (the operands are still loaded)
    "no_mma": [("packed_tile.cuh",
                "            dft_mma(c0, a, bw.x, bw.y);\n"
                "            dft_mma(c1, a, bw.z, bw.w);",
                "            c0[0] = __uint_as_float(a[0] ^ bw.x);\n"
                "            c1[0] = __uint_as_float(a[1] ^ bw.z);")],
    # stage 2: the FMAs onto W | A
    "no_stage2": [("packed_tile.cuh",
                   "      for (int cc = 0; cc < (fma_on ? cw : 0); ++cc) {",
                   "      for (int cc = 0; cc < 0; ++cc) {")],
    # the copies of W | A and of D into shared memory
    "no_wa_copies": [("packed_tile.cuh",
                      "        if (kp == 0) fetch_wa(oc, c);", "")],
    "no_d_copies": [("packed_tile.cuh",
                     "    for (int i = tid; i < n; i += NT)\n"
                     "      __pipeline_memcpy_async(dst + i, src + i, 16);",
                     "    for (int i = tid; i < 0; i += NT)\n"
                     "      __pipeline_memcpy_async(dst + i, src + i, 16);")],
    # the staging of the tile's samples as bf16
    "no_staging": [("packed_tile.cuh",
                    "    for (int i = tid; i < n; i += NT) {\n"
                    "      seg[r * RS + c]",
                    "    for (int i = tid; i < 0; i += NT) {\n"
                    "      seg[r * RS + c]")],
    # the tail: log-mel . DCT, Levinson and the feature rows
    "no_features": [("frontend_bf16.cu",
                     "  if (OPL == 16 && nchunk > 1)\n"
                     "    tile_features<OPL>(wrows",
                     "  if (sums != nullptr) return;\n"
                     "  if (OPL == 16 && nchunk > 1)\n"
                     "    tile_features<OPL>(wrows")],
}
SOURCES = ("packed_tile.cuh", "frontend_bf16.cu")


def bind(lib) -> None:
    """The argument types of K1 bf16's C interface."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srt_frontend_bf16.argtypes = [p_] * 7 + [i_] * 9 + [f_, i_, i_, p_]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bf16_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    fe8 = PackedFrontend(8000, FeatureConfig(), dev, mm="bf16")
    x8 = np.zeros((512, 40960), np.float32)
    x8[:, :40000] = rng.randn(512, 40000) * 3000
    s8 = torch.from_numpy(x8).to(dev)
    T8 = n_frames(40960, fe8.frame_len, fe8.frame_shift)
    nv = fe8.valid_frames(torch.full((512,), 40000, device=dev), T8)
    Dp = gpu_frontend.dft_mma_operator(fe8.D)
    WAp = gpu_frontend.dense_wa_operator(fe8.W, fe8.A)
    flen, ncols = fe8.D.shape
    nmel, nceps = fe8.dct.shape
    nac = fe8.A.shape[1]
    feat = torch.empty(512, T8, nceps + nac - 1, device=dev)

    def k1(lib, cmvn=1):
        err = lib.srt_frontend_bf16(
            s8.data_ptr(), nv.data_ptr(), Dp.data_ptr(), WAp.data_ptr(),
            fe8.dct.data_ptr(), feat.data_ptr(), 0, 512, 40960, T8, flen,
            fe8.frame_shift, ncols, nmel, nac, nceps, fe8.floor, cmvn, 1,
            stream)
        assert err == 0, err

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = fft_ablation.build(tmp, VARIANTS, SOURCES,
                                  ("frontend_bf16.cu",), bind)
        print(f"bf16_ablation [{card}]: K1 bf16 512 x 5 s @ 8 kHz, median "
              "of 7 trials of 3 calls", flush=True)
        for rnd in range(2):
            full = time_ms(lambda: k1(libs["full"]))
            for name, lib in libs.items():
                t = full if name == "full" else time_ms(lambda: k1(lib))
                print(f"round {rnd} {name:14s} K1 bf16 {t:.4f} ms "
                      f"(full - this {full - t:+.4f})", flush=True)
            print(f"round {rnd} full, K1 bf16 without its CMVN kernel "
                  f"{time_ms(lambda: k1(libs['full'], 0)):.4f} ms",
                  flush=True)


if __name__ == "__main__":
    main()
