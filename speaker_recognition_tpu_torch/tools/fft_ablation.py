"""Where the FFT frontend kernels spend their time, on the card.

    python -m speaker_recognition_tpu_torch.tools.fft_ablation
    python -m speaker_recognition_tpu_torch.tools.fft_ablation --route big,chirp
    python -m speaker_recognition_tpu_torch.tools.fft_ablation --route signals \
        [--csrc <a checkout's csrc/>,speaker_recognition_tpu_torch/csrc]
    python -m speaker_recognition_tpu_torch.tools.fft_ablation --route lpcc \
        [--csrc <a checkout's csrc/>,speaker_recognition_tpu_torch/csrc]

`--route tile` (the default) builds csrc/frontend_fft.cu (K5) and
csrc/frontend.cu (K1) once as they are and once for each variant below,
which switches one stage of the FFT tile (csrc/rfft_tile.cuh) off in a copy
of the sources, and times K5 at 48 kHz (512 x 5 s) and K1 at 8 kHz (512 x
5 s) for each, in turns, two rounds. `big` builds csrc/frontend_big.cu and
csrc/rfft_cluster.cu (K5 on the four-step route of N >= 32768: a frame's
spectrum on a block or a cluster, csrc/rfft_cluster.cuh, past 262144
points the column and row passes of csrc/rfft_passes.cuh, then the fused
projection pass of csrc/rfft_big.cuh) the same way, prints each kernel's
device time (torch.profiler: the spectrum kernel or the passes, the fused
power + projection and its split's combine, the outputs) and times K5 at
48 kHz with fft_size 32768 (one block) and 65536 (a cluster of 2) (8 x 5
s, phase 16's batch of chip_smoke.py) and at 8 kHz with 262144 (a
cluster of 8) and 524288 (the passes) on phase 16's 62 frames, and at 48
kHz with 524288 on 62 frames of 1536 samples (the passes with their
column pass), each beside the FFT route's plain version and cuFFT's rfft
and with the split's S, as it is and without the
spectrum kernel's frame loads, its four passes after the first, the
exchange across the cluster (the reads of every rank's slots and the
C-point DFTs), the post-step's twiddles, the passes' column pass, its
twiddle step or the row pass, with one group of frames through the
passes (no L2 grouping), unsplit (S = 1), or without the projection's
power staging, its FMAs or its whole walk. `chirp` builds csrc/frontend_chirp.cu (K5's
chirp-z kernel at an fft_size that is not a power of two) and times it at
8 kHz with fft_size 1500 and 216 outputs (512 x 5 s, phase 15's) without
its forward FFT, the pointwise product, its inverse FFT, the projection's
FMAs or the whole projection; then csrc/frontend_chirp_cluster.cu (the
route past M = 8192) at fft_size 16000 (M = 16384, 64 x 5 s, phase 15's)
without its forward FFT's passes after the first, the pointwise product,
its inverse FFT, the projection's FMAs or the whole projection; then
the route past M = 131072 on the device-memory passes (csrc/
rfft_passes.cuh) at fft_size 261634 (M = 262144, 2 x 5 s, phase 15's)
without each of its passes, the row pass's pointwise product or second
FFTs, or the fused pass's split; then the dense template of csrc/
frontend_frames.cu at the same shape without its DFT or its projection.
`signals` builds csrc/frontend_full_signals.cu (K5 from the signals, the
44.1/48 kHz serving route) at the FFT sizes 2048 and 4096 and 72 outputs
only, as it is and without its sample loads, its projection's products
or its whole projection walk, or its Levinson tail, with one product in
place of three, A fragments made up, one block an SM, the split by
cvt.rna, or the three products in one accumulator chain; and times each
at 512 x 5 s at 48 kHz beside K5 on the same frames (csrc/
frontend_fft.cu), in turns, two rounds, with ptxas's registers and spills
and the occupancy API's blocks an SM of full_signals_kernel<2048, 9> and
<4096, 9> (srt_full_signals_occupancy). `--csrc` takes the sources of
other checkouts of csrc/signal_tile.cuh's kernel (git archive of a commit
into a git-ignored directory) to time them in the same turns.
`lpcc` builds K1's LPC-cepstra mode at N = 512 and 1024 (72 outputs) from
each source directory of `--csrc`: csrc/frontend_lpcc_signals.cu (one
kernel from the signals on csrc/signal_tile.cuh's tile) where the
directory has it, as it is and without its sample loads, its
projection's products or its whole walk (which zeroes the sums, so the
tail's recursion is skipped too), its LPC-cepstra recursion or its whole
tail, with one TF32 term, with K5's tail (c_n read back from device
memory) in place of its register-held one, and with its launch bounds
asking for 2 or 3 blocks an SM below N = 2048 in place of 4; and
csrc/frontend.cu (K1's LPC mode, and
in a checkout from before that kernel its LPC-cepstra mode: the raw tile,
then lpcc_kernel); times each at 512 x 5 s at 8 kHz and at 16 kHz (CMVN
on), in turns, two rounds, prints ptxas's registers and spills and the
occupancy API's blocks an SM of lpcc_signals_kernel<512, 9> and <1024,
9>, each full route's distance from the FFT route's plain version on the
card, and, with two directories, whether cuobjdump -sass of K1's
packed_frontend_kernel<512, 9>, <2048, 9>, <512, 16> and K5's
full_signals_kernel<2048, 9> is the same in both.
The outputs of a variant are wrong by construction; only its time counts. The
difference to `full` is what the stage costs. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from .. import _build
from ..config import FeatureConfig, MfccConfig, n_frames
from ..features.extract import FullFrontend, PackedFrontend
from ..ops import framing, gpu_frontend
from ..ops import frontend as frontend_ops

# the projection walk the tile, the chirp-z kernel and the four-step
# route share (rfft::project_bins)
NO_PROJECTION_FMA = ("rfft_tile.cuh",
                     "      for (int kk = 0; kk < kw; ++kk) {",
                     "      for (int kk = 0; kk < 0; ++kk) {")
NO_PROJECTION = [("rfft_tile.cuh",
                  "    for (int k0 = 0; k0 < nb; k0 += CK) {",
                  "    for (int k0 = 0; k0 < 0; k0 += CK) {")]

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
    "no_projection_fma": [NO_PROJECTION_FMA],
    "no_projection": NO_PROJECTION,
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

BIG_VARIANTS = {
    "full": [],
    # the cluster route's spectrum kernel (32768 .. 262144 points)
    "no_loads": [("rfft_cluster.cu",
                  "    return make_float2(src.sample(g, j), "
                  "src.sample(g, j + 1));",
                  "    return make_float2((float)j, 1.f);")],
    "no_later_passes": [("rfft_cluster.cu",
                         "  cfft::later_passes(v, tw, C);\n"
                         "  cfft::cluster_sync<C>();",
                         "  cfft::cluster_sync<C>();")],
    "no_exchange": [("rfft_cluster.cu",
                     "      x[c] = c == 0 ? rv[0][s] : "
                     "cfft::cmul(rv[c][s], tw(c * k1));\n"
                     "    cfft::dft<C>(x);",
                     "      x[c] = make_float2((float)k1, (float)c);")],
    "no_post_twiddle": [("rfft_cluster.cu",
                         "    sincospif((float)k / (float)H, &s, &cs);",
                         "    s = 0.f;\n    cs = 1.f;")],
    # the device-memory passes (past 262144 points): without the column
    # pass, its twiddle step, the row pass (FFTs and power), or with every
    # frame of a chunk in one group (no L2 grouping)
    "no_columns": [("rfft_cluster.cu",
                    "        direct ? cudaSuccess\n"
                    "               : passes::columns(",
                    "        true ? cudaSuccess\n"
                    "               : passes::columns(")],
    "no_twiddle_step": [("rfft_passes.cuh",
                         "        cfft::cmul(x, tw(d * k1));",
                         "        x;")],
    "no_rows": [("rfft_cluster.cu",
                 "      return passes::launch(passes::power_rows_kernel<LG2>,",
                 "      if (true) return cudaSuccess;\n"
                 "      return passes::launch(passes::power_rows_kernel<LG2>,"
                 )],
    "one_group": [("rfft_passes.cuh", "  return g < 1 ? 1 : (int)g;",
                   "  return 65535;")],
    # the fused pass: unsplit (S = 1 at any frame count), without its
    # power staging, its FMAs or its whole walk
    "no_split": [("rfft_big.cuh",
                  "  if (blocks >= SPLIT_BLOCKS) return nbins;",
                  "  if (true) return nbins;")],
    "no_row_fill": [("rfft_big.cuh",
                     "      ys[f * YS + j] = k < nbins && (live >> f & 1u)",
                     "      ys[f * YS + j] = true ? 0.f : k < nbins && "
                     "(live >> f & 1u)")],
    "no_projection_fma": [NO_PROJECTION_FMA],
    "no_projection": NO_PROJECTION,
}
BIG_SOURCES = ("rfft_tile.cuh", "rfft_big.cuh", "rfft_cluster.cuh",
               "rfft_passes.cuh", "rfft_cluster.cu", "frontend_big.cu")
# the chirp-z kernel at M = 1024 and 256 columns only (one instantiation)
CHIRP_ONE = [
    ("frontend_chirp.cu",
     "    case 2048: return f(std::integral_constant<int, 2048>{});\n"
     "    case 4096: return f(std::integral_constant<int, 4096>{});\n"
     "    case 8192: return f(std::integral_constant<int, 8192>{});\n", ""),
    ("rfft_tile.cuh",
     "    case 9: return f(std::integral_constant<int, 9>{});\n"
     "    case 16: return f(std::integral_constant<int, 16>{});\n", ""),
    ("rfft_tile.cuh",
     "    case 64: return f(std::integral_constant<int, 64>{});\n  }\n"
     "  return cudaErrorInvalidValue;\n}\n\n__device__",
     "  }\n  return cudaErrorInvalidValue;\n}\n\n__device__")]
CHIRP_VARIANTS = {
    "full": [],
    "no_forward_fft": [
        ("frontend_chirp.cu", "    rounds<M>(\n        [&](int rd, float2 (&r)"
         "[32]) {\n#pragma unroll\n          for (int q = 0; q < 32; ++q) "
         "r[rfft::brev_bits(q, 5)] = nxt[q];",
         "    if (false) rounds<M>(\n        [&](int rd, float2 (&r)[32]) "
         "{\n#pragma unroll\n          for (int q = 0; q < 32; ++q) "
         "r[rfft::brev_bits(q, 5)] = nxt[q];"),
        ("frontend_chirp.cu", "      column_pass<M>(buf, c, ctw, r);",
         "      for (int b = 0; b < 32; ++b) "
         "r[b] = buf[rfft::slot<P>(PL * b + c)];")],
    "no_pointwise": [
        ("frontend_chirp.cu",
         "        const float2 y = cmul(r[b], __ldg(bh + PL * b + c));",
         "        const float2 y = r[b];")],
    "no_inverse_fft": [
        ("frontend_chirp.cu", "    // them)\n    rounds<M>(",
         "    // them)\n    if (false) rounds<M>("),
        ("frontend_chirp.cu", "      column_pass<M>(dst, c, ctw, r);",
         "      for (int b = 0; b < 32; ++b) "
         "r[b] = dst[rfft::slot<P>(PL * b + c)];")],
    "no_projection_fma": [NO_PROJECTION_FMA],
    "no_projection": NO_PROJECTION,
}
CHIRP_SOURCES = ("rfft_tile.cuh", "rfft_big.cuh", "rfft_cluster.cuh",
                 "rfft_passes.cuh", "frontend_chirp.cu")
# the cluster route at M = 16384 and up to 72 outputs only: the tile
# kernel's M = 1024, the cluster of one block, OPL 9
CLUSTER_ONE = [
    CHIRP_ONE[0],
    ("rfft_tile.cuh",
     "    case 16: return f(std::integral_constant<int, 16>{});\n"
     "    case 32: return f(std::integral_constant<int, 32>{});\n"
     "    case 64: return f(std::integral_constant<int, 64>{});\n", ""),
    ("rfft_cluster.cuh",
     "    case 2: return f(std::integral_constant<int, 2>{});\n"
     "    case 4: return f(std::integral_constant<int, 4>{});\n"
     "    case 8: return f(std::integral_constant<int, 8>{});\n", "")]
CHIRP_CLUSTER_VARIANTS = {
    "full": [],
    "no_forward_passes": [
        ("frontend_chirp_cluster.cu",
         "    cfft::later_passes(v, tw, C);\n  } else {", "  } else {")],
    "no_pointwise": [
        ("frontend_chirp_cluster.cu",
         "    const float2 y = cfft::cmul(v[s], __ldg(bhr + m1));",
         "    const float2 y = v[s];")],
    "no_inverse_fft": [
        ("frontend_chirp_cluster.cu",
         "  // 4. the inverse\n  cfft::block_fft(v, tw, C);",
         "  // 4. the inverse")],
    "no_projection_fma": [NO_PROJECTION_FMA],
    "no_projection": NO_PROJECTION,
}
CHIRP_CLUSTER_SOURCES = CHIRP_SOURCES + ("rfft_cluster.cu",
                                         "frontend_chirp_cluster.cu")
# the chirp-z route on the device-memory passes (past M = 131072): without
# its first column pass (over a = x c), its row pass, the row pass's
# pointwise product or its second FFTs, its last column pass (into the
# power rows), the fused pass's split or its whole projection
CHIRP_PASSES_VARIANTS = {
    "full": [],
    "no_first_columns": [
        ("frontend_chirp_cluster.cu",
         "        direct ? cudaSuccess\n"
         "               : passes::columns(",
         "        true ? cudaSuccess\n"
         "               : passes::columns(")],
    "no_rows": [
        ("frontend_chirp_cluster.cu",
         "      return passes::launch(passes::chirp_rows_kernel<LG2>,",
         "      if (true) return cudaSuccess;\n"
         "      return passes::launch(passes::chirp_rows_kernel<LG2>,")],
    "no_pointwise": [
        ("rfft_passes.cuh",
         "    const float2 y = cfft::cmul(v[s], __ldg(b + i));",
         "    const float2 y = v[s];")],
    "no_second_row_ffts": [
        ("rfft_passes.cuh",
         "    ffts<LG2, PAD>(v, tw, lgt, opaque_tid());\n"
         "    if (turn == 1) break;",
         "    if (turn == 0) ffts<LG2, PAD>(v, tw, lgt, opaque_tid());\n"
         "    if (turn == 1) break;")],
    "no_last_columns": [
        ("frontend_chirp_cluster.cu",
         "    err = passes::columns(\n        passes::MatrixIn{z, lgm},",
         "    if (false) err = passes::columns(\n"
         "        passes::MatrixIn{z, lgm},")],
    "no_split": BIG_VARIANTS["no_split"],
    "no_projection": NO_PROJECTION,
}

# --route signals: csrc/frontend_full_signals.cu (K5 from the signals) at
# the FFT sizes 2048 and 4096 and 72 outputs only
SIGNAL_ONE = [
    ("rfft_tile.cuh",
     "    case 64: return f(std::integral_constant<int, 64>{});\n"
     "    case 128: return f(std::integral_constant<int, 128>{});\n"
     "    case 256: return f(std::integral_constant<int, 256>{});\n"
     "    case 512: return f(std::integral_constant<int, 512>{});\n"
     "    case 1024: return f(std::integral_constant<int, 1024>{});\n", ""),
    ("rfft_tile.cuh",
     "    case 8192: return f(std::integral_constant<int, 8192>{});\n"
     "    case 16384: return f(std::integral_constant<int, 16384>{});\n", ""),
    ("rfft_tile.cuh",
     "    case 16: return f(std::integral_constant<int, 16>{});\n"
     "    case 32: return f(std::integral_constant<int, 32>{});\n"
     "    case 64: return f(std::integral_constant<int, 64>{});\n", "")]
# samples p and p + 1 made up from p
MADE_UP_PAIR = ("make_float2((float)((p * 40503) & 1023) - 511.5f, "
                "(float)(((p + 1) * 40503) & 1023) - 511.5f);")
# the three products of csrc/signal_tile.cuh's projection
PROJECTION_PASSES = (
    "          mma_tf32(s1, al, bh0, bh1);\n",
    "          mma_tf32(s2, ah, __float_as_uint(v.z), "
    "__float_as_uint(v.w));\n",
    "          mma_tf32(acc[jn], ah, bh0, bh1);\n")
# variant -> its edits of csrc/signal_tile.cuh
SIGNAL_VARIANTS = {
    "full": [],
    # the loads of the signal and the window, the samples made up from
    # their index (noise-like, so that the Levinson tail sees no
    # degenerate frame; the fold stays: no frame at 48 kHz is longer than
    # the FFT)
    "no_gather": [
        ("signal_tile.cuh",
         "    v[q] = make_float2(p < s.flen ? y0 : 0.f, p + 1 < "
         "s.flen ? y1 : 0.f);", "    v[q] = " + MADE_UP_PAIR)],
    # the projection's products (the tensor-core MMAs and their fragment
    # loads), then its whole walk
    "no_projection_fma": [("signal_tile.cuh", "".join(PROJECTION_PASSES),
                           "")],
    "no_projection": [("signal_tile.cuh",
                       "        for (int b = p; b < q; ++b) {",
                       "        for (int b = q; b < q; ++b) {")],
    # the tail's Levinson recursion (lpc_in_registers)
    "no_levinson": [("signal_tile.cuh",
                     "      lpc_in_registers<MAXP>(sums + (size_t)f * stride "
                     "+ nmel, o, order);", "      (void)0;")],
    # one product (hi.hi) in place of three; A fragments made up, not
    # loaded from the power rows
    "one_term": [("signal_tile.cuh", "".join(PROJECTION_PASSES),
                  PROJECTION_PASSES[2])],
    "no_a_loads": [
        ("signal_tile.cuh", f"split({r} && k{d} <= H ? {r}[k{d}] : 0.f, ",
         f"split((float)(k + {i}), ")
        for i, (r, d) in enumerate((("r0", ""), ("r1", ""), ("r0", " + 4"),
                                    ("r1", " + 4")))],
    # the launch bounds asking for one block an SM (255 registers) in
    # place of two
    "one_block_an_sm": [("signal_tile.cuh", "return n <= 2048 ? 2 : 1;",
                         "return 1;")],
    # the split's rounding by cvt.rna.tf32.f32 in place of integer
    # operations (the same bits)
    "cvt_split": [
        ("tf32_mma.cuh",
         "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : "
         "\"f\"(x));\n  return r;")],
    # the three products in one accumulator chain
    "one_chain": [
        ("signal_tile.cuh", "".join(PROJECTION_PASSES),
         "".join(PROJECTION_PASSES).replace("(s1,", "(acc[jn],").replace(
             "(s2,", "(acc[jn],"))],
}
SIGNAL_SOURCES = ("rfft_tile.cuh", "packed_tile.cuh", "signal_tile.cuh",
                  "tf32_mma.cuh", "frontend_full_signals.cu",
                  "frontend_fft.cu")

def bind(lib) -> None:
    """The argument types of K5's and K1's C interfaces."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srt_fft_frames_frontend.argtypes = [p_] * 6 + [i_] * 6 + [f_, p_]
    lib.srt_packed_frontend.argtypes = ([p_] * 7 + [i_] * 9
                                        + [f_, i_, f_, i_, i_, p_])


def _edit(d: str, name: str, edit) -> None:
    """Apply one edit to the copy of the sources in d: a (text of csrc/
    rfft_tile.cuh, replacement) or a (file, text, replacement)."""
    fname, old, new = edit if len(edit) == 3 else ("rfft_tile.cuh", *edit)
    path = os.path.join(d, fname)
    with open(path) as f:
        src = f.read()
    if old not in src:
        raise SystemExit(f"{name}: csrc/{fname} no longer has {old!r}")
    with open(path, "w") as f:
        f.write(src.replace(old, new))


def build(tmp: str, variants=VARIANTS, sources=SOURCES,
          entries=("frontend_fft.cu", "frontend.cu"), bind=bind,
          csrc: str = _build.CSRC, logs: dict | None = None) -> dict:
    """One library per variant of `variants` over copies of `sources` from
    `csrc` (each edit as _edit takes it), built from the `entries` files
    (or, a dict, each variant's own), all nvcc processes at once; bind(lib)
    sets each library's argument types. With `logs`, nvcc runs with ptxas
    -v and each variant's output lands in logs[variant]."""
    nvcc = _build._nvcc()
    flags = _build.NVCC_FLAGS if logs is not None else _build.NVCC_FLAGS[:-2]
    procs = {}
    for name, edits in variants.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in sources:
            shutil.copy(os.path.join(csrc, f), d)
        for edit in edits:
            _edit(d, name, edit)
        ents = entries[name] if isinstance(entries, dict) else entries
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", os.path.join(d, "lib.so"),
             *(os.path.join(d, e) for e in ents)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-3000:]}")
        if logs is not None:
            logs[name] = out
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


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def frames_of(fe, fs: int, B: int, seconds: float, rng,
              dev) -> torch.Tensor:
    """Windowed, pre-emphasized frames [B * T, flen] of B noise signals of
    `seconds` at fs, as K5 takes them."""
    L = int(fs * seconds)
    x = torch.from_numpy((rng.randn(B, L) * 3000).astype(np.float32)).to(dev)
    return framing.window_preemph(
        framing.frame_signal(x, fe.frame_len, fe.frame_shift), fe.frame_len,
        fe.pre_emph, fe.preemph_first).reshape(-1, fe.frame_len).contiguous()


def device_ms(fn, calls=3) -> dict:
    """Device ms a call by kernel (torch.profiler), the kernels' names cut
    to their function."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / (
                1e3 * calls)
    return {k: round(v, 4) for k, v in out.items()}


def tile_main(card: str, dev, rng, variants=None) -> None:
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
        libs = build(tmp, variants or VARIANTS)
        print(f"fft_ablation [{card}]: K5 512 x 5 s @ 48 kHz, K1 512 x 5 s "
              "@ 8 kHz, median of 7 trials of 3 calls", flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                print(f"round {rnd} {name:18s} K5 {time_ms(lambda: k5(lib)):.3f}"
                      f" ms  K1 {time_ms(lambda: k1(lib)):.3f} ms", flush=True)
            print(f"round {rnd} full, K1 without its CMVN kernel "
                  f"{time_ms(lambda: k1(libs['full'], 0)):.3f} ms",
                  flush=True)


def bind_signals(lib) -> None:
    """The argument types of csrc/frontend_full_signals.cu's and csrc/
    frontend_fft.cu's C interfaces, where the library has them."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    if hasattr(lib, "srt_full_signals_frontend"):
        lib.srt_full_signals_frontend.argtypes = [p_] * 7 + [i_] * 9 + [
            f_, i_, f_, i_, i_, p_]
        lib.srt_full_signals_occupancy.argtypes = [i_, i_, ip]
    if hasattr(lib, "srt_fft_frames_frontend"):
        lib.srt_fft_frames_frontend.argtypes = [p_] * 6 + [i_] * 6 + [f_, p_]
        lib.srt_fft_operator_shape.argtypes = [i_, i_, ip, ip, ip]


def ptxas_lines(log: str) -> list[str]:
    """ptxas -v's registers, spills and shared memory of each instance of
    full_signals_kernel in an nvcc log."""
    out = []
    for m in re.finditer(
            r"Function properties for \S*full_signals_kernelILi(\d+)ELi(\d+)"
            r"\S*\n\s*(.*)\n[^\n]*?(Used \d+ registers[^\n]*)", log):
        out.append(f"full_signals_kernel<{m[1]}, {m[2]}>: {m[3].strip()}; "
                   f"{m[4].strip()}")
    return out


def signals_main(card: str, dev, rng, variants=None, csrcs=None) -> None:
    """K5 from the signals (csrc/frontend_full_signals.cu) by stage, at 512
    x 5 s @ 48 kHz beside K5 on the same frames (csrc/frontend_fft.cu),
    for the sources of each directory of `csrcs` (the package's by
    default) in turns; ptxas's registers and spills and the occupancy
    API's blocks an SM of full_signals_kernel<2048, 9> and <4096, 9>."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    csrcs = csrcs or [_build.CSRC]
    fe = FullFrontend(48000, FeatureConfig(), dev)
    x = np.zeros((512, 245760), np.float32)
    x[:, :240000] = rng.randn(512, 240000) * 3000
    sig = torch.from_numpy(x).to(dev)
    del x
    B, Lp = sig.shape
    T = n_frames(Lp, fe.frame_len, fe.frame_shift)
    nv = fe.valid_frames(torch.full((B,), 240000, device=dev), T)
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    feat = torch.empty(B, T, nceps + nac - 1, device=dev)
    wp = framing.window_preemph(
        framing.frame_signal(sig, fe.frame_len, fe.frame_shift),
        fe.frame_len, fe.pre_emph, fe.preemph_first).reshape(
            -1, fe.frame_len).contiguous()
    n = wp.shape[0]
    ceps = torch.empty(n, nceps, device=dev)
    r = torch.empty(n, nac, device=dev)
    variants = variants or SIGNAL_VARIANTS
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs, logs = {}, {}
        for i, csrc in enumerate(csrcs):
            tag = "" if len(csrcs) == 1 else f"{i}:"
            vs = {tag + k: SIGNAL_ONE + v for k, v in variants.items()}
            vs[tag + "k5_frames"] = SIGNAL_ONE
            entries = {k: ("frontend_full_signals.cu",) for k in vs}
            entries[tag + "k5_frames"] = ("frontend_fft.cu",)
            sub = os.path.join(tmp, str(i))
            os.makedirs(sub)
            libs.update(build(sub, vs, SIGNAL_SOURCES, entries, bind_signals,
                              csrc, logs))
            print(f"fft_ablation [{card}] sources {tag}{csrc}", flush=True)

        calls = {}
        for k, lib in libs.items():
            if k.endswith("k5_frames"):
                op = gpu_frontend._fft_operator(fe.mel, fe.acorr, fe.n_fft,
                                                lib)

                def k5(lib=lib, op=op):
                    err = lib.srt_fft_frames_frontend(
                        wp.data_ptr(), op.data_ptr(), fe.dct.data_ptr(),
                        ceps.data_ptr(), r.data_ptr(), None, n, fe.frame_len,
                        fe.n_fft, nmel, nac, nceps, fe.floor, stream)
                    assert err == 0, err
                calls[k] = k5
                continue
            op = gpu_frontend.signal_operator(lib, fe.mel, fe.acorr, fe.n_fft)

            def call(lib=lib, op=op):
                err = lib.srt_full_signals_frontend(
                    sig.data_ptr(), nv.data_ptr(), fe.window.data_ptr(),
                    op.data_ptr(), fe.dct.data_ptr(), feat.data_ptr(), None,
                    B, Lp, T, fe.frame_len, fe.frame_shift, fe.n_fft, nmel,
                    nac, nceps, fe.pre_emph, int(fe.preemph_first), fe.floor,
                    1, 0, stream)
                assert err == 0, err
            calls[k] = call
            if k.endswith("full"):
                for nfft in (2048, 4096):
                    o = (ctypes.c_int * 4)()
                    assert lib.srt_full_signals_occupancy(nfft, nmel + nac,
                                                          o) == 0
                    print(f"fft_ablation [{card}] {k} full_signals_kernel<"
                          f"{nfft}, 9>: {o[0]} blocks an SM, {o[1]} "
                          f"registers, {o[2]} local bytes a thread, {o[3]} B "
                          "of dynamic shared memory", flush=True)
                for line in ptxas_lines(logs[k]):
                    print(f"fft_ablation [{card}] {k} ptxas: {line}",
                          flush=True)
        print(f"fft_ablation [{card}]: K5 from the signals, 512 x 5 s @ 48 "
              f"kHz ({n} frames, CMVN on), beside K5 on the same frames "
              "(k5_frames), median of 7 trials of 3 calls, the variants in "
              "turns", flush=True)
        for rnd in range(2):
            for k, fn in calls.items():
                print(f"round {rnd} {k:22s} {time_ms(fn):.3f} ms", flush=True)


# --route lpcc: K1's LPC-cepstra mode at N = 512 and 1024 and 72 outputs
# only
def _keep_cases(keep_n, keep_opl):
    """Edits of csrc/rfft_tile.cuh that leave rfft::with_n and with_opl
    the cases keep_n and keep_opl only (64, a case of both, neither)."""
    assert 64 not in keep_n and 64 not in keep_opl
    cut = [n for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
           if n not in keep_n]
    cut += [o for o in (9, 16, 32) if o not in keep_opl]
    return [("rfft_tile.cuh", f"    case {c}: return f(std::"
             f"integral_constant<int, {c}>{{}});\n", "") for c in cut]


LPCC_ONE = _keep_cases((512, 1024), (9,))
# variant -> its edits of csrc/signal_tile.cuh or frontend_lpcc_signals.cu
LPCC_VARIANTS = {
    "full": [],
    "no_gather": SIGNAL_VARIANTS["no_gather"],
    "no_projection_fma": SIGNAL_VARIANTS["no_projection_fma"],
    "no_projection": SIGNAL_VARIANTS["no_projection"],
    # the tail's Levinson and recursion (lpcc_short)
    "no_lpcc": [("frontend_lpcc_signals.cu",
                 "      lpcc_short(r, o, nac - 1, n_lpcc);", "      (void)0;")],
    # K5's tail (sigtile::features: c_n read back from the output row in
    # device memory, the factors divided at run time) in place of
    # lpcc_features
    "k5_tail": [("frontend_lpcc_signals.cu",
                 "    lpcc_features<OPL, NTH>(wrows,",
                 "    sigtile::features<OPL, NTH>(wrows,"),
                ("frontend_lpcc_signals.cu",
                 "    lpcc_features<OPL, NTH>(sums,",
                 "    sigtile::features<OPL, NTH>(sums,")],
    "one_term": SIGNAL_VARIANTS["one_term"],
    # the whole tail: the DCT, the LPC cepstra and the features' writes
    "no_tail": [("frontend_lpcc_signals.cu",
                 "  if (OPL == 64 && nchunk > 1)\n"
                 "    lpcc_features<OPL, NTH>(wrows,",
                 "  if (false)\n    lpcc_features<OPL, NTH>(wrows,"),
                ("frontend_lpcc_signals.cu",
                 "  else\n    lpcc_features<OPL, NTH>(sums,",
                 "  else if (false)\n    lpcc_features<OPL, NTH>(sums,")],
    "blocks2": [("frontend_lpcc_signals.cu", "constexpr int SMALL_BLOCKS = 4;",
                 "constexpr int SMALL_BLOCKS = 2;")],
    "blocks3": [("frontend_lpcc_signals.cu", "constexpr int SMALL_BLOCKS = 4;",
                 "constexpr int SMALL_BLOCKS = 3;")],
}
# the instances whose machine code must not change: K1's at 8 kHz (LPC and
# raw modes share it), at 22.05 kHz, at 128 outputs, and K5's at 48 kHz
SASS_KERNELS = ("packed_frontend_kernelILi512ELi9E",
                "packed_frontend_kernelILi2048ELi9E",
                "packed_frontend_kernelILi512ELi16E",
                "full_signals_kernelILi2048ELi9E")


def bind_lpcc(lib) -> None:
    """The argument types of csrc/frontend_lpcc_signals.cu's, csrc/
    frontend_full_signals.cu's operator shape, csrc/frontend.cu's (either
    signature: with n_lpcc and raw before the stream, or without) and
    csrc/frontend_fft.cu's, where the library has them."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    if hasattr(lib, "srt_lpcc_signals_frontend"):
        lib.srt_lpcc_signals_frontend.argtypes = [p_] * 7 + [i_] * 9 + [
            f_, i_, f_, i_, i_, p_]
        lib.srt_lpcc_signals_occupancy.argtypes = [i_, i_, ip]
        lib.srt_full_signals_operator_shape.argtypes = [i_, i_, ip, ip, ip,
                                                        ip]
    if hasattr(lib, "srt_fft_operator_shape"):
        lib.srt_fft_operator_shape.argtypes = [i_, i_, ip, ip, ip]


def _sass(path: str) -> dict:
    """cuobjdump -sass of a cubin: {function: its instructions, addresses
    and comments cut}."""
    out = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
         "-sass", path], capture_output=True, text=True, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        funcs[name.strip()] = [
            re.sub(r"/\*[0-9a-f]+\*/", "", ln).split(";")[0].strip()
            for ln in body.splitlines()
            if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln)]
    return funcs


def sass_check(card: str, csrcs: list[str], tmp: str) -> None:
    """cuobjdump -sass of SASS_KERNELS built from each directory of csrcs
    (frontend.cu and frontend_full_signals.cu as cubins, rfft::with_n and
    with_opl cut to N = 512, 2048 and OPL 9, 16 in every directory alike):
    whether each is the same in all of them."""
    nvcc = _build._nvcc()
    keep = _keep_cases((512, 2048), (9, 16))
    procs = []
    for i, csrc in enumerate(csrcs):
        d = os.path.join(tmp, f"sass{i}")
        os.makedirs(d)
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(csrc, f), d)
        for edit in keep:
            _edit(d, "sass", edit)
        for src in ("frontend.cu", "frontend_full_signals.cu"):
            procs.append((i, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS[:-2], "-cubin", "-o",
                 os.path.join(d, src + ".cubin"), os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for i, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"sass {i}: nvcc failed\n{out[-3000:]}")
    funcs = []
    for i in range(len(csrcs)):
        d = os.path.join(tmp, f"sass{i}")
        f = {}
        for src in ("frontend.cu", "frontend_full_signals.cu"):
            f.update(_sass(os.path.join(d, src + ".cubin")))
        funcs.append(f)
    for k in SASS_KERNELS:
        bodies = []
        for f in funcs:
            names = [n for n in f if k in n]
            bodies.append(f[names[0]] if len(names) == 1 else None)
        same = all(b is not None and b == bodies[0] for b in bodies)
        print(f"fft_ablation [{card}] cuobjdump -sass {k}: "
              f"{[len(b) if b else None for b in bodies]} instructions, "
              f"the same in every directory: {same}", flush=True)


def lpcc_main(card: str, dev, rng, csrcs=None) -> None:
    """K1's LPC-cepstra mode by stage at 512 x 5 s @ 8 and 16 kHz, for
    the sources of each directory of `csrcs` (the package's by default) in
    turns: the kernel from the signals (csrc/frontend_lpcc_signals.cu) and
    its variants where a directory has it, K1's LPC mode and, in a
    directory without that kernel, its raw tile + lpcc_kernel; ptxas's
    registers and spills, the occupancy API's blocks an SM, each route's
    distance from its plain version; with two directories the SASS
    check."""
    from ..config import LpcConfig
    stream = torch.cuda.current_stream(dev).cuda_stream
    csrcs = csrcs or [_build.CSRC]
    cases = {}
    for fs in (8000, 16000):
        fe = PackedFrontend(fs, FeatureConfig(lpc=LpcConfig(n_lpcc=16)),
                            dev)
        fe_lpc = PackedFrontend(fs, FeatureConfig(), dev)
        L = 5 * fs
        Lp = -(-L // 4096) * 4096
        x = np.zeros((512, Lp), np.float32)
        x[:, :L] = rng.randn(512, L) * 3000
        sig = torch.from_numpy(x).to(dev)
        T = n_frames(Lp, fe.frame_len, fe.frame_shift)
        nv = fe.valid_frames(torch.full((512,), L, device=dev), T)
        want = gpu_frontend.packed_from_signals_fft_reference(
            sig, nv, fe.fft, fe.dct, fe.floor, fe.frame_shift, True, True, 16)
        cases[fs] = (fe, fe_lpc, sig, nv, T, want)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs, logs, kinds = {}, {}, {}
        for i, csrc in enumerate(csrcs):
            tag = "" if len(csrcs) == 1 else f"{i}:"
            files = tuple(f for f in os.listdir(csrc)
                          if f.endswith((".cu", ".cuh")))
            vs = {}
            if "frontend_lpcc_signals.cu" in files:
                vs = {tag + k: LPCC_ONE + v for k, v in LPCC_VARIANTS.items()}
            entries = {k: ("frontend_lpcc_signals.cu",
                           "frontend_full_signals.cu") for k in vs}
            vs[tag + "k1"] = LPCC_ONE
            # frontend.cu's four-step route calls rfft_cluster.cu's spectra
            entries[tag + "k1"] = ("frontend.cu", "frontend_fft.cu",
                                   "rfft_cluster.cu")
            with open(os.path.join(csrc, "frontend.cu")) as f:
                kinds[tag + "k1"] = ("raw" if "int n_lpcc, void* raw, void* "
                                     "stream" in f.read() else "lpc")
            sub = os.path.join(tmp, str(i))
            os.makedirs(sub)
            libs.update(build(sub, vs, files, entries, bind_lpcc, csrc,
                              logs))
            print(f"fft_ablation [{card}] sources {tag}{csrc}", flush=True)
        for k, lib in libs.items():
            p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            if k in kinds:  # K1's packed entry point, by its signature
                tail = [i_, p_, p_] if kinds[k] == "raw" else [p_]
                lib.srt_packed_frontend.argtypes = ([p_] * 7 + [i_] * 9
                                                    + [f_, i_, f_, i_, i_]
                                                    + tail)

        calls = {}
        for fs, (fe, fe_lpc, sig, nv, T, want) in cases.items():
            B, Lp = sig.shape
            nmel, nceps = fe.dct.shape
            nac = fe.fft_acorr.shape[1]
            for k, lib in libs.items():
                feat = torch.empty(B, T, nceps + 15, device=dev)
                if k in kinds:
                    op = gpu_frontend._fft_operator(fe.fft_mel, fe.fft_acorr,
                                                    fe.n_fft, lib)
                    lfe = fe_lpc
                    op_lpc = gpu_frontend._fft_operator(
                        lfe.fft_mel, lfe.fft_acorr, lfe.n_fft, lib)

                    def lpc(lib=lib, op=op_lpc, feat=feat, lfe=lfe, sig=sig,
                            nv=nv, T=T, kind=kinds[k]):
                        more = (0, None, stream) if kind == "raw" else (
                            stream,)
                        err = lib.srt_packed_frontend(
                            sig.data_ptr(), nv.data_ptr(),
                            lfe.window.data_ptr(), op.data_ptr(),
                            lfe.dct.data_ptr(), feat.data_ptr(), None,
                            sig.shape[0], sig.shape[1], T, lfe.frame_len,
                            lfe.frame_shift, lfe.n_fft, nmel,
                            lfe.fft_acorr.shape[1], nceps, lfe.pre_emph,
                            int(lfe.preemph_first), lfe.floor, 1, 1, *more)
                        assert err == 0, err
                    calls[(fs, k.replace("k1", "k1_lpc_mode"))] = (lpc, None)
                    if kinds[k] != "raw":
                        continue
                    raw = torch.empty(B, T, nceps + nac, device=dev)

                    def lpcc(lib=lib, op=op, feat=feat, raw=raw, fe=fe,
                             sig=sig, nv=nv, T=T):
                        err = lib.srt_packed_frontend(
                            sig.data_ptr(), nv.data_ptr(),
                            fe.window.data_ptr(), op.data_ptr(),
                            fe.dct.data_ptr(), feat.data_ptr(), None,
                            sig.shape[0], sig.shape[1], T, fe.frame_len,
                            fe.frame_shift, fe.n_fft, nmel, nac, nceps,
                            fe.pre_emph, int(fe.preemph_first), fe.floor, 1,
                            1, 16, raw.data_ptr(), stream)
                        assert err == 0, err
                        return feat
                    calls[(fs, k.replace("k1", "raw_tile_lpcc_kernel"))] = (
                        lpcc, want)
                    continue
                op = gpu_frontend.signal_operator(lib, fe.fft_mel,
                                                  fe.fft_acorr, fe.n_fft)

                def call(lib=lib, op=op, feat=feat, fe=fe, sig=sig, nv=nv,
                         T=T):
                    err = lib.srt_lpcc_signals_frontend(
                        sig.data_ptr(), nv.data_ptr(), fe.window.data_ptr(),
                        op.data_ptr(), fe.dct.data_ptr(), feat.data_ptr(),
                        None, sig.shape[0], sig.shape[1], T, fe.frame_len,
                        fe.frame_shift, fe.n_fft, nmel, nac, nceps,
                        fe.pre_emph, int(fe.preemph_first), fe.floor, 1, 16,
                        stream)
                    assert err == 0, err
                    return feat
                calls[(fs, k)] = (call, want if k.endswith(
                    ("full", "blocks2", "blocks3", "k5_tail")) else None)
        for k, lib in libs.items():
            if k in kinds:
                continue
            for n_fft in (512, 1024):
                o = (ctypes.c_int * 4)()
                assert lib.srt_lpcc_signals_occupancy(n_fft, 66, o) == 0
                print(f"fft_ablation [{card}] {k} lpcc_signals_kernel<"
                      f"{n_fft}, 9>: {o[0]} blocks an SM, {o[1]} registers, "
                      f"{o[2]} local bytes a thread, {o[3]} B of dynamic "
                      "shared memory", flush=True)
            for m in re.finditer(
                    r"Function properties for \S*lpcc_signals_kernelILi(\d+)"
                    r"ELi(\d+)\S*\n\s*(.*)\n[^\n]*?(Used \d+ registers[^\n]*)",
                    logs[k]):
                print(f"fft_ablation [{card}] {k} ptxas: lpcc_signals_kernel"
                      f"<{m[1]}, {m[2]}>: {m[3].strip()}; {m[4].strip()}",
                      flush=True)
        for (fs, k), (fn, want) in calls.items():
            if want is None:
                continue
            fe = cases[fs][0]
            got = fn().clone()
            again = fn()
            torch.cuda.synchronize()
            nc = fe.dct.shape[1]
            mask = torch.arange(got.shape[1], device=dev) < cases[fs][3][:,
                                                                        None]
            d = (got - want).abs()[mask]
            lp = d[:, nc:]
            bad = ((lp > 1e-2) & (lp > 1e-3 * want[mask][:, nc:].abs())).sum()
            print(f"fft_ablation [{card}] {fs} Hz {k} against the FFT route's "
                  f"plain version: cepstra max|d| {float(d[:, :nc].max()):.3e}"
                  f", LPC cepstra max|d| {float(lp.max()):.3e}, entries past "
                  f"1e-2 and 1e-3 relative {int(bad)}, two calls bitwise "
                  f"{torch.equal(got, again)}", flush=True)
        print(f"fft_ablation [{card}]: K1's LPC-cepstra mode, 512 x 5 s @ 8 "
              "and 16 kHz (CMVN on), beside K1's LPC mode (k1_lpc_mode), "
              "median of 7 trials of 3 calls, the variants in turns",
              flush=True)
        for rnd in range(2):
            for (fs, k), (fn, _) in calls.items():
                print(f"round {rnd} {fs:5d} Hz {k:26s} {time_ms(fn):.3f} ms",
                      flush=True)
        if len(csrcs) > 1:
            sass_check(card, csrcs, tmp)


def bind_big(lib) -> None:
    """The argument types of csrc/frontend_big.cu's C interface."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.srt_big_fft_frames.argtypes = [p_] * 6 + [i_] * 6 + [f_, i_, p_]
    lib.srt_big_operator_shape.argtypes = [i_, i_, ip, ip, ip]
    lib.srt_big_scratch_floats.argtypes = [i_, i_, i_]
    lib.srt_big_scratch_floats.restype = ctypes.c_longlong
    lib.srt_big_ranges.argtypes = [i_, i_]


# the four-step route's cases: (fs, utterances, samples each, fft_size):
# phase 16's 8 x 5 s at 48 kHz of chip_smoke.py (2,488 frames) at 32768 (one
# block) and 65536 (a cluster of 2), and its few frames at 8 kHz (2 x 4096
# samples, 62 frames) at 262144 (a cluster of 8) and 524288 (past the
# cluster's reach: frames of 256 samples fit a row of the passes' matrix,
# which the row pass loads itself), and 62 frames of 1536 samples at 48 kHz
# (2 x 24,576 samples) at 524288, which take the column pass
BIG_CASES = ((48000, 8, 240000, 32768), (48000, 8, 240000, 65536),
             (8000, 2, 4096, 262144), (8000, 2, 4096, 524288),
             (48000, 2, 24576, 524288))


def big_main(card: str, dev, rng, variants=None) -> None:
    """The four-step route's kernels and its fused pass's parts, beside
    the FFT route's plain version and cuFFT's rfft of the same frames."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp, variants or BIG_VARIANTS, BIG_SOURCES,
                     ("frontend_big.cu", "rfft_cluster.cu"), bind_big)
        for fs, nutt, nsamp, n in BIG_CASES:
            fe = FullFrontend(fs, FeatureConfig(mfcc=MfccConfig(
                fft_size=n)), dev)
            wp = frames_of(fe, fs, nutt, nsamp / fs, rng, dev)
            nf = wp.shape[0]
            nmel, nceps = fe.dct.shape
            nac = fe.acorr.shape[1]
            ceps = torch.empty(nf, nceps, device=dev)
            r = torch.empty(nf, nac, device=dev)
            yard = {
                "plain": lambda: gpu_frontend.mfcc_from_frames_fft_reference(
                    wp, fe.mel, fe.dct, fe.floor, fe.acorr, n),
                "rfft": lambda: torch.fft.rfft(wp, n=n)}
            print(f"fft_ablation [{card}] four-step K5 {fs // 1000} kHz, "
                  f"fft_size {n}, {nf} frames: the FFT route's plain version "
                  f"{time_ms(yard['plain']):.3f} ms, cuFFT's "
                  f"torch.fft.rfft(frames, n={n}) alone "
                  f"{time_ms(yard['rfft']):.3f} ms", flush=True)
            for name, lib in libs.items():
                op = gpu_frontend._fft_operator(fe.mel, fe.acorr, n, lib,
                                                "srt_big_operator_shape")
                chunk = gpu_frontend.big_chunk(lib, n, nmel + nac, nf)
                sc = torch.empty(lib.srt_big_scratch_floats(
                    n, nmel + nac, chunk), device=dev)

                def call():
                    err = lib.srt_big_fft_frames(
                        wp.data_ptr(), op.data_ptr(), fe.dct.data_ptr(),
                        ceps.data_ptr(), r.data_ptr(), sc.data_ptr(), nf,
                        fe.frame_len, n, nmel, nac, nceps, fe.floor, chunk,
                        stream)
                    assert err == 0, err
                print(f"fft_ablation [{card}] four-step K5 {fs // 1000} kHz, "
                      f"fft_size {n}, {nf} frames (chunks of {chunk}, S "
                      f"{lib.srt_big_ranges(chunk, n // 2 + 1)}), "
                      f"{name:17s} {time_ms(call):.3f} ms; device ms a call "
                      f"by kernel {device_ms(call)}", flush=True)
                del sc
            del wp
            torch.cuda.empty_cache()


def bind_chirp(lib) -> None:
    """The argument types of csrc/frontend_chirp.cu's C interface (and of
    csrc/frontend_chirp_cluster.cu's where the library has it)."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.srt_chirp_frames_frontend.argtypes = [p_] * 8 + [i_] * 6 + [f_, p_]
    lib.srt_chirp_operator_shape.argtypes = [i_, i_, i_, ip, ip, ip]
    if hasattr(lib, "srt_chirp_cluster_frontend"):
        lib.srt_chirp_cluster_frontend.argtypes = ([p_] * 8 + [i_] * 6
                                                   + [f_, i_, p_])
        lib.srt_chirp_scratch_floats.argtypes = [i_] * 4
        lib.srt_chirp_scratch_floats.restype = ctypes.c_longlong


def chirp_main(card: str, dev, rng, variants=None) -> None:
    """The chirp-z kernel's stages at fft_size 1500 and 216 outputs."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    fe = FullFrontend(8000, FeatureConfig(mfcc=MfccConfig(
        fft_size=1500, n_filters=200)), dev)
    wp = frames_of(fe, 8000, 512, 5.0, rng, dev)
    nf = wp.shape[0]
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    ceps = torch.empty(nf, nceps, device=dev)
    r = torch.empty(nf, nac, device=dev)
    cz, bh = gpu_frontend.chirp_tables(1500, fe.frame_len, dev)
    variants = {k: CHIRP_ONE + v
                for k, v in (variants or CHIRP_VARIANTS).items()}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp, variants, CHIRP_SOURCES, ("frontend_chirp.cu",),
                     bind_chirp)
        print(f"fft_ablation [{card}]: K5's chirp-z kernel, 512 x 5 s @ "
              f"8 kHz, fft_size 1500, {nmel} mel + {nac} lags, {nf} frames, "
              "median of 7 trials of 3 calls", flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                op = gpu_frontend._fft_operator(
                    fe.mel, fe.acorr, 1500, lib, "srt_chirp_operator_shape",
                    fe.frame_len)

                def call():
                    err = lib.srt_chirp_frames_frontend(
                        wp.data_ptr(), cz.data_ptr(), bh.data_ptr(),
                        op.data_ptr(), fe.dct.data_ptr(), ceps.data_ptr(),
                        r.data_ptr(), 0, nf, fe.frame_len, 1500, nmel, nac,
                        nceps, fe.floor, stream)
                    assert err == 0, err
                print(f"round {rnd} {name:18s} {time_ms(call):.3f} ms",
                      flush=True)
    del wp
    chirp_cluster_main(card, dev, rng)
    chirp_passes_main(card, dev, rng)
    dense_main(card, dev, rng)


def chirp_cluster_main(card: str, dev, rng, variants=None) -> None:
    """The chirp-z route past M = 8192 (csrc/frontend_chirp_cluster.cu) at
    fft_size 16000 (M = 16384) and 50 mel + 16 lags on 64 x 5 s (phase
    15's), by stage, beside cuFFT's rfft of the same frames."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = 16000
    fe = FullFrontend(8000, FeatureConfig(mfcc=MfccConfig(fft_size=n)), dev)
    wp = frames_of(fe, 8000, 64, 5.0, rng, dev)
    nf, flen = wp.shape
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    ceps = torch.empty(nf, nceps, device=dev)
    r = torch.empty(nf, nac, device=dev)
    cz, _ = gpu_frontend.chirp_tables(n, flen, dev)
    bh = gpu_frontend.chirp_cluster_bh(n, flen, dev)
    variants = {k: CLUSTER_ONE + v
                for k, v in (variants or CHIRP_CLUSTER_VARIANTS).items()}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp, variants, CHIRP_CLUSTER_SOURCES,
                     ("frontend_chirp.cu", "frontend_chirp_cluster.cu",
                      "rfft_cluster.cu"), bind_chirp)
        sc = torch.empty(libs["full"].srt_chirp_scratch_floats(
            n, flen, nmel + nac, nf), device=dev)
        print(f"fft_ablation [{card}]: K5's chirp-z route on the cluster, "
              f"64 x 5 s @ 8 kHz, fft_size {n} (M "
              f"{gpu_frontend.chirp_size(n, flen)}), {nmel} mel + {nac} "
              f"lags, {nf} frames, median of 7 trials of 3 calls; cuFFT's "
              f"torch.fft.rfft(frames, n={n}) alone "
              f"{time_ms(lambda: torch.fft.rfft(wp, n=n)):.3f} ms",
              flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                op = gpu_frontend._fft_operator(
                    fe.mel, fe.acorr, n, lib, "srt_chirp_operator_shape",
                    flen)

                def call():
                    err = lib.srt_chirp_cluster_frontend(
                        wp.data_ptr(), cz.data_ptr(), bh.data_ptr(),
                        op.data_ptr(), fe.dct.data_ptr(), ceps.data_ptr(),
                        r.data_ptr(), sc.data_ptr(), nf, flen, n, nmel,
                        nac, nceps, fe.floor, nf, stream)
                    assert err == 0, err
                extra = (f"; device ms a call by kernel {device_ms(call)}"
                         if rnd == 0 and name == "full" else "")
                print(f"round {rnd} {name:18s} {time_ms(call):.3f} ms"
                      f"{extra}", flush=True)


def chirp_passes_main(card: str, dev, rng, variants=None) -> None:
    """The chirp-z route on the device-memory passes (csrc/
    frontend_chirp_cluster.cu past M = 131072) at fft_size 261634 (M =
    262144) on 2 x 5 s at 8 kHz (phase 15's), by stage, beside cuFFT's
    rfft of the same frames."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = DENSE_FFT
    fe = FullFrontend(8000, FeatureConfig(mfcc=MfccConfig(fft_size=n)), dev)
    wp = frames_of(fe, 8000, 2, 5.0, rng, dev)
    nf, flen = wp.shape
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    ceps = torch.empty(nf, nceps, device=dev)
    r = torch.empty(nf, nac, device=dev)
    cz, _ = gpu_frontend.chirp_tables(n, flen, dev)
    bh = gpu_frontend.chirp_cluster_bh(n, flen, dev)
    variants = {k: CLUSTER_ONE + v
                for k, v in (variants or CHIRP_PASSES_VARIANTS).items()}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp, variants, CHIRP_CLUSTER_SOURCES,
                     ("frontend_chirp.cu", "frontend_chirp_cluster.cu",
                      "rfft_cluster.cu"), bind_chirp)
        print(f"fft_ablation [{card}]: K5's chirp-z route on the passes, "
              f"2 x 5 s @ 8 kHz, fft_size {n} (M "
              f"{gpu_frontend.chirp_size(n, flen)}), {nmel} mel + {nac} "
              f"lags, {nf} frames (S "
              f"{libs['full'].srt_big_ranges(nf, n // 2 + 1)}"
              f"), median of 7 trials of 3 calls; cuFFT's "
              f"torch.fft.rfft(frames, n={n}) alone "
              f"{time_ms(lambda: torch.fft.rfft(wp, n=n)):.3f} ms",
              flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                op = gpu_frontend._fft_operator(
                    fe.mel, fe.acorr, n, lib, "srt_chirp_operator_shape",
                    flen)
                sc = torch.empty(lib.srt_chirp_scratch_floats(
                    n, flen, nmel + nac, nf), device=dev)

                def call():
                    err = lib.srt_chirp_cluster_frontend(
                        wp.data_ptr(), cz.data_ptr(), bh.data_ptr(),
                        op.data_ptr(), fe.dct.data_ptr(), ceps.data_ptr(),
                        r.data_ptr(), sc.data_ptr(), nf, flen, n, nmel,
                        nac, nceps, fe.floor, nf, stream)
                    assert err == 0, err
                extra = (f"; device ms a call by kernel {device_ms(call)}"
                         if rnd == 0 and name == "full" else "")
                print(f"round {rnd} {name:18s} {time_ms(call):.3f} ms"
                      f"{extra}", flush=True)
                del sc


# the dense template (csrc/frontend_frames.cu) without its DFT (the
# K-slices of frames, C and S and their FMAs) or its projection onto mel
# and autocorrelation
DENSE_VARIANTS = {
    "full": [],
    "no_dft": [
        ("frontend_frames.cu",
         "    stage_slice(stages, fr, C, S, nf, flen, ncols, 0, c0, cw, "
         "narrow, vf,\n                vo, tid);\n    cp_async_commit();\n"
         "    for (int s = 0; s < nk; ++s) {",
         "    for (int s = 0; s < 0; ++s) {")],
    "no_projection": [
        ("frontend_frames.cu", "    for (int oc = 0; oc < noc; ++oc) {",
         "    for (int oc = 0; oc < 0; ++oc) {")],
}
# fft_size past the cluster chirp's reach at 8 kHz (M = 262144), on 2 x 5 s
DENSE_FFT = 261634


def bind_dense(lib) -> None:
    """The argument types of csrc/frontend_frames.cu's C interface."""
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srt_frames_frontend.argtypes = [p_] * 9 + [i_] * 6 + [f_, p_]
    lib.srt_frames_scratch_floats.argtypes = [i_, i_]
    lib.srt_frames_scratch_floats.restype = ctypes.c_longlong


def dense_cs(flen: int, n: int, ncols: int, dev):
    """C and S [flen, ncols] of the dense template (ops/frontend.
    dft_power_projection, zero columns past n/2 + 1), f32 on dev."""
    return tuple(torch.from_numpy(np.pad(x, ((0, 0), (0, ncols - x.shape[1])))
                                  ).float().to(dev).contiguous()
                 for x in frontend_ops.dft_power_projection(flen, n))


def dense_main(card: str, dev, rng, variants=None) -> None:
    """The dense template at fft_size 261634 (8 kHz, 2 x 5 s: 2 flen (n/2
    + 1) FMAs a frame) by stage."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = DENSE_FFT
    fe = FullFrontend(8000, FeatureConfig(mfcc=MfccConfig(fft_size=n)), dev)
    wp = frames_of(fe, 8000, 2, 5.0, rng, dev)
    nf, flen = wp.shape
    nmel, nceps = fe.dct.shape
    nac = fe.acorr.shape[1]
    ncols = fe.mel.shape[0]
    C, S = dense_cs(flen, n, ncols, dev)
    ceps = torch.empty(nf, nceps, device=dev)
    r = torch.empty(nf, nac, device=dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp, variants or DENSE_VARIANTS, ("frontend_frames.cu",),
                     ("frontend_frames.cu",), bind_dense)
        sc = torch.empty(max(1, libs["full"].srt_frames_scratch_floats(
            nf, nmel + nac)), device=dev)
        print(f"fft_ablation [{card}]: the dense template, 2 x 5 s @ 8 kHz, "
              f"fft_size {n}, {nmel} mel + {nac} lags, {nf} frames, C and S "
              f"{tuple(C.shape)}, median of 5 trials of 1 call", flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                def call():
                    err = lib.srt_frames_frontend(
                        wp.data_ptr(), C.data_ptr(), S.data_ptr(),
                        fe.mel.data_ptr(), fe.acorr.data_ptr(),
                        fe.dct.data_ptr(), ceps.data_ptr(), r.data_ptr(),
                        sc.data_ptr(), nf, flen, ncols, nmel, nac, nceps,
                        fe.floor, stream)
                    assert err == 0, err
                print(f"round {rnd} {name:18s} {time_ms(call, 5, 1):.3f} ms",
                      flush=True)



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", default="tile",
                    help="comma-separated: tile, big, chirp, signals, lpcc")
    ap.add_argument("--csrc", default=None,
                    help="signals, lpcc: comma-separated source directories "
                    "to time in turns (default: the package's csrc/)")
    args = ap.parse_args(argv)
    routes = args.route.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("fft_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_name()
    rng = np.random.RandomState(0)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    for route in routes:
        if route in ("signals", "lpcc"):
            {"signals": signals_main, "lpcc": lpcc_main}[route](
                card, dev, rng, csrcs=args.csrc and [
                    os.path.abspath(c) for c in args.csrc.split(",")])
            continue
        {"tile": tile_main, "big": big_main, "chirp": chirp_main}[route](
            card, dev, rng)


if __name__ == "__main__":
    main()
