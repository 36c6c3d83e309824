// The signal frontend's pieces on the route of N >= 32768 (csrc/
// rfft_big.cuh), shared by K1 (csrc/frontend.cu) and the fused predict
// monolith's route there (csrc/predict_fused_big.cu): the frames of a
// padded batch as the four-step route's loader takes them, and the
// features of a chunk of frames from the route's sums rows.

#pragma once

#include <cuda_runtime.h>

#include "packed_tile.cuh"
#include "rfft_cluster.cuh"
#include "rfft_tile.cuh"

namespace {

// The frames of the signal frontend on the route of N >= 32768: frame
// g = b T + t of the padded batch signals [B][Lp], the strided window of the
// signal, windowed and pre-emphasized per sample as on the tile
// (rfft::SignalFrames); frames at or past n_valid[b] are not computed.
inline srt_cluster::FrameSource signal_frames(const float* sig,
                                              const int* nv,
                                              const float* win, int Lp,
                                              int T, int fshift, int flen,
                                              float a, int preemph_first) {
  srt_cluster::FrameSource s{};
  s.kind = srt_cluster::FrameSource::SIGNAL;
  s.x = sig;
  s.win = win;
  s.nv = nv;
  s.flen = flen;
  s.Lp = Lp;
  s.T = T;
  s.fshift = fshift;
  s.a = a;
  s.preemph_first = preemph_first;
  return s;
}

// The signal frontend's features of frames g0 .. g0 + gridDim.x - 1 from
// the route's sums rows [.][nout] (tile_features, one frame a block), into
// feat [B * T][feature_width]; zeros at frames past n_valid.
__global__ void __launch_bounds__(128) big_features_kernel(
    const float* __restrict__ sums, const int* __restrict__ n_valid,
    const float* __restrict__ dct, float* __restrict__ feat, int T, int g0,
    int nmel, int nac, int nceps, int fuse_lpc) {
  const int g = g0 + blockIdx.x, b = g / T, t = g % T;
  const int nout = nmel + nac;
  tile_features<64, 128>(sums + (size_t)blockIdx.x * nout,
                         feat + (size_t)g * feature_width(nceps, nac,
                                                          fuse_lpc),
                         1, n_valid[b] - t, dct, nmel, nac, nceps,
                         fuse_lpc != 0, nout);
}

}  // namespace
