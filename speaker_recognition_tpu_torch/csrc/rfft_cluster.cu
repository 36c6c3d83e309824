// The four-step route's spectral stage (csrc/rfft_big.cuh), for Hopper
// (sm_90a): K1, K4, K5 and the monolith K6 at N >= 32768 points call
// srt_cluster::spectra with their frames' loader (srt_cluster::
// FrameSource). Up to N = 262144 a frame's spectrum on a block or a
// thread-block cluster (csrc/rfft_cluster.cuh), past it the column and row
// passes of csrc/rfft_passes.cuh over a device scratch: a route chosen on N
// in the open (ops/gpu_frontend counts the passes in BIG_PASSES_LAUNCHES);
// both leave power rows, and the fused projection pass (split over the
// bins at few frames) reads them, which the chirp-z route past M = 8192
// takes too (project_rows). A file of its own, so that the route's kernels
// build once for every loader and beside the frontends' instantiations.

#include <cuda_runtime.h>

#include "rfft_big.cuh"
#include "rfft_cluster.cuh"
#include "rfft_passes.cuh"

namespace {

using srt_cluster::FrameSource;
using srt_cluster::NTH;
using srt_cluster::P;

// Cluster i (C blocks) takes frame f0 + i: rank c loads z[C p + c] (p <
// E_c, the pruned first pass) and takes its P-point FFT; after the
// cluster's barrier unit u in [0, P/2] reads slots u and P - u of every
// rank and writes the power of bins u + P k2 and P - u + P k2 (k2 < C; u =
// 0: bins P k2 and H; u = P/2: bins P/2 + P k2) into row i of pw
// [.][pstride], floored per bin when asked.
template <int C>
__global__ void __launch_bounds__(NTH, 1) spectrum_kernel(
    const FrameSource src, int f0, float* __restrict__ pw, int pstride,
    int lgn, float power_floor, int per_bin_floor) {
  extern __shared__ float2 cl_smem[];
  float2* v = cl_smem;
  const int fl = blockIdx.x / C, g = f0 + fl, rank = cfft::rank<C>();
  if (!src.live(g)) return;  // uniform over the cluster
  const int H = 1 << (lgn - 1);
  const cfft::Twiddles tw =
      cfft::twiddles(cl_smem + srt_cluster::SLOTS, lgn - 1);
  const int J = (src.extent() + 1) / 2;
  const int E = J > rank ? min(P, (J - rank + C - 1) / C) : 0;
  // 1. the block's FFT (the first pass's barrier publishes the twiddles)
  cfft::first_pass(v, E, [&](int p) {
    const int j = 2 * (C * p + rank);
    return make_float2(src.sample(g, j), src.sample(g, j + 1));
  });
  cfft::later_passes(v, tw, C);
  cfft::cluster_sync<C>();
  // 2. the exchange: X[k1 + P k2] of columns u and P - u, and the power
  float2* rv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) rv[c] = cfft::rank_slots<C>(v, c);
  float* row = pw + (size_t)fl * pstride;
  const auto column = [&](int k1, float2 (&x)[C]) {
    const int s = cfft::slot(k1);
#pragma unroll
    for (int c = 0; c < C; ++c)
      x[c] = c == 0 ? rv[0][s] : cfft::cmul(rv[c][s], tw(c * k1));
    cfft::dft<C>(x);
  };
  const auto store = [&](int k, float p) {
    row[k] = per_bin_floor ? fmaxf(p, power_floor) : p;
  };
  // |X[k]|^2 of the N-point real input from Z[k] = a and Z[H - k] = b
  const auto post = [&](int k, float2 a, float2 b) {
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    float s, cs;
    sincospif((float)k / (float)H, &s, &cs);  // W_N^k
    const float2 wo = cfft::cmul(make_float2(cs, -s), o);
    const float xr = e.x + wo.x, xi = e.y + wo.y;
    store(k, xr * xr + xi * xi);
  };
  for (int u = rank * NTH + (int)threadIdx.x; u <= P / 2; u += C * NTH) {
    float2 x[C];
    column(u, x);
    if (u == 0) {
      const float e0 = x[0].x + x[0].y, eh = x[0].x - x[0].y;
      store(0, e0 * e0);
      store(H, eh * eh);
#pragma unroll
      for (int k2 = 1; k2 < C; ++k2) post(P * k2, x[k2], x[C - k2]);
    } else if (u == P / 2) {
#pragma unroll
      for (int k2 = 0; k2 < C; ++k2)
        post(u + P * k2, x[k2], x[C - 1 - k2]);
    } else {
      float2 y[C];
      column(P - u, y);
#pragma unroll
      for (int k2 = 0; k2 < C; ++k2) {
        post(u + P * k2, x[k2], y[C - 1 - k2]);
        post(P - u + P * k2, y[k2], x[C - 1 - k2]);
      }
    }
  }
  cfft::cluster_sync<C>();  // no rank leaves while others read its slots
}

// Past the cluster's reach: the column and row passes of csrc/
// rfft_passes.cuh over the H = N/2 point transform of frames f0 .. f0 + nfc
// - 1, a group of frames at a time through the same matrices, into their
// power rows pw [nfc][pstride]; a short frame's row pass loads straight
// from the frame, and no column pass (and no matrix) runs: then all the
// frames go through in one launch.
cudaError_t device_passes(const FrameSource& fr, int f0, int nfc, int n,
                          float2* z, float* pw, int pstride,
                          float power_floor, bool per_bin_floor,
                          cudaStream_t st) {
  const int lgt = srt_cluster::ilog2(n) - 1, lg2 = passes::lg_t2(lgt);
  const bool direct = passes::RealIn{fr, 0}.count() <= 1 << lg2;
  const int group = direct ? nfc : passes::group_frames(lgt);
  for (int g0 = 0; g0 < nfc; g0 += group) {
    const int ng = min(group, nfc - g0);
    const passes::RealIn in{fr, f0 + g0};
    cudaError_t err =
        direct ? cudaSuccess
               : passes::columns(in, passes::TwiddledOut{z, lgt}, ng, lgt,
                                 st);
    if (err != cudaSuccess) return err;
    err = passes::with_lg(lg2, [&](auto c) {
      constexpr int LG2 = decltype(c)::value;
      return passes::launch(passes::power_rows_kernel<LG2>,
                            (1 << (lgt - LG2)) / (P >> LG2), ng, lgt, st, in,
                            (const float2*)z, pw + (size_t)g0 * pstride,
                            pstride, lgt, power_floor, per_bin_floor ? 1 : 0,
                            direct ? 1 : 0);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

namespace srt_cluster {

cudaError_t spectra(FrameSource src, int f0, int nfc, int n, float* scratch,
                    const float4* op, int nmel, int nac, float power_floor,
                    bool per_bin_floor, cudaStream_t st) {
  if (!rfft_big::takes(n) || nfc < 1 || nfc > 65535)
    return cudaErrorInvalidValue;
  src.n = n;
  const int lgn = ilog2(n), H = n / 2;
  const int ps = rfft_big::power_stride(H + 1), nout = nmel + nac;
  float* pw = rfft_big::power_rows(scratch, n, nfc);
  cudaError_t err;
  if (takes(n)) {
    err = cfft::with_ranks(H / P, [&](auto rc) {
      constexpr int C = decltype(rc)::value;
      return cfft::launch<C>(spectrum_kernel<C>, nfc, smem_bytes(lgn - 1), st,
                             src, f0, pw, ps, lgn, power_floor,
                             per_bin_floor ? 1 : 0);
    });
  } else {
    err = device_passes(src, f0, nfc, n, reinterpret_cast<float2*>(scratch),
                        pw, ps, power_floor, per_bin_floor, st);
  }
  if (err != cudaSuccess) return err;
  return rfft_big::project(src, f0, nfc, pw, ps, H + 1, op,
                           rfft_big::sums_rows(scratch, n, nfc),
                           rfft_big::partial_rows(scratch, n, nout, nfc),
                           nmel, nac, power_floor, st);
}

cudaError_t project_rows(int nfc, const float* pw, int pstride, int nbins,
                         const float4* op, float* sums, float* partial,
                         int nmel, int nac, float power_floor,
                         cudaStream_t st) {
  FrameSource all{};  // every frame computed
  all.kind = FrameSource::ROWS;
  return rfft_big::project(all, 0, nfc, pw, pstride, nbins, op, sums,
                           partial, nmel, nac, power_floor, st);
}

}  // namespace srt_cluster
