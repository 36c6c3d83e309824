// The four-step route's spectral stage (csrc/rfft_big.cuh), for Hopper
// (sm_90a): K1, K4, K5 and the monolith K6 at N >= 32768 points call
// srt_cluster::spectra with their frames' loader (srt_cluster::
// FrameSource). Up to N = 262144 a frame's spectrum on a block or a
// thread-block cluster (csrc/rfft_cluster.cuh), past it the column and row
// passes over a device scratch: a route chosen on N in the open
// (ops/gpu_frontend counts the passes in BIG_PASSES_LAUNCHES); then the
// fused projection pass, which the chirp-z route past M = 8192 takes too
// (project_rows). A file of its own, so that the route's kernels build
// once for every loader and beside the frontends' instantiations.

#include <cuda_runtime.h>

#include "rfft_big.cuh"
#include "rfft_cluster.cuh"

namespace {

using srt_cluster::FrameSource;
using srt_cluster::NTH;
using srt_cluster::P;

// Cluster i (C blocks) takes frame f0 + i: rank c loads z[C p + c] (p <
// E_c, the pruned first pass) and takes its P-point FFT; after the
// cluster's barrier unit u in [0, P/2] reads slots u and P - u of every
// rank and writes the power of bins u + P k2 and P - u + P k2 (k2 < C; u =
// 0: bins P k2 and H; u = P/2: bins P/2 + P k2) into row i of pw [.][n],
// floored per bin when asked.
template <int C>
__global__ void __launch_bounds__(NTH, 1) spectrum_kernel(
    const FrameSource src, int f0, float* __restrict__ pw, int lgn,
    float power_floor, int per_bin_floor) {
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
  float* row = pw + ((size_t)fl << lgn);
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

// Past the cluster's reach: steps 1-3 of csrc/rfft_big.cuh, the column and
// row passes over z [nfc][H] in scratch, then the fused pass from Z.
cudaError_t passes(const FrameSource& fr, int f0, int nfc, int n,
                   float* scratch, const float4* op, int nmel, int nac,
                   float power_floor, bool per_bin_floor, cudaStream_t st) {
  using namespace rfft_big;
  const int lgn = ilog2(n), lg2_ = lg2(n), lg1 = lgn - 1 - lg2_;
  if ((1 << lg1) > MAX_L) return cudaErrorInvalidValue;
  float2* z = reinterpret_cast<float2*>(scratch);
  const auto fft_threads = [](int lg) {
    return lg - 1 >= 8 ? FFT_THREADS : 1 << (lg - 1);
  };
  const size_t smem1 = sizeof(float2) << lg1, smem2 = sizeof(float2) << lg2_;
  cudaError_t err = cudaFuncSetAttribute(
      columns_kernel<FrameSource>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows_kernel<FrameSource>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  columns_kernel<FrameSource><<<dim3(1 << lg2_, nfc), fft_threads(lg1),
                                smem1, st>>>(fr, f0, z, lgn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rows_kernel<FrameSource><<<dim3(1 << lg1, nfc), fft_threads(lg2_), smem2,
                             st>>>(fr, f0, z, lgn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return project<false>(fr, f0, nfc, z, nullptr, 0, (n >> 1) + 1, op,
                        sums_rows(scratch, n, nfc), lgn, nmel, nac,
                        power_floor, per_bin_floor, st);
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
  if (!takes(n)) return passes(src, f0, nfc, n, scratch, op, nmel, nac,
                               power_floor, per_bin_floor, st);
  cudaError_t err = cfft::with_ranks(H / P, [&](auto rc) {
    constexpr int C = decltype(rc)::value;
    return cfft::launch<C>(spectrum_kernel<C>, nfc, smem_bytes(lgn - 1), st,
                           src, f0, scratch, lgn, power_floor,
                           per_bin_floor ? 1 : 0);
  });
  if (err != cudaSuccess) return err;
  return rfft_big::project<true>(
      src, f0, nfc, nullptr, scratch, n, H + 1, op,
      rfft_big::sums_rows(scratch, n, nfc), lgn, nmel, nac, power_floor,
      per_bin_floor, st);
}

cudaError_t project_rows(int nfc, const float* pw, int pstride, int nbins,
                         const float4* op, float* sums, int nmel, int nac,
                         float power_floor, cudaStream_t st) {
  // every frame computed; lgn only sizes the device-memory passes' stage
  FrameSource all{};
  all.kind = FrameSource::ROWS;
  return rfft_big::project<true>(all, 0, nfc, nullptr, pw, pstride, nbins,
                                 op, sums, rfft_big::MIN_LGN, nmel, nac,
                                 power_floor, false, st);
}

}  // namespace srt_cluster
