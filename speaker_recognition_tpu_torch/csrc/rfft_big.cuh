// The spectral stage of the frontends (K1, K4, K5) at an FFT of N >= 32768
// points, where one frame's H = N/2 complex values (128 KB at N = 32768)
// no longer fit the FFT tile of csrc/rfft_tile.cuh beside its power rows:
// a route chosen on N in the open, with its own counters, not a fallback.
//
// A four-step FFT over a scratch in device memory, a chunk of frames at a
// time. With z[j] = x[2j] + i x[2j+1] (j < H) and H = H1 H2 (H1 >= H2,
// both powers of two of at most MAX_L points):
//   1. columns: per frame and n2 < H2, the H1-point FFT over n1 of
//      z[H2 n1 + n2] in shared memory (the samples from the caller's
//      frame loader: window, pre-emphasis and the fold of samples past N
//      happen there), times the twiddle W_H^(n2 k1), into row k1 of the
//      frame's scratch [H1][H2];
//   2. rows: per frame and k1, the H2-point FFT of row k1 in place, which
//      leaves Z[k1 + H1 k2] at [k1][k2];
//   3. power: the real-input post-step of the tile, |X[k]|^2 of bins
//      0..H from Z[k] and Z[H-k], floored per bin when asked, into power
//      rows [H + 1];
//   4. projection: per frame and output, the power row against the mel
//      or autocorrelation column over the bins in order, then
//      log(max(mel, floor)), into sums rows [nout] of log-mel | raw
//      autocorrelation: the layout the tile's epilogues read (tile_features,
//      frame_outputs) with a row stride of nout.
// Twiddles come from sincospif of exact angles (the indices stay below
// 2^24), as on the tile; no fast intrinsics. Every sum runs in a fixed
// order with no atomics, so two calls give the same bits.
//
// What bounds it: the least work is FLOPs (2.5 N log2 N for the FFT and
// two per nonzero of the operators) or the frames' bytes. This route is
// the simple one: each sub-FFT reads and writes device memory once (the
// column pass with strided loads), and the projection is dense over every
// bin and output, which at N = 32768 is most of its time. Making it fast
// (a cluster holding a frame in distributed shared memory, the tile's
// sparse projection) is later work.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rfft_tile.cuh"

namespace {
namespace rfft_big {

constexpr int MIN_N = 32768;
constexpr int MAX_N = 1 << 24;  // twiddle indices below 2^24 stay exact
constexpr int MAX_L = 8192;     // complex points of a sub-FFT (64 KB)
constexpr int FFT_THREADS = 256;

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// log2 of H2, the shorter factor of H = N/2
__host__ __device__ constexpr int lg2(int n) { return ilog2(n / 2) / 2; }

// whether the route takes an N-point FFT
inline bool takes(int n) {
  return n >= MIN_N && n <= MAX_N && (n & (n - 1)) == 0;
}

// floats of scratch for nfc frames at an N-point FFT with nout outputs:
// the frames' complex values [nfc][H] (float2), power rows [nfc][H + 1]
// and sums rows [nfc][nout]
inline long long scratch_floats(int n, int nout, int nfc) {
  return (long long)nfc * (n + n / 2 + 1 + nout);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-pi i j / m) for 0 <= j < 2m, j and m below 2^24
__device__ __forceinline__ float2 w_pi(int j, int m) {
  float s, c;
  sincospif((float)j / (float)m, &s, &c);
  return make_float2(c, -s);
}

// The radix-2 FFT of the 2^lg complex values in v (shared memory), given
// in bit-reversed order, in place; the block's threads share the
// butterflies of each stage. Starts and ends on a barrier.
__device__ __forceinline__ void smem_fft(float2* v, int lg) {
  const int half = 1 << (lg - 1);
  for (int s = 0; s < lg; ++s) {
    const int m = 1 << s;
    __syncthreads();
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i & (m - 1);
      const int a = ((i >> s) << (s + 1)) + j;
      const float2 t = cmul(w_pi(j, m), v[a + m]), u = v[a];
      v[a] = make_float2(u.x + t.x, u.y + t.y);
      v[a + m] = make_float2(u.x - t.x, u.y - t.y);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int brev(int x, int lg) {
  return lg == 0 ? 0 : (int)(__brev((unsigned)x) >> (32 - lg));
}

// 1. Block (n2, frame fl of the chunk): the H1-point FFT over n1 of
// z[H2 n1 + n2] of frame f0 + fl, times W_H^(n2 k1), into z rows [H1][H2].
// Frames::frame(f) gives the frame's sample loader (p -> sample p < N,
// folded), Frames::live(f) whether the frame is computed at all.
template <class Frames>
__global__ void __launch_bounds__(FFT_THREADS) columns_kernel(
    const Frames fr, int f0, float2* __restrict__ z, int lgn) {
  extern __shared__ float2 v[];
  const int f = f0 + blockIdx.y;
  if (!fr.live(f)) return;  // block-uniform
  const int lg2_ = lg2(1 << lgn), lg1 = lgn - 1 - lg2_;
  const int H = 1 << (lgn - 1), H1 = 1 << lg1, H2 = 1 << lg2_;
  const int n2 = blockIdx.x;
  const auto x = fr.frame(f);
  for (int n1 = threadIdx.x; n1 < H1; n1 += blockDim.x) {
    const int p = 2 * (H2 * n1 + n2);
    v[brev(n1, lg1)] = make_float2(x(p), x(p + 1));
  }
  smem_fft(v, lg1);
  float2* row = z + (size_t)blockIdx.y * H;
  for (int k1 = threadIdx.x; k1 < H1; k1 += blockDim.x) {
    // W_H^e = exp(-pi i e / (H/2)), e = n2 k1 < H
    row[(size_t)k1 * H2 + n2] = cmul(w_pi(n2 * k1, H / 2), v[k1]);
  }
}

// 2. Block (k1, frame fl): the H2-point FFT of row k1, in place.
template <class Frames>
__global__ void __launch_bounds__(FFT_THREADS) rows_kernel(
    const Frames fr, int f0, float2* __restrict__ z, int lgn) {
  extern __shared__ float2 v[];
  if (!fr.live(f0 + blockIdx.y)) return;
  const int lg2_ = lg2(1 << lgn);
  const int H = 1 << (lgn - 1), H2 = 1 << lg2_;
  float2* row = z + (size_t)blockIdx.y * H + (size_t)blockIdx.x * H2;
  for (int k2 = threadIdx.x; k2 < H2; k2 += blockDim.x)
    v[brev(k2, lg2_)] = row[k2];
  smem_fft(v, lg2_);
  for (int k2 = threadIdx.x; k2 < H2; k2 += blockDim.x) row[k2] = v[k2];
}

// 3. Thread (bin k, frame fl): the power of bin k <= H into pw [nfc][H+1].
template <class Frames>
__global__ void power_kernel(const Frames fr, int f0,
                             const float2* __restrict__ z,
                             float* __restrict__ pw, int lgn,
                             float power_floor, int per_bin_floor) {
  if (!fr.live(f0 + blockIdx.y)) return;
  const int lg2_ = lg2(1 << lgn), lg1 = lgn - 1 - lg2_;
  const int H = 1 << (lgn - 1), H1 = 1 << lg1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > H) return;
  const float2* zr = z + (size_t)blockIdx.y * H;
  // Z[k] lives at [k mod H1][k / H1]
  const auto Z = [&](int i) { return zr[((i & (H1 - 1)) << lg2_) + (i >> lg1)]; };
  float p;
  if (k == 0 || k == H) {
    const float2 z0 = Z(0);
    const float x = k == 0 ? z0.x + z0.y : z0.x - z0.y;
    p = x * x;
  } else {
    const float2 a = Z(k), b = Z(H - k);
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    const float2 wo = cmul(w_pi(k, H), o);  // W_N^k
    const float xr = e.x + wo.x, xi = e.y + wo.y;
    p = xr * xr + xi * xi;
  }
  if (per_bin_floor) p = fmaxf(p, power_floor);
  pw[(size_t)blockIdx.y * (H + 1) + k] = p;
}

// 4. Thread (output o, frame fl): sums [nfc][nout] = log(max(pw . mel,
// floor)) | pw . acorr, the bins in order. mel [>= H+1][nmel] and acorr
// [>= H+1][nac] row-major.
template <class Frames>
__global__ void __launch_bounds__(256) project_kernel(
    const Frames fr, int f0, int nfc, const float* __restrict__ pw,
    const float* __restrict__ mel, const float* __restrict__ ac,
    float* __restrict__ sums, int lgn, int nmel, int nac,
    float power_floor) {
  const int o = blockIdx.x * 32 + threadIdx.x;
  const int fl = blockIdx.y * 8 + threadIdx.y;
  const int nout = nmel + nac;
  if (fl >= nfc || o >= nout || !fr.live(f0 + fl)) return;
  const int nb = (1 << (lgn - 1)) + 1;
  const float* p = pw + (size_t)fl * nb;
  const bool is_mel = o < nmel;
  const float* w = is_mel ? mel + o : ac + (o - nmel);
  const int ws = is_mel ? nmel : nac;
  float acc = 0.f;
  for (int k = 0; k < nb; ++k) acc = fmaf(p[k], w[(size_t)k * ws], acc);
  sums[(size_t)fl * nout + o] =
      is_mel ? logf(fmaxf(acc, power_floor)) : acc;
}

// Steps 1-4 for frames f0 .. f0 + nfc - 1 on `st`; the sums rows [nfc][nout]
// land at scratch + nfc * (N + H + 1). scratch holds scratch_floats(n,
// nout, nfc) floats.
template <class Frames>
cudaError_t spectra(const Frames& fr, int f0, int nfc, int n, float* scratch,
                    const float* mel, int nmel, const float* ac, int nac,
                    float power_floor, bool per_bin_floor, cudaStream_t st) {
  const int lgn = ilog2(n), lg2_ = lg2(n), lg1 = lgn - 1 - lg2_;
  const int H = n / 2;
  if ((1 << lg1) > MAX_L || nfc > 65535) return cudaErrorInvalidValue;
  float2* z = reinterpret_cast<float2*>(scratch);
  float* pw = scratch + (size_t)nfc * n;
  float* sums = pw + (size_t)nfc * (H + 1);
  const auto fft_threads = [](int lg) {
    return lg - 1 >= 8 ? FFT_THREADS : 1 << (lg - 1);
  };
  const size_t smem1 = sizeof(float2) << lg1, smem2 = sizeof(float2) << lg2_;
  cudaError_t err = cudaFuncSetAttribute(
      columns_kernel<Frames>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows_kernel<Frames>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  columns_kernel<Frames><<<dim3(1 << lg2_, nfc), fft_threads(lg1), smem1,
                           st>>>(fr, f0, z, lgn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rows_kernel<Frames><<<dim3(1 << lg1, nfc), fft_threads(lg2_), smem2, st>>>(
      fr, f0, z, lgn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  power_kernel<Frames><<<dim3((H + 1 + 255) / 256, nfc), 256, 0, st>>>(
      fr, f0, z, pw, lgn, power_floor, per_bin_floor ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  project_kernel<Frames>
      <<<dim3((nmel + nac + 31) / 32, (nfc + 7) / 8), dim3(32, 8), 0, st>>>(
          fr, f0, nfc, pw, mel, ac, sums, lgn, nmel, nac, power_floor);
  return cudaGetLastError();
}

// where spectra leaves the sums rows of a chunk of nfc frames
inline float* sums_rows(float* scratch, int n, int nfc) {
  return scratch + (size_t)nfc * (n + n / 2 + 1);
}

// The frame-level epilogue (K5, K4) of a chunk: block i takes frames
// 8 i .. 8 i + 7 of it (rfft::frame_outputs on sums rows of nout floats).
__global__ void __launch_bounds__(128) outputs_kernel(
    const float* __restrict__ sums, const float* __restrict__ dct,
    float* __restrict__ ceps, float* __restrict__ r, int f0, int nfc,
    int nmel, int nac, int nceps) {
  const int fb = blockIdx.x * 8, nout = nmel + nac;
  rfft::frame_outputs<512, 128>(sums + (size_t)fb * nout, dct, ceps, r,
                                f0 + fb, min(8, nfc - fb), nmel, nac, nceps,
                                nout);
}

// The frame-level kernels' route (K5, K4): n frames in chunks of `chunk`,
// spectra then outputs_kernel, into ceps [n, nceps] and r [n, nac].
template <class Frames>
cudaError_t frame_level(const Frames& fr, int n, int chunk, int nfft,
                        float* scratch, const float* mel, const float* ac,
                        const float* dct, float* ceps, float* r, int nmel,
                        int nac, int nceps, float power_floor,
                        bool per_bin_floor, cudaStream_t st) {
  if (!takes(nfft) || chunk < 1 || chunk > 65535)
    return cudaErrorInvalidValue;
  for (int f0 = 0; f0 < n; f0 += chunk) {
    const int nfc = min(chunk, n - f0);
    cudaError_t err = spectra(fr, f0, nfc, nfft, scratch, mel, nmel, ac, nac,
                              power_floor, per_bin_floor, st);
    if (err != cudaSuccess) return err;
    outputs_kernel<<<(nfc + 7) / 8, 128, 0, st>>>(
        sums_rows(scratch, nfft, nfc), dct, ceps, r, f0, nfc, nmel, nac,
        nceps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace rfft_big
}  // namespace
