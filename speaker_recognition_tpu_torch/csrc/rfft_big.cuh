// The spectral stage of the frontends (K1, K4, K5 and the monolith K6) at
// an FFT of N >= 32768 points, where one frame's H = N/2 complex values
// (128 KB at N = 32768) no longer fit the FFT tile of csrc/rfft_tile.cuh
// beside its power rows: a route chosen on N in the open, with its own
// counters, not a fallback. With z[j] = x[2j] + i x[2j+1] (j < H):
//   * up to N = 262144 (srt_cluster::takes) a frame's spectrum stays on
//     chip: the cluster FFT of csrc/rfft_cluster.cuh (one block of 16384
//     values at N = 32768, a thread-block cluster of 2, 4 or 8 blocks past
//     it, the transpose an exchange in distributed shared memory) writes
//     the frame's power row |X[k]|^2 (k <= H, the real-input post-step on
//     chip) once, and the fused pass (3. below, ROWS) projects it;
//   * past it, up to MAX_N, a four-step FFT over a scratch in device
//     memory, a chunk of frames at a time, with H = H1 H2 (H1 >= H2, both
//     powers of two of at most MAX_L points):
//   1. columns: per frame and n2 < H2, the H1-point FFT over n1 of
//      z[H2 n1 + n2] in shared memory (the samples from the caller's
//      frame loader: window, pre-emphasis and the fold of samples past N
//      happen there), times the twiddle W_H^(n2 k1), into row k1 of the
//      frame's scratch [H1][H2];
//   2. rows: per frame and k1, the H2-point FFT of row k1 in place, which
//      leaves Z[k1 + H1 k2] at [k1][k2];
//   3. power and projection, one fused pass (power_project_kernel): a
//      block of PFT frames walks the bins in order, stages the power
//      |X[k]|^2 of a few columns' bins at a time from Z[k] and Z[H-k] (the
//      real-input post-step of the tile, floored per bin when asked; or
//      the cluster's power rows) in shared memory, and projects it onto the
//      packed [mel | acorr | 0] operator with the FFT tile's walk
//      (rfft::project_bins: the operator staged in chunks, all-zero
//      4-column groups skipped, each output summed over the bins in order
//      in registers), then log(max(mel, floor)), into sums rows [nout] of
//      log-mel | raw autocorrelation: the layout the tile's epilogues read
//      (tile_features, frame_outputs) with a row stride of nout. The
//      chirp-z route past M = 8192 (csrc/frontend_chirp_cluster.cu) takes
//      the same pass on its power rows.
// Twiddles come from sincospif of exact angles (the indices stay below
// 2^24), as on the tile; no fast intrinsics. Every sum runs in a fixed
// order with no atomics, so two calls give the same bits.
//
// What bounds it: the least work is FLOPs (2.5 N log2 N for the FFT and
// two per nonzero of the operators) or the frames' bytes. On the
// device-memory passes each sub-FFT reads and writes device memory once
// (the column pass with strided stores: ~0.9 MB a frame at N = 32768); the
// cluster route moves a frame's samples and its power row (64 KB at N =
// 32768) and nothing else. The fused pass reads its power once in whole
// sectors and the operator once per block of PFT frames; its walk is
// latency-bound a block, so min_blocks keeps three blocks an SM.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rfft_cluster.cuh"
#include "rfft_tile.cuh"

namespace {
namespace rfft_big {

constexpr int MIN_N = 32768, MIN_LGN = 15;
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
// the frames' complex values [nfc][H] (float2) and sums rows [nfc][nout]
inline long long scratch_floats(int n, int nout, int nfc) {
  return (long long)nfc * (n + nout);
}

// The fused power + projection pass (power_project_kernel): PFT frames a
// block of PWARPS warps; the operator staged in chunks of ck(OPL) bins (as
// many as 32 KB hold, at most 64), the power in stages of stage_bins(lgn)
// bins (four columns of the [H1][H2] rows, at most PK_MAX) after the
// device-memory passes, of ROW_BINS bins from the cluster routes' rows.
constexpr int PFT = 8, PWARPS = 8, PNTH = 32 * PWARPS, PK_MAX = 2048;
constexpr int ROW_BINS = 512;

__host__ __device__ constexpr int ck(int opl) {
  return opl <= 16 ? 64 : opl <= 32 ? 32 : 16;
}

__host__ __device__ constexpr int stage_bins(int lgn) {
  return (4 << (lgn - 1 - (lgn - 1) / 2)) < PK_MAX
             ? 4 << (lgn - 1 - (lgn - 1) / 2) : PK_MAX;
}

// rows of the packed operator an output chunk: bins 0..nbins - 1 (H + 1
// on the four-step route, N/2 + 1 on the chirp's), zero rows to a multiple
// of ck(opl)
__host__ __device__ constexpr int op_rows(int nbins, int opl) {
  return (nbins + ck(opl) - 1) / ck(opl) * ck(opl);
}

// blocks of the fused pass an SM must hold at once: three at up to 72
// outputs (85 registers a thread), so that 8 x 5 s at 48 kHz (311 blocks)
// runs in one wave on 132 SMs; the wider operators' sums need more
// registers
__host__ __device__ constexpr int min_blocks(int opl) {
  return opl <= 9 ? 3 : 1;
}

// floats of the fused pass's shared memory: the operator chunk, the power
// stage of pk bins
__host__ __device__ constexpr int project_floats(int pk, int opl) {
  return ck(opl) * rfft::nop(opl) + PFT * (pk + 1);
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
// Frames (srt_cluster::FrameSource): frame(f) gives the frame's sample
// loader (p -> sample p < N, folded), live(f) whether the frame is
// computed at all.
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

// 3. Block i: frames PFT i .. PFT i + PFT - 1 of the chunk, the power of
// bins 0..nbins - 1 and its projection onto the packed operator op ([mel |
// acorr | 0] rows, op_rows(nbins, opl) of them an output chunk) by
// rfft::project_bins, then log(max(mel, floor)) | autocorrelation into
// sums rows [nfc][nout]. project_bins walks the bins in order in chunks of
// CK; at every PK-th bin its fill stages the power of the next PK bins of
// the block's frames in ys [PFT][PK + 1]:
//   * ROWS (the cluster routes, csrc/rfft_cluster.cuh): from the power rows
//     pw [nfc][pstride] the spectrum kernel wrote, consecutive threads on
//     consecutive bins (PK = ROW_BINS);
//   * else (the device-memory passes, nbins = H + 1): from Z[k] and Z[H - k]
//     with the post-step arithmetic of the tile. Z[k] lives at [k mod
//     H1][k / H1], so bins k0 .. k0 + PK - 1 are PK / H1 columns of the
//     [H1][H2] rows: consecutive threads read consecutive columns of a row
//     (whole 32-byte sectors when PK / H1 >= 4).
// Frames past nfc, and frames the loader does not compute, take zero power
// and leave no sums.
template <class Frames, int OPL, bool ROWS>
__global__ void __launch_bounds__(PNTH, min_blocks(OPL)) power_project_kernel(
    const Frames fr, int f0, int nfc, const float2* __restrict__ z,
    const float* __restrict__ pw, int pstride, int nbins,
    const float4* __restrict__ op, float* __restrict__ sums, int lgn,
    int nmel, int nac, float power_floor, int per_bin_floor) {
  constexpr int CK = ck(OPL), NOP = rfft::nop(OPL), NG = NOP / 4;
  constexpr int GPW = rfft::proj_gpw(PFT, PWARPS, OPL), LPF = 32 / PFT;
  extern __shared__ float4 smem4[];
  float* opc = reinterpret_cast<float*>(smem4);  // [CK][NOP]
  float* ys = opc + CK * NOP;                    // [PFT][pk + 1]
  const int lg2_ = lg2(1 << lgn), lg1 = lgn - 1 - lg2_;
  const int H = 1 << (lgn - 1), H1 = 1 << lg1;
  const int pk = ROWS ? ROW_BINS : stage_bins(lgn);
  const int ys_stride = pk + 1;
  const int cols = pk > H1 ? pk / H1 : 1, lcols = ilog2(cols);
  const int fb = blockIdx.x * PFT, nout = nmel + nac;
  const int tid = threadIdx.x, warp = tid / 32;
  unsigned live = 0;  // frames of the block that are computed
  for (int f = 0; f < PFT; ++f)
    if (fb + f < nfc && fr.live(f0 + fb + f)) live |= 1u << f;

  // a thread takes bins of the stage for all PFT frames: the bin's twiddle
  // once, the frames' loads all in flight
  const auto fill = [&](int k0) {
    const int y0 = k0 & (pk - 1);
    if (y0 != 0) return y0;
    if constexpr (ROWS) {  // consecutive threads on consecutive bins
#pragma unroll 4
      for (int t = tid; t < PFT * ROW_BINS; t += PNTH) {
        const int f = t / ROW_BINS, j = t % ROW_BINS, k = k0 + j;
        ys[f * ys_stride + j] = k < nbins && (live >> f & 1u)
                                    ? pw[(size_t)(fb + f) * pstride + k]
                                    : 0.f;
      }
      return 0;
    }
    for (int t = tid; t < pk; t += PNTH) {
      const int j = ((t & (cols - 1)) << lg1) + (t >> lcols);
      const int k = k0 + j;
      const bool edge = k == 0 || k == H;
      const float2 w = w_pi(edge ? 0 : k, H);  // W_N^k
      const int ka = edge || k > H ? 0 : k, kb = edge || k > H ? 0 : H - k;
      const int ia = ((ka & (H1 - 1)) << lg2_) + (ka >> lg1);
      const int ib = ((kb & (H1 - 1)) << lg2_) + (kb >> lg1);
      float2 a[PFT], b[PFT];
#pragma unroll
      for (int f = 0; f < PFT; ++f) {
        const bool on = k <= H && (live >> f & 1u);
        const float2* zr = z + (size_t)(fb + f) * H;
        a[f] = on ? zr[ia] : make_float2(0.f, 0.f);
        b[f] = on ? zr[ib] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int f = 0; f < PFT; ++f) {
        float p = 0.f;
        if (k <= H && (live >> f & 1u)) {
          if (edge) {  // Z[0]
            const float x = k == 0 ? a[f].x + a[f].y : a[f].x - a[f].y;
            p = x * x;
          } else {
            const float2 e = make_float2(0.5f * (a[f].x + b[f].x),
                                         0.5f * (a[f].y - b[f].y));
            const float2 o = make_float2(0.5f * (a[f].y + b[f].y),
                                         -0.5f * (a[f].x - b[f].x));
            const float2 wo = cmul(w, o);
            const float xr = e.x + wo.x, xi = e.y + wo.y;
            p = xr * xr + xi * xi;
          }
          if (per_bin_floor) p = fmaxf(p, power_floor);
        }
        ys[f * ys_stride + j] = p;
      }
    }
    return 0;
  };
  float acc[GPW][4];
  rfft::project_bins<PFT, PWARPS, OPL, CK, true>(
      op, op_rows(nbins, OPL), nbins, rfft::out_chunks(nout), opc, ys,
      ys_stride, fill,
      [&](int c, int fl, int gh) {
        if (!(live >> fl & 1u)) return;
        float* row = sums + (size_t)(fb + fl) * nout;
#pragma unroll
        for (int i = 0; i < GPW; ++i) {
          const int g = warp + PWARPS * (gh + LPF * i);
          if (g >= NG) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = NOP * c + 4 * g + q;
            if (o < nout)
              row[o] = o < nmel ? logf(fmaxf(acc[i][q], power_floor))
                                : acc[i][q];
          }
        }
      },
      acc);
}

// The fused pass for frames f0 .. f0 + nfc - 1 on `st`: ROWS, from the
// power rows pw [nfc][pstride] of bins 0..nbins - 1 (z unused); else from
// the device-memory passes' z [nfc][H] (nbins = H + 1, pw unused); sums
// rows [nfc][nout].
template <bool ROWS, class Frames>
cudaError_t project(const Frames& fr, int f0, int nfc, const float2* z,
                    const float* pw, int pstride, int nbins, const float4* op,
                    float* sums, int lgn, int nmel, int nac,
                    float power_floor, bool per_bin_floor, cudaStream_t st) {
  return rfft::with_opl(rfft::opl_of(nmel + nac), [&](auto oc) {
    constexpr int OPL = decltype(oc)::value;
    const auto kernel = power_project_kernel<Frames, OPL, ROWS>;
    const int smem =
        4 * project_floats(ROWS ? ROW_BINS : stage_bins(lgn), OPL);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<(nfc + PFT - 1) / PFT, PNTH, smem, st>>>(
        fr, f0, nfc, z, pw, pstride, nbins, op, sums, lgn, nmel, nac,
        power_floor, per_bin_floor ? 1 : 0);
    return cudaGetLastError();
  });
}

// where srt_cluster::spectra leaves the sums rows of a chunk of nfc frames
inline float* sums_rows(float* scratch, int n, int nfc) {
  return scratch + (size_t)nfc * n;
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
// srt_cluster::spectra then outputs_kernel, into ceps [n, nceps] and r [n,
// nac].
inline cudaError_t frame_level(const srt_cluster::FrameSource& fr, int n,
                               int chunk, int nfft, float* scratch,
                               const float4* op, const float* dct,
                               float* ceps, float* r, int nmel, int nac,
                               int nceps, float power_floor,
                               bool per_bin_floor, cudaStream_t st) {
  if (!takes(nfft) || chunk < 1 || chunk > 65535)
    return cudaErrorInvalidValue;
  for (int f0 = 0; f0 < n; f0 += chunk) {
    const int nfc = min(chunk, n - f0);
    cudaError_t err = srt_cluster::spectra(fr, f0, nfc, nfft, scratch, op,
                                           nmel, nac, power_floor,
                                           per_bin_floor, st);
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
