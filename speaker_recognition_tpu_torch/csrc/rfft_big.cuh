// The spectral stage of the frontends (K1, K4, K5 and the monolith K6) at
// an FFT of N >= 32768 points, where one frame's H = N/2 complex values
// (128 KB at N = 32768) no longer fit the FFT tile of csrc/rfft_tile.cuh
// beside its power rows: a route chosen on N in the open, with its own
// counters, not a fallback. With z[j] = x[2j] + i x[2j+1] (j < H), a chunk
// of frames at a time:
//   * up to N = 262144 (srt_cluster::takes) a frame's spectrum stays on
//     chip: the cluster FFT of csrc/rfft_cluster.cuh (one block of 16384
//     values at N = 32768, a thread-block cluster of 2, 4 or 8 blocks past
//     it, the transpose an exchange in distributed shared memory) writes
//     the frame's power row |X[k]|^2 (k <= H, the real-input post-step on
//     chip) once;
//   * past it, up to MAX_N, the column and row passes of csrc/
//     rfft_passes.cuh over a matrix [H1][H2] in device memory a frame
//     (groups of frames whose matrices stay in L2), whose row pass pairs
//     rows k1 and H1 - k1 and writes the same power rows;
//   * then the fused power + projection pass (power_project_kernel): a
//     block of PFT frames walks the bins in order, stages the power of
//     ROW_BINS bins at a time from the power rows in shared memory, and
//     projects it onto the packed [mel | acorr | 0] operator with the FFT
//     tile's walk (rfft::project_bins: the operator staged in chunks,
//     all-zero 4-column groups skipped, each output summed over the bins in
//     order in registers), then log(max(mel, floor)), into sums rows
//     [nout] of log-mel | raw autocorrelation: the layout the tile's
//     epilogues read (tile_features, frame_outputs) with a row stride of
//     nout. The chirp-z route past M = 8192 (csrc/frontend_chirp_cluster.cu)
//     takes the same pass on its power rows.
//   * Where ceil(nfc / PFT) blocks cannot fill the card (few frames: 62
//     at 8 kHz in 2 x 0.5 s), the pass splits the bins into S ranges
//     (a second grid dimension; S from nfc and the bins alone, never from
//     the device, so the bits do not depend on the card): a block writes
//     its frames' sums over its range into partial rows, and combine_kernel
//     adds the S partials in the order s = 0 .. S - 1, then takes the log.
//     Where S = 1 (a thousand frames or more) the pass runs as it did
//     without the split, bit for bit.
// Twiddles come from sincospif of exact angles (the indices stay below
// 2^24), directly or through the FFTs' two-level tables, as on the tile;
// no fast intrinsics. Every sum runs in a fixed order with no atomics, so
// two calls give the same bits.
//
// What bounds it: the least work is FLOPs (2.5 N log2 N for the FFT and
// two per nonzero of the operators) or the frames' bytes. The cluster route
// moves a frame's samples and its power row (64 KB at N = 32768) and
// nothing else; the passes add a write and a read of the matrix (2 MB a
// frame at N = 524288, L2-resident between them). The fused pass reads its
// power once in whole sectors and the operator once per block of PFT
// frames; its walk is latency-bound a block, so min_blocks keeps three
// blocks an SM and the split gives few frames enough blocks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rfft_cluster.cuh"
#include "rfft_passes.cuh"
#include "rfft_tile.cuh"

namespace {
namespace rfft_big {

constexpr int MIN_N = 32768;
constexpr int MAX_N = 2 << passes::MAX_LGT;  // H = 2^23: the passes' reach

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// whether the route takes an N-point FFT
inline bool takes(int n) {
  return n >= MIN_N && n <= MAX_N && (n & (n - 1)) == 0;
}

// The fused power + projection pass (power_project_kernel): PFT frames a
// block of PWARPS warps; the operator staged in chunks of ck(OPL) bins (as
// many as 32 KB hold, at most 64), the power in stages of ROW_BINS bins.
constexpr int PFT = 8, PWARPS = 8, PNTH = 32 * PWARPS;
constexpr int ROW_BINS = 512;

// The split of the fused pass over the bins: none where ceil(nfc / PFT)
// reaches SPLIT_BLOCKS; else about SPLIT_TARGET blocks in all, each range
// at least SPLIT_MIN_BINS bins and a multiple of ROW_BINS.
constexpr int SPLIT_BLOCKS = 128, SPLIT_TARGET = 256, SPLIT_MIN_BINS = 4096;

// bins of a range of the fused pass over nfc frames of nbins bins (nbins
// where it does not split)
inline int range_bins(int nfc, int nbins) {
  const int blocks = (nfc + PFT - 1) / PFT;
  if (blocks >= SPLIT_BLOCKS) return nbins;
  const int want = (SPLIT_TARGET + blocks - 1) / blocks;
  const int most = nbins / SPLIT_MIN_BINS;
  const int s = want < most ? want : most;
  if (s <= 1) return nbins;
  const int r = (nbins + s - 1) / s;
  return (r + ROW_BINS - 1) / ROW_BINS * ROW_BINS;
}

// S, the ranges of the fused pass over nfc frames of nbins bins
inline int ranges(int nfc, int nbins) {
  const int r = range_bins(nfc, nbins);
  return (nbins + r - 1) / r;
}

// floats of the split's partial rows for any chunk of at most nfc frames:
// S nfc rows of nout where S > 1
inline long long partial_floats(int nfc, int nbins, int nout) {
  long long most = 0;
  for (int m = 1; m <= nfc && m < PFT * SPLIT_BLOCKS; ++m) {
    const int s = ranges(m, nbins);
    if (s > 1 && (long long)s * m > most) most = (long long)s * m;
  }
  return most * nout;
}

// floats of a power row of nbins bins (16-byte rows)
inline int power_stride(int nbins) { return (nbins + 3) & ~3; }

// floats of the matrices the passes keep for a chunk of nfc frames at an
// N-point FFT: a group of frames' [H1][H2] float2 (none on the cluster
// route)
inline long long matrix_floats(int n, int nfc) {
  if (srt_cluster::takes(n)) return 0;
  const int g = passes::group_frames(ilog2(n) - 1);
  return (long long)(nfc < g ? nfc : g) * n;
}

// floats of scratch for nfc frames at an N-point FFT with nout outputs:
// the passes' matrices, the power rows [nfc][power_stride(N/2 + 1)], the
// sums rows [nfc][nout] and the split's partial rows
inline long long scratch_floats(int n, int nout, int nfc) {
  const int nb = n / 2 + 1;
  return matrix_floats(n, nfc) + (long long)nfc * (power_stride(nb) + nout) +
         partial_floats(nfc, nb, nout);
}

// where the scratch of a chunk of nfc frames at an N-point FFT keeps its
// power rows, its sums rows (which the epilogues read) and its partials
inline float* power_rows(float* scratch, int n, int nfc) {
  return scratch + matrix_floats(n, nfc);
}
inline float* sums_rows(float* scratch, int n, int nfc) {
  return power_rows(scratch, n, nfc) +
         (size_t)nfc * power_stride(n / 2 + 1);
}
inline float* partial_rows(float* scratch, int n, int nout, int nfc) {
  return sums_rows(scratch, n, nfc) + (size_t)nfc * nout;
}

__host__ __device__ constexpr int ck(int opl) {
  return opl <= 16 ? 64 : opl <= 32 ? 32 : 16;
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
// stage
__host__ __device__ constexpr int project_floats(int opl) {
  return ck(opl) * rfft::nop(opl) + PFT * (ROW_BINS + 1);
}

// Block (i, s): frames PFT i .. PFT i + PFT - 1 of the chunk, the power of
// bins kb .. kb + nb - 1 of range s (kb = s rbins; one range of all nbins
// bins where the pass does not split) and its projection onto the packed
// operator op ([mel | acorr | 0] rows, op_rows(nbins, opl) of them an
// output chunk) by rfft::project_bins; at every ROW_BINS-th bin its fill
// stages the power of the next ROW_BINS bins of the block's frames from
// the power rows pw [nfc][pstride] in ys [PFT][ROW_BINS + 1], consecutive
// threads on consecutive bins. Unsplit, log(max(mel, floor)) |
// autocorrelation into sums rows [nfc][nout]; split, the range's raw sums
// into partial rows [S][nfc][nout] (combine_kernel finishes them). Frames
// past nfc, and frames the loader does not compute, take zero power and
// leave no sums.
template <class Frames, int OPL>
__global__ void __launch_bounds__(PNTH, min_blocks(OPL)) power_project_kernel(
    const Frames fr, int f0, int nfc, const float* __restrict__ pw,
    int pstride, int nbins, int rbins, const float4* __restrict__ op,
    float* __restrict__ sums, int nmel, int nac, float power_floor,
    int split) {
  constexpr int CK = ck(OPL), NOP = rfft::nop(OPL), NG = NOP / 4;
  constexpr int GPW = rfft::proj_gpw(PFT, PWARPS, OPL), LPF = 32 / PFT;
  constexpr int YS = ROW_BINS + 1;
  extern __shared__ float4 smem4[];
  float* opc = reinterpret_cast<float*>(smem4);  // [CK][NOP]
  float* ys = opc + CK * NOP;                    // [PFT][YS]
  const int fb = blockIdx.x * PFT, nout = nmel + nac;
  const int kb = blockIdx.y * rbins, nb = min(rbins, nbins - kb);
  const int tid = threadIdx.x, warp = tid / 32;
  unsigned live = 0;  // frames of the block that are computed
  for (int f = 0; f < PFT; ++f)
    if (fb + f < nfc && fr.live(f0 + fb + f)) live |= 1u << f;
  float* out = sums + ((size_t)blockIdx.y * nfc + fb) * nout;

  const auto fill = [&](int k0) {
    const int y0 = k0 & (ROW_BINS - 1);
    if (y0 != 0) return y0;
#pragma unroll 4
    for (int t = tid; t < PFT * ROW_BINS; t += PNTH) {
      const int f = t / ROW_BINS, j = t % ROW_BINS, k = kb + k0 + j;
      ys[f * YS + j] = k < nbins && (live >> f & 1u)
                           ? pw[(size_t)(fb + f) * pstride + k]
                           : 0.f;
    }
    return 0;
  };
  float acc[GPW][4];
  rfft::project_bins<PFT, PWARPS, OPL, CK, true>(
      op + (size_t)kb * (NOP / 4), op_rows(nbins, OPL), nb,
      rfft::out_chunks(nout), opc, ys, YS, fill,
      [&](int c, int fl, int gh) {
        if (!(live >> fl & 1u)) return;
        float* row = out + (size_t)fl * nout;
#pragma unroll
        for (int i = 0; i < GPW; ++i) {
          const int g = warp + PWARPS * (gh + LPF * i);
          if (g >= NG) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = NOP * c + 4 * g + q;
            if (o < nout)
              row[o] = split || o >= nmel ? acc[i][q]
                                          : logf(fmaxf(acc[i][q], power_floor));
          }
        }
      },
      acc);
}

// The split's second step: sums row f, output o = the S partials of (f, o)
// added in the order s = 0 .. S - 1, then log(max(mel, floor)) for the mel
// outputs; frames the loader does not compute are left alone.
template <class Frames>
__global__ void __launch_bounds__(256) combine_kernel(
    const Frames fr, int f0, int nfc, const float* __restrict__ partial,
    int S, float* __restrict__ sums, int nmel, int nout, float power_floor) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= nfc * nout || !fr.live(f0 + i / nout)) return;
  float s = 0.f;
  for (int r = 0; r < S; ++r) s += partial[(size_t)r * nfc * nout + i];
  sums[i] = i % nout < nmel ? logf(fmaxf(s, power_floor)) : s;
}

// The fused pass for frames f0 .. f0 + nfc - 1 on `st`, from their power
// rows pw [nfc][pstride] of bins 0..nbins - 1, into sums rows [nfc][nout];
// split over the bins where ranges(nfc, nbins) > 1, with partial rows
// [S][nfc][nout] (partial_floats).
template <class Frames>
cudaError_t project(const Frames& fr, int f0, int nfc, const float* pw,
                    int pstride, int nbins, const float4* op, float* sums,
                    float* partial, int nmel, int nac, float power_floor,
                    cudaStream_t st) {
  const int rbins = range_bins(nfc, nbins), S = (nbins + rbins - 1) / rbins;
  const int nout = nmel + nac;
  cudaError_t err = rfft::with_opl(rfft::opl_of(nout), [&](auto oc) {
    constexpr int OPL = decltype(oc)::value;
    const auto kernel = power_project_kernel<Frames, OPL>;
    const int smem = 4 * project_floats(OPL);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((nfc + PFT - 1) / PFT, S), PNTH, smem, st>>>(
        fr, f0, nfc, pw, pstride, nbins, rbins, op, S > 1 ? partial : sums,
        nmel, nac, power_floor, S > 1 ? 1 : 0);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || S == 1) return err;
  combine_kernel<Frames><<<(nfc * nout + 255) / 256, 256, 0, st>>>(
      fr, f0, nfc, partial, S, sums, nmel, nout, power_floor);
  return cudaGetLastError();
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
