// Fused predict monolith for Hopper (sm_90a): the kernel and its launch,
// shared by csrc/predict_fused.cu (the C interface, the bf16 route) and the
// f32 route's instantiations by FFT size, csrc/predict_fused_n*.cu (one
// nvcc process each, so that the build runs them side by side).
//
// Replaces speaker_recognition_tpu/ops/pallas_predict.py:_run (K6,
// per-utterance scoring, optional bf16 DFT operands) and :_run_wide (K7,
// transposed batched scoring). Both compute one function, and both
// wrappers (ops/gpu_predict.py) launch this kernel: for utterance b, frames
// f < T = (Lp - flen)//fshift + 1, flen = 2*fshift, and nv =
// min(max(n_valid[b], 0), T) valid frames,
//     Y = the power spectrum of the windowed, pre-emphasized frame
//     ceps = log(max(Y . M, floor)) . dct, masked CMVN over the nv frames
//     lpc  = Levinson(Y . R), non-finite -> 0 (when R has columns)
//     ll[f, s] = logsumexp_k ([feat^2 | feat] . op + cw)[s*K + k],
//                floored: > -745 ? ll : log(1e-15)
//     out[b, s] = sum_{f < nv} ll[f, s] / max(nv, 1)
// Two routes compute Y, chosen by the caller in the open:
//   * f32: an N-point real FFT of the frame (N = ops/frontend.rfft_size(
//     flen)) on the FFT tile of csrc/rfft_tile.cuh, with the bin-domain
//     operators M and R of ops/frontend.fft_packed_operators, as the signal
//     frontend (csrc/frontend.cu, K1) computes it, past 512 outputs in
//     chunks of 512 whose sums live in device rows; from N = 32768 on, the
//     four-step FFT of csrc/rfft_big.cuh in launches of its own
//     (csrc/predict_fused_big.cu), after which this kernel runs phases 2-4
//     only (ScoreTile);
//   * bf16: the TPU kernel's dense product X = frame . D, Y = X^2 on the
//     dense tile of csrc/packed_tile.cuh, with the samples and D rounded to
//     bf16 (nearest even; D and W | A packed once by the wrapper,
//     ops/gpu_frontend.dft_mma_operator and dense_wa_operator): X on the
//     tensor cores (mma.sync, f32 sums), Y and every later sum in f32 on
//     the FP32 cores. Any number of outputs (chunks of 128 past 128) and
//     any frame length (a tile of 128, 64 or 32 frames, the samples in
//     device memory past what a 32-frame tile's shared memory holds).
//
// What bounds it on this card: operations. The least work is a real FFT
// of N points a frame (2.5 N log2 N), the bin-domain operators' nonzeros,
// the log, DCT and Levinson, and 4*d FLOPs a frame and component of the
// bank, all in f32 outside the tensor cores: 0.150 ms for 512 x 5 s at
// 8 kHz with a 4 x 32 bank (chip_smoke.py's bound). The dense product of
// the TPU kernel costs ~331 kFLOP a frame there, the FFT ~12 kFLOP.
//
// What the design does about it. CMVN makes the utterance the unit: no
// frame can be scored before its utterance's mean and deviation are
// known. So this is one cooperative launch of a persistent grid (the
// blocks resident at once, rfft::nth(N) threads each) in four phases,
// split by grid-wide barriers:
//   1. frontend tiles: rfft::tile_sums with K1's SignalFrames loader, then
//      tile_features (csrc/packed_tile.cuh) -> pre-CMVN cepstra and LPC in
//      a feature scratch [B, T, d] in device memory (18.3 MB at the bench
//      batch, most of it still in L2 when read). The spectra stay on chip;
//      tiles wholly past nv are skipped;
//   2. per utterance: the masked two-pass CMVN, in place (cmvn_utterance);
//   3. per (speaker group, utterance, block tile): the batched scoring
//      kernel's inner loop (csrc/gmm_lse.cuh): each warp keeps its 32 * FPL
//      frames in registers (RegFrames, or WideFrames past a padded d of
//      128), the group's component rows stream through shared memory by
//      cp.async (RowStream), and the online logsumexp with the -745 floor
//      runs over them; at each speaker's last row a fixed-order warp sum
//      of the floored values goes into partial [B][warp tile][S]. No limit
//      on d or K: the rows come in chunks that fit the frontend's shared
//      memory;
//   4. out[b, s] = the partials summed in warp-tile order / max(nv, 1).
// The rows are GmmBank.component_operator's at the padded width of the
// route (32 or 128 in registers, so that few instantiations serve every d;
// the zero-padded terms add exact zeros). Every sum runs in a fixed
// order with no atomics, and no result depends on which block took an
// item, so two calls give bitwise-equal scores.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gmm_lse.cuh"
#include "packed_tile.cuh"
#include "rfft_tile.cuh"

namespace srt_fused {

namespace cg = cooperative_groups;

struct Args {
  const float* signals;  // [B, Lp]
  const int* n_valid;    // [B]
  const float* win;      // [flen] (f32 route)
  const float4* op;      // the packed [M | R | 0] operator (f32 route)
  const uint4* D;        // [flen, ncols] packed as bf16 (bf16 route)
  const uint4* WA;       // W [ncols, nmel] | A [ncols, nac] packed (bf16)
  const float* dct;      // [nmel, nceps]
  const float* comp;     // component rows [S*K][P]
  float* feat;           // scratch [B, T, d]
  float* partial;        // scratch [B][NW][S]
  float* out;            // [B, S]
  float* wsums;          // scratch [B * T][128 * nchunk] (bf16, > 128 outputs)
  int B, Lp, T, flen, fshift, ncols, nmel, nac, nceps, d, S, K, P;
  int nchunk;  // output chunks of the bf16 route's tile
  int NW;   // warp tiles an utterance
  int sg;   // speakers a scoring item
  int ch;   // component rows a staged chunk
  int cmvn, preemph_first;
  float pre_emph, power_floor;
};

__device__ __forceinline__ int valid_frames(const Args& a, int b) {
  return min(max(a.n_valid[b], 0), a.T);
}

// The f32 route's frontend tile: K1's loader on the FFT tile. Past 512
// outputs (OPL 64, a.nchunk > 1) the tile projects onto chunks of 512
// outputs in turn and keeps the sums in rows of a.wsums [B * T][512 *
// nchunk], as K1 does; an output's FMA order does not depend on the count.
template <int N, int OPL>
struct FftTile {
  static constexpr bool FRONTEND = true;
  static constexpr int FT = rfft::ft(N), NTH = rfft::nth(N);
  static constexpr int smem_bytes(int, int) {
    return 4 * rfft::smem_floats(N, OPL);
  }
  __device__ static void features(const Args& a, float* smem, int b, int f0,
                                  int nv) {
    const rfft::SignalFrames load{
        a.signals + (size_t)b * a.Lp + (size_t)f0 * a.fshift, a.win,
        a.Lp - f0 * a.fshift, a.fshift, a.flen, a.pre_emph,
        a.preemph_first != 0};
    const int nf = min(FT, a.T - f0);
    const bool rows = OPL == 64 && a.nchunk > 1;
    const int wstride = rfft::nop(OPL) * a.nchunk;
    float* wrows =
        rows ? a.wsums + ((size_t)b * a.T + f0) * wstride : nullptr;
    const float* sums = rfft::tile_sums<N, OPL, false>(
        load, nf, smem, a.op, a.nmel, a.power_floor, a.nchunk, wrows,
        wstride);
    float* out = a.feat + ((size_t)b * a.T + f0) * a.d;
    if (rows)
      tile_features<OPL, NTH>(wrows, out, nf, nv - f0, a.dct, a.nmel, a.nac,
                              a.nceps, true, wstride);
    else
      tile_features<OPL, NTH>(sums, out, nf, nv - f0, a.dct, a.nmel, a.nac,
                              a.nceps, true);
  }
};

// The route of N >= 32768 (csrc/predict_fused_big.cu): the four-step FFT's
// passes have left the pre-CMVN features in a.feat before the launch, so
// the kernel runs phases 2-4 only, with shared memory for the rows.
struct ScoreTile {
  static constexpr bool FRONTEND = false;
  static constexpr int FT = 1, NTH = 256;
  static constexpr int smem_bytes(int, int) { return 2 * CHUNK_BYTES; }
  __device__ static void features(const Args&, float*, int, int, int) {}
};

// The bf16 route's frontend tile: the dense product on bf16 operands on the
// tensor cores (csrc/packed_tile.cuh); past 128 outputs the sums leave through
// rows of a.wsums [B * T][128 * nchunk], and with GSEG the samples are read
// from device memory (frames too long for a 32-frame tile's shared memory).
template <int FT_, int OPL, bool GSEG = false>
struct DenseBf16Tile {
  static constexpr bool FRONTEND = true;
  static constexpr int FT = FT_, NTH = NT;
  static constexpr int smem_bytes(int flen, int fshift) {
    return ::smem_bytes(FT, OPL, flen, fshift, GSEG);
  }
  __device__ static void features(const Args& a, float* smem, int b, int f0,
                                  int nv) {
    const int nf = min(FT, a.T - f0);
    const int wstride = 8 * OPL * a.nchunk;
    float* wrows = a.wsums + ((size_t)b * a.T + f0) * wstride;
    const float* sums = tile_sums<FT, OPL, GSEG>(
        a.signals + (size_t)b * a.Lp + (size_t)f0 * a.fshift,
        a.Lp - f0 * a.fshift, a.D, a.WA, smem, a.flen, a.fshift, a.ncols,
        a.nmel, a.power_floor, a.nchunk, wrows, wstride, nf,
        min(nf, nv - f0));
    float* out = a.feat + ((size_t)b * a.T + f0) * a.d;
    if (OPL == 16 && a.nchunk > 1)
      tile_features<OPL>(wrows, out, nf, nv - f0, a.dct, a.nmel, a.nac,
                         a.nceps, true, wstride);
    else
      tile_features<OPL>(sums, out, nf, nv - f0, a.dct, a.nmel, a.nac,
                         a.nceps, true);
  }
};

template <class Tile, class Frames>
__global__ void __launch_bounds__(Tile::NTH) fused_predict_kernel(
    const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  constexpr int NTH = Tile::NTH, FT = Tile::FT, WARPS = NTH / 32;
  constexpr int FPL = Frames::FPL, WF = 32 * FPL;  // frames a warp tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // 1. frontend tiles -> pre-CMVN features
  if constexpr (Tile::FRONTEND) {
    const int nt1 = (a.T + FT - 1) / FT;
    for (long long it = blockIdx.x; it < (long long)a.B * nt1;
         it += gridDim.x) {
      const int b = (int)(it / nt1), f0 = (int)(it % nt1) * FT;
      const int nv = valid_frames(a, b);
      if (f0 >= nv) continue;  // block-uniform: no frame of the tile is read
      __syncthreads();  // the previous tile's readers of smem are done
      Tile::features(a, smem, b, f0, nv);
    }
    grid.sync();
  }

  // 2. masked CMVN per utterance, in place
  if (a.cmvn) {
    auto red = reinterpret_cast<float (*)[32]>(smem);  // [WARPS][32]
    float (*stat)[32] = red + WARPS;                     // [2][32]
    for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
      __syncthreads();
      cmvn_utterance<WARPS>(a.feat + (size_t)b * a.T * a.d,
                            valid_frames(a, b), a.d, a.nceps, lane, warp,
                            red, stat);
    }
    grid.sync();
  }

  // 3. per (speaker group, utterance, block tile): the warps' floored
  // log-likelihood sums, as in csrc/gmm_score.cu
  const int nbt = (a.NW + WARPS - 1) / WARPS;  // block tiles an utterance
  const int ngroups = (a.S + a.sg - 1) / a.sg;
  const long long per_group = (long long)a.B * nbt;
  for (long long it = blockIdx.x; it < ngroups * per_group;
       it += gridDim.x) {
    const int g = (int)(it / per_group);
    const int b = (int)(it % per_group / nbt), bt = (int)(it % nbt);
    const int nv = valid_frames(a, b);
    if (bt * WARPS * WF >= nv) continue;  // block-uniform: no valid frame
    const int s0 = g * a.sg, ns = min(a.sg, a.S - s0);
    __syncthreads();  // the previous item's readers of shared memory are done
    const RowStream st{a.comp + (size_t)s0 * a.K * a.P, smem, ns * a.K, a.P,
                       a.ch};
    if (Frames::STAGED) st.fetch(0);
    const int wt = bt * WARPS + warp;
    Frames fr;
    bool ok[FPL];
    bool any = false;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int t = (wt * FPL + i) * 32 + lane;
      ok[i] = wt < a.NW && t < nv;
      fr.load(i, ok[i] ? a.feat + ((size_t)b * a.T + t) * a.d : nullptr,
              a.d);
      any = any || ok[i];
    }
    const bool active = __any_sync(0xffffffffu, any);
    float* mine = a.partial + ((size_t)b * a.NW + wt) * a.S + s0;
    walk_components(st, a.K, active, fr, [&](int s, OnlineLse (&lse)[FPL]) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < FPL; ++i)
        if (ok[i]) v += lse[i].floored();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) mine[s] = v;
    });
    if (!active && wt < a.NW)
      for (int s = lane; s < ns; s += 32) mine[s] = 0.f;
  }
  grid.sync();

  // 4. per-utterance means: the warp tiles that hold valid frames, in order
  for (long long i = (long long)blockIdx.x * NTH + tid;
       i < (long long)a.B * a.S; i += (long long)gridDim.x * NTH) {
    const int b = (int)(i / a.S), s = (int)(i % a.S);
    const int nv = valid_frames(a, b);
    float acc = 0.f;
    for (int w = 0; w < (nv + WF - 1) / WF; ++w)
      acc += a.partial[((size_t)b * a.NW + w) * a.S + s];
    a.out[i] = acc / fmaxf((float)nv, 1.f);
  }
}

// The scoring route of a feature dimension: the padded width of the
// component rows the kernel reads (32, two frames a lane, or 128, one, in
// registers; d rounded up to 4 past that, left in device memory). Two
// register widths and not K2's 32 keep the instantiations, and the build,
// in bounds.
inline int score_width(int d) {
  const int dp = padded_dim(d);
  return dp <= 32 ? 32 : dp <= MAX_REG_DP ? MAX_REG_DP : dp;
}

// The speakers a scoring item takes and the rows a staged chunk holds, for
// `blocks` resident blocks with `smem` bytes each: the whole bank while
// the batch's items fill the grid, else fewer speakers an item (as the
// batched kernel splits a small batch); the rows all in one buffer when
// they fit the frontend's shared memory, else in two buffers of half of it.
inline void score_plan(int B, int NW, int warps, int S, int K, int P,
                       int blocks, int smem, int* sg, int* ch) {
  const long long items = (long long)B * ((NW + warps - 1) / warps);
  const int groups = (int)std::min<long long>(
      S, std::max<long long>(1, (blocks + items - 1) / items));
  *sg = (S + groups - 1) / groups;
  const long long rows = (long long)*sg * K;
  *ch = rows * P * 4 <= smem
            ? (int)rows
            : std::max(1, smem / 2 / (P * 4));
}

template <class Tile, class Frames>
cudaError_t launch(Args a, cudaStream_t st) {
  const auto kern = fused_predict_kernel<Tile, Frames>;
  const int smem = Tile::smem_bytes(a.flen, a.fshift);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kern, Tile::NTH, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  constexpr int WARPS = Tile::NTH / 32;
  a.NW = std::max(1, (a.T + 32 * Frames::FPL - 1) / (32 * Frames::FPL));
  score_plan(a.B, a.NW, WARPS, a.S, a.K, a.P, nsm * per_sm, smem, &a.sg,
             &a.ch);
  // every block must be resident for the grid-wide barriers; more blocks
  // than the largest phase has items would only wait at them
  const int nt1 = Tile::FRONTEND ? (a.T + Tile::FT - 1) / Tile::FT : 0;
  const long long items = std::max(
      {(long long)a.B * nt1,
       (long long)((a.S + a.sg - 1) / a.sg) * a.B * ((a.NW + WARPS - 1) /
                                                     WARPS),
       ((long long)a.B * a.S + Tile::NTH - 1) / Tile::NTH});
  const int grid =
      (int)std::max(1LL, std::min((long long)nsm * per_sm, items));
  void* params[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(Tile::NTH), params, (size_t)smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel of a frontend tile at the feature dimension's scoring route.
template <class Tile>
cudaError_t with_frames(const Args& a, cudaStream_t st) {
  switch (score_width(a.d)) {
    case 32: return launch<Tile, RegFrames<32, 2>>(a, st);
    case MAX_REG_DP: return launch<Tile, RegFrames<MAX_REG_DP, 1>>(a, st);
  }
  return launch<Tile, WideFrames>(a, st);
}

// The f32 route's kernel at nfft, one of N0, Ns..., and operator width
// opl; cudaErrorInvalidValue when nfft is none of them.
template <int N0, int... Ns>
cudaError_t launch_fft_sizes(const Args& a, int nfft, int opl,
                             cudaStream_t st) {
  if (nfft == N0)
    return rfft::with_opl(opl, [&](auto oc) {
      return with_frames<FftTile<N0, decltype(oc)::value>>(a, st);
    });
  if constexpr (sizeof...(Ns) > 0)
    return launch_fft_sizes<Ns...>(a, nfft, opl, st);
  else
    return cudaErrorInvalidValue;
}

// csrc/predict_fused_n*.cu
cudaError_t launch_fft_64_128(const Args& a, int nfft, int opl,
                              cudaStream_t st);
cudaError_t launch_fft_256_512(const Args& a, int nfft, int opl,
                               cudaStream_t st);
cudaError_t launch_fft_1024_2048(const Args& a, int nfft, int opl,
                                 cudaStream_t st);
cudaError_t launch_fft_4096(const Args& a, int nfft, int opl,
                            cudaStream_t st);
cudaError_t launch_fft_8192_16384(const Args& a, int nfft, int opl,
                                  cudaStream_t st);

}  // namespace srt_fused
