// The tile of the signal kernels (csrc/frontend_full_signals.cu, K5's
// serving route at 44.1/48 kHz, and csrc/frontend_lpcc_signals.cu, K1's
// LPC-cepstra mode): a tile of FT frames loaded from the signal, their
// power spectra on a shared-memory real FFT (the butterflies of csrc/
// rfft_tile.cuh), and the projection of the power rows onto [mel | acorr |
// 0] on the tensor cores. K5 floors each power bin, K1 only the mel sums
// (signal_sums' FLOOR_BINS). K1's LPC and raw modes, K4, K5 on frames,
// K6/K7 and the chirp-z and four-step routes keep rfft::tile_sums and
// rfft::project_bins.
//
// For frame f of the tile (FT = ft(N) frames: 16 up to N = 4096, 4 at
// 8192, 2 at 16384; warps(N) warps, each taking frames w, w + WARPS, ...):
//   1. gather: lane l takes sample pairs j = l + 32 q, one float2 load of
//      (x[2j], x[2j+1]) and one of the window where the frame's first
//      sample and the window are 8-byte aligned (a warp-uniform branch on
//      the address: at 44.1 kHz the shift is 705, so every other frame
//      takes the scalar pair path), the pre-emphasis' previous sample
//      x[2j-1] (or w x at it) from lane l - 1 by one shuffle, lane 0 from
//      lane 31's previous pair (pair 32 q - 1), or, where a frame's pairs
//      come in rounds (N >= 4096), by a load of its own;
//   2. the FFT of csrc/rfft_tile.cuh (register stages, a transpose or
//      column passes through the warp's buffer), then the real-input
//      post-step's power, floored per bin for K5; up to N = 4096 each
//      lane holds its bins' powers in registers until the warp has read
//      the spectrum, and the power row [H + 1] then overwrites the start
//      of the frame's own FFT buffer (the next frame's buffer starts one
//      row further on),
//      so a warp's J frames take (J - 1) rows and one buffer of shared
//      memory, not J rows and a buffer: at N = 2048 16 frames' rows and 8
//      buffers fit 112.5 KB and two blocks share an SM (16 warps);
//   3. the projection: power [FT x (H + 1)] . op [(H + 1) x 8 OPL] as
//      mma.sync m16n8k8 TF32 products (the 16 rows of the A tile are the
//      frames, each 8-column n-tile of outputs a B tile) in three terms,
//      hi.hi + hi.lo + lo.hi, hi = tf32(x) and lo = tf32(x - hi) on both
//      operands, which keeps f32-grade sums (the CPU model of
//      tests/test_torch_full_signals.py holds it to the gates). The
//      wrapper splits and packs the operator once (gpu_frontend.
//      signal_operator): each nonzero (k-step, n-tile) block of 8 bins x 8
//      columns as 32 lanes x (hi(b0), hi(b1), lo(b0), lo(b1)) in fragment
//      order; the blocks that are all zero (a mel filter far from the
//      bins) are left out, and the autocorrelation starts at an n-tile's
//      first column, so that its dense columns share no n-tile with a mel
//      band (at 48 kHz 408 blocks of 129 x 9, where a shared n-tile made
//      it 512). The power rows are split as their A fragments are loaded
//      (row stride 4 mod 32: a fragment's 32 loads hit 32 banks). Each
//      warp takes a column group (at most 9 n-tiles, their sums in
//      registers) and a run of k-steps holding about an even share of the
//      group's blocks, and walks its blocks an n-tile at a time, the three
//      products in accumulator chains of their own; the warps' partial
//      sums are added in a fixed order, so two calls give the same bits.
//      The blocks come straight from L2 (each read once a tile): staged
//      through shared memory by cp.async they were slower (PERF.md §6).
//
// What bounds it: the signals read once and ~15 GFLOP of FFT and
// projection at 512 x 5 s @ 48 kHz (chip_smoke.py phase 22 prints the
// bound); the tile sets the pace by latency. The design moves the
// projection off the FP32 pipes, halves the loads a sample, frees the
// registers of the FFT's prefetch and the shared memory of half the rows
// for two blocks an SM at N = 2048 (the blocks of an SM hide each other's
// latency), and keeps the coefficients of the LPC and LPC-cepstra
// recursions in registers.
//
// ROADMAP precision rule: the tensor cores' TF32 only through the
// three-term split (csrc/tf32_mma.cuh); torch.backends.cuda.matmul.
// allow_tf32 stays False.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_tile.cuh"
#include "rfft_tile.cuh"
#include "tf32_mma.cuh"

namespace {
namespace sigtile {

using rfft::BIG_N;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// frames a tile, warps a block, threads a block, blocks an SM the launch
// bounds ask for (two up to N = 2048: at most 128 registers a thread), and
// frames a warp
__host__ __device__ constexpr int ft(int n) {
  return n >= 16384 ? 2 : n >= BIG_N ? 4 : 16;
}
__host__ __device__ constexpr int warps(int n) {
  return n >= 16384 ? 2 : n >= BIG_N ? 4 : 8;
}
__host__ __device__ constexpr int nth(int n) { return 32 * warps(n); }
__host__ __device__ constexpr int min_blocks(int n) { return n <= 2048 ? 2 : 1; }
__host__ __device__ constexpr int jf(int n) { return ft(n) / warps(n); }

// power rows over their frame's FFT buffer (below BIG_N), or a row beside
// the buffer (from BIG_N on, where a lane's H/32 + 1 bins would not stay
// in registers)
__host__ __device__ constexpr bool in_place(int n) { return n < BIG_N; }
// floats of a power row: H + 1 bins, to 4 mod 32 (a fragment's rows g and
// columns t hit banks 4 g + t)
__host__ __device__ constexpr int rs(int n) { return n / 2 + 4; }
// floats of a frame's FFT buffer (rfft::buf_slots float2)
__host__ __device__ constexpr int buff(int n) { return 2 * rfft::buf_slots(n); }

// the least x' >= x that is 4 mod 32
__host__ __device__ constexpr int mod4(int x) { return x + (36 - x % 32) % 32; }

// floats of a warp's region: its rows over its FFT buffers (below
// BIG_N), or its buffer, then its row (from BIG_N on); 4 mod 32, so the
// rows of warps g = 0..7 hit banks 4 g + t
__host__ __device__ constexpr int region(int n) {
  return mod4(in_place(n) ? (jf(n) - 1) * rs(n) + buff(n) : buff(n) + rs(n));
}
__host__ __device__ constexpr int row_at(int n) {
  return in_place(n) ? 0 : buff(n);
}
// floats of the twiddles: W_N^k (k < H) below BIG_N, and the column
// stages' (rfft::col_twiddles float2)
__host__ __device__ constexpr int tw_floats(int n) {
  return (n >= BIG_N ? 0 : n) + 2 * rfft::col_twiddles(n);
}

// n-tiles (8 outputs each) of an output chunk: OPL; column groups (a warp
// sums one at a time) and n-tiles a group; warps that split a group's
// blocks (the k-split)
__host__ __device__ constexpr int groups(int opl) {
  return opl >= 16 ? opl / 8 : 1;
}
__host__ __device__ constexpr int npw(int opl) { return opl / groups(opl); }
__host__ __device__ constexpr int ksplit(int n, int opl) {
  return cmax(1, warps(n) / groups(opl));
}
// floats of the partial sums [ksplit][FT][NOP], then of the sums [FT][NOP]
// they add up to: over the whole tile after the projection below BIG_N;
// in warp 0's buffer from BIG_N on (at most 4,096 floats there)
__host__ __device__ constexpr int red_floats(int n, int opl) {
  return (ksplit(n, opl) + 1) * ft(n) * rfft::nop(opl);
}
__host__ __device__ constexpr int smem_floats(int n, int opl) {
  return tw_floats(n) + cmax(warps(n) * region(n), red_floats(n, opl));
}

// ints of the packed operator's header before its tags (gpu_frontend.
// signal_operator): the column of the first autocorrelation lag, then the
// run table, for each output chunk, column group and k-split share the
// first block of each of the group's n-tiles and the end
__host__ __device__ constexpr int run_ints(int n, int nch, int opl) {
  return 1 + nch * groups(opl) * ksplit(n, opl) * (npw(opl) + 1);
}

// OPL for nout outputs at an N-point FFT, or 0 when N is not a power of
// two in [MIN_N, MAX_N]; past 512 outputs OPL 64 in chunks
inline int pick_opl(int n, int nout) {
  if (n < rfft::MIN_N || n > rfft::MAX_N || (n & (n - 1)) != 0 || nout < 1)
    return 0;
  return rfft::opl_of(nout);
}

#ifndef CUSIM_ASM
// the 128-byte line at p toward L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}
#endif

// Every line of the tile's samples (its nf frames from s.sig) toward L2,
// by the block's NTH threads, before its warps load their first frames.
template <int NTH>
__device__ __forceinline__ void prefetch_tile(const rfft::SignalFrames& s,
                                              int nf) {
  const int span = min(s.avail, (nf - 1) * s.fshift + s.flen);
  for (int i = 32 * (int)threadIdx.x; i < span; i += 32 * NTH)
    prefetch_l2(s.sig + i);
}

// What frame f of the tile folds onto its sample pair (p, p + 1) of an
// n-point FFT: the samples t = p + n, p + 2n, ... < flen (and from p + 1)
// summed in that order, each windowed and pre-emphasized as sample p is.
// Not inlined: inlined into each of a tile's unrolled loads it kept nvcc
// on this file several times as long as the rest of the build, for a path
// that only frames longer than the FFT take.
__device__ __noinline__ float2 fold_pair(const rfft::SignalFrames s, int f,
                                         int p, int n) {
  float2 v = make_float2(0.f, 0.f);
  for (int t = p + n; t < s.flen; t += n) v.x += s(f, t);
  for (int t = p + 1 + n; t < s.flen; t += n) v.y += s(f, t);
  return v;
}

// The pre-emphasis' input at sample i of a frame at x (i < lim, the
// samples the frame has): x[i] with the emphasis first, else w[i] x[i].
__device__ __forceinline__ float emph_input(const rfft::SignalFrames& s,
                                            const float* x, int lim, int i) {
  if (i >= lim) return 0.f;
  const float v = __ldg(x + i);
  return s.preemph_first ? v : __ldg(s.win + i) * v;
}

// Lane `lane`'s sample pairs of frame f in round rd: pair j = lane + 32 (R
// q + rd), R = rfft::rounds(N), is (y[2j], y[2j+1]), y the frame windowed
// and pre-emphasized as rfft::SignalFrames computes it, zero past flen,
// then (a block-uniform branch) the fold of a frame longer than N.
template <int N>
__device__ __forceinline__ void gather(const rfft::SignalFrames& s, int f,
                                       int rd, int lane,
                                       float2 (&v)[rfft::round_pairs(N)]) {
  constexpr int R = rfft::rounds(N), RP = rfft::round_pairs(N);
  const float* x = s.sig + f * s.fshift;
  const int lim = min(s.flen, s.avail - f * s.fshift);
  // warp-uniform: the route chosen on the frame's alignment
  const bool pairs = ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(s.win)) & 7) == 0;
  float carry = 0.f;  // lane 31's last emphasis input (R == 1)
#pragma unroll
  for (int q = 0; q < RP; ++q) {
    const int p = 2 * (lane + 32 * (R * q + rd));
    float2 xv, wv;
    if (p + 1 < lim) {
      if (pairs) {
        xv = __ldg(reinterpret_cast<const float2*>(x + p));
        wv = __ldg(reinterpret_cast<const float2*>(s.win + p));
      } else {
        xv = make_float2(__ldg(x + p), __ldg(x + p + 1));
        wv = make_float2(__ldg(s.win + p), __ldg(s.win + p + 1));
      }
    } else {
      xv = make_float2(p < lim ? __ldg(x + p) : 0.f, 0.f);
      wv = make_float2(p < s.flen ? __ldg(s.win + p) : 0.f, 0.f);
    }
    const float odd = s.preemph_first ? xv.y : wv.y * xv.y;
    const float rot = __shfl_sync(0xffffffffu, odd, (lane + 31) & 31);
    float prev = rot;  // sample p - 1's, from lane - 1
    if (lane == 0)
      prev = R == 1 ? carry : p > 0 ? emph_input(s, x, lim, p - 1) : 0.f;
    carry = rot;
    float y0, y1;
    if (s.preemph_first) {
      y0 = wv.x * (p > 0 ? xv.x - s.a * prev : (1.f - s.a) * xv.x);
      y1 = wv.y * (xv.y - s.a * xv.x);
    } else {
      y0 = wv.x * xv.x - s.a * prev;
      y1 = wv.y * xv.y - s.a * (wv.x * xv.x);
    }
    v[q] = make_float2(p < s.flen ? y0 : 0.f, p + 1 < s.flen ? y1 : 0.f);
  }
  if (s.flen > N) {
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const float2 w = fold_pair(s, f, 2 * (lane + 32 * (R * q + rd)), N);
      v[q].x += w.x;
      v[q].y += w.y;
    }
  }
}

// The real-input post-step's power of bin k (0 < k < H from slots a =
// Z[k], b = Z[H - k] and W_N^k; k = 0 and H from z = Z[0]), floored per
// bin where FLOOR (K5's function) and left as it is where the caller
// floors the mel sums only (K1's, csrc/frontend_lpcc_signals.cu).
template <bool FLOOR>
__device__ __forceinline__ float edge_power(float2 z, bool top,
                                            float power_floor) {
  const float x = top ? z.x - z.y : z.x + z.y;
  return FLOOR ? fmaxf(x * x, power_floor) : x * x;
}
template <bool FLOOR>
__device__ __forceinline__ float bin_power(float2 a, float2 b, float2 w,
                                           float power_floor) {
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
  const float2 wo = rfft::cmul(w, o);
  const float xr = e.x + wo.x, xi = e.y + wo.y;
  return FLOOR ? fmaxf(xr * xr + xi * xi, power_floor) : xr * xr + xi * xi;
}

// The twiddles at smem's start (rfft::tile_sums' tables):
// below BIG_N W_N^k (k < H) and the column stages' W_{2m}^j; from BIG_N on
// W_32^k (k < 16) and the spans of the stages across a lane's rounds.
// Ends on a barrier.
template <int N>
__device__ __forceinline__ void twiddles(float* smem) {
  constexpr int H = N / 2, NTH = nth(N);
  const int tid = threadIdx.x;
  float2* tw = reinterpret_cast<float2*>(smem);
  if constexpr (in_place(N)) {
    for (int k = tid; k < H; k += NTH) {  // W_N^k = exp(-2 pi i k / N)
      float sn, cs;
      sincospif(2.f * (float)k / (float)N, &sn, &cs);
      tw[k] = make_float2(cs, -sn);
    }
    for (int i = tid; i < rfft::col_twiddles(N); i += NTH) {
      const int m = 1 << (31 - __clz(i + 32));  // the table of span m
      float sn, cs;
      sincospif((float)(i + 32 - m) / (float)m, &sn, &cs);  // W_{2m}^j
      tw[H + i] = make_float2(cs, -sn);
    }
  } else {
    for (int i = tid; i < rfft::col_twiddles(N); i += NTH) {
      float sn, cs;
      if (i < 16) {
        sincospif((float)i / 16.f, &sn, &cs);  // W_32^i
      } else {
        const int m = 1 << (31 - __clz(i - 16 + 32));  // the table of span m
        sincospif((float)(i - 16 + 32 - m) / (float)m, &sn, &cs);  // W_{2m}^j
      }
      tw[i] = make_float2(cs, -sn);
    }
  }
  __syncthreads();
}

// Phase 1 below BIG_N, after the twiddles: each warp's frames (at most J
// = jf(N)), frame j's FFT in the buffer at row j of the warp's region and
// its power row over the buffer's start. The FFT's stages are csrc/
// rfft_tile.cuh's (tile_sums): H/32 pairs a lane in registers; at N = 2048
// a transpose, at 4096 two rounds and column passes, below 2048 two stages
// at a time in the buffer. A frame past nf is not computed (its row is
// never read into a sum that leaves). FLOOR_BINS: the power floored per
// bin (edge_power).
template <int N, bool FLOOR_BINS = true>
__device__ __forceinline__ void fft_frames(const rfft::SignalFrames& s,
                                           int nf, float* smem,
                                           float power_floor) {
  constexpr int W = warps(N), J = jf(N);
  constexpr int H = N / 2, LG = rfft::log2i(H);
  constexpr int PL = H / 32, P = rfft::log2i(PL);
  constexpr int R = rfft::rounds(N), RP = rfft::round_pairs(N);
  constexpr int PR = rfft::log2i(RP);
  constexpr int G4 = H >= 128 ? H / 128 : 1;  // 4-slot groups per lane
  static_assert(R * RP == PL && R <= 2, "rounds");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* tw = reinterpret_cast<const float2*>(smem);  // [H]
  const float2* ctw = tw + H;                                // col_twiddles
  const int base = rfft::brev_bits(lane, 5) << P;
  float* reg = smem + tw_floats(N) + warp * region(N);
  for (int j = 0; j < J; ++j) {
    const int f = warp + W * j;
    if (f >= nf) break;  // warp-uniform
    float2* buf = reinterpret_cast<float2*>(reg + j * rs(N));
    float2 r[RP];
#pragma unroll
    for (int rd = 0; rd < R; ++rd) {
      float2 v[RP];
      gather<N>(s, f, rd, lane, v);
#pragma unroll
      for (int q = 0; q < RP; ++q) r[rfft::brev_bits(q, PR)] = v[q];
      rfft::register_stages<PR, LG>(r, tw);  // stages within the block
#pragma unroll
      for (int t = 0; t < RP; ++t) buf[rfft::slot(base + RP * rd + t)] = r[t];
    }
    __syncwarp();
    if constexpr (R == 2) {
      // stage 5 (span 32) pairs the two rounds' halves of the lane's block
#pragma unroll 8
      for (int t = 0; t < 32; ++t)
        rfft::butterfly(buf, base + t, base + t + 32, ctw[t]);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // columns lane and lane + 32
        const int c = 32 * u + lane;
#pragma unroll
        for (int b = 0; b < 32; ++b) r[b] = buf[rfft::slot(64 * b + c)];
        rfft::column_stages<64, H>(r, c, tw, ctw);  // stages 6 .. 10
#pragma unroll
        for (int b = 0; b < 32; ++b) buf[rfft::slot(64 * b + c)] = r[b];
      }
      __syncwarp();
    } else if constexpr (PL == 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b) r[b] = buf[rfft::slot(32 * b + lane)];
      rfft::column_stages<32, H>(r, lane, tw, ctw);  // stages 5 .. 9
      __syncwarp();  // every lane has read its column before any is written
#pragma unroll
      for (int b = 0; b < 32; ++b) buf[rfft::slot(32 * b + lane)] = r[b];
      __syncwarp();
    } else {
#pragma unroll
      for (int st = P; st + 1 < LG; st += 2) {  // stages st and st + 1
        const int m = 1 << st;
#pragma unroll
        for (int q = 0; q < G4; ++q) {
          const int g = lane + 32 * q;
          if (g >= H / 4) break;  // N = 64: a quarter of the lanes
          const int jj = g & (m - 1);
          const int a0 = ((g >> st) << (st + 2)) + jj;
          const float2 w1 = tw[jj << (LG - st)];  // W_{2m}^j
          rfft::butterfly(buf, a0, a0 + m, w1);
          rfft::butterfly(buf, a0 + 2 * m, a0 + 3 * m, w1);
          rfft::butterfly(buf, a0, a0 + 2 * m,
                          tw[jj << (LG - st - 1)]);  // W_{4m}^j
          rfft::butterfly(buf, a0 + m, a0 + 3 * m,
                          tw[(jj + m) << (LG - st - 1)]);  // W_{4m}^{j+m}
        }
        __syncwarp();
      }
      if ((LG - P) % 2) {  // the last stage alone
        constexpr int st = LG - 1, m = 1 << (LG - 1);
#pragma unroll
        for (int q = 0; q < 2 * G4; ++q) {
          const int b = lane + 32 * q;
          if (b >= H / 2) break;
          rfft::butterfly(buf, b, b + m, tw[b << (LG - st)]);
        }
        __syncwarp();
      }
    }
    // the post-step's powers of bins k = lane + 32 q, held until the warp
    // has read the spectrum, then the row over the buffer's start
    float pw[PL + 1];
#pragma unroll
    for (int q = 0; q <= PL; ++q) {
      const int k = lane + 32 * q;
      pw[q] = 0.f;
      if (k == 0 || k == H)
        pw[q] = edge_power<FLOOR_BINS>(buf[0], k == H, power_floor);
      else if (k < H)
        pw[q] = bin_power<FLOOR_BINS>(buf[rfft::slot(k)],
                                      buf[rfft::slot(H - k)], tw[k],
                                      power_floor);
    }
    __syncwarp();
    float* row = reinterpret_cast<float*>(buf);
#pragma unroll
    for (int q = 0; q <= PL; ++q)
      if (lane + 32 * q <= H) row[lane + 32 * q] = pw[q];
  }
}

// Phase 1 from BIG_N on: csrc/rfft_tile.cuh's big_fft_frames with this
// tile's loads, one frame a warp (f = warp): H/1024 rounds of 32 pairs a
// lane, five stages of each in registers, the stages across the rounds in
// the warp's buffer and the last five in column passes, twiddles computed
// where the table would not fit; the power row beside the buffer.
template <int N, bool FLOOR_BINS = true>
__device__ __forceinline__ void big_fft_frames(const rfft::SignalFrames& s,
                                               int nf, float* smem,
                                               float power_floor) {
  constexpr int H = N / 2;
  constexpr int PL = H / 32, P = rfft::log2i(PL);
  constexpr int R = rfft::rounds(N), PR = rfft::log2i(R);
  static_assert(rfft::round_pairs(N) == 32 && R * 32 == PL && jf(N) == 1,
                "rounds");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* tws = reinterpret_cast<const float2*>(smem);  // col_twiddles
  const int f = warp;
  if (f >= nf) return;  // warp-uniform
  const float2* mtw = tws + 16;
  float* reg = smem + tw_floats(N) + warp * region(N);
  float2* buf = reinterpret_cast<float2*>(reg);
  float* row = reg + row_at(N);
  const int base = rfft::brev_bits(lane, 5) << P;
  float2 r[32];
  // the rounds in a loop (not unrolled: R copies of a round's loads and
  // stages would only lengthen the build)
#pragma unroll 1
  for (int rd = 0; rd < R; ++rd) {
    float2 v[32];
    gather<N>(s, f, rd, lane, v);
#pragma unroll
    for (int q = 0; q < 32; ++q) r[rfft::brev_bits(q, 5)] = v[q];
    rfft::register_stages<5, 4>(r, tws);  // stages 0 .. 4
    const int off = base + 32 * (int)(__brev((unsigned)rd) >> (32 - PR));
#pragma unroll
    for (int t = 0; t < 32; ++t) buf[rfft::slot<P>(off + t)] = r[t];
  }
  // stages 5 .. P - 1 (spans 32 .. PL/2): within the lane's own block
#pragma unroll 1
  for (int st = 5; st < P; ++st) {
    const int m = 1 << st;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float2 w = mtw[m - 32 + j];
      for (int g = 0; g < PL / (2 * m); ++g)
        rfft::butterfly<P>(buf, base + 2 * m * g + j,
                           base + 2 * m * g + j + m, w);
    }
  }
  __syncwarp();  // every block is done before the columns cross them
#pragma unroll 1
  for (int u = 0; u < R; ++u) {  // stages P .. P + 4
    const int c = 32 * u + lane;
#pragma unroll
    for (int b = 0; b < 32; ++b) r[b] = buf[rfft::slot<P>(PL * b + c)];
    rfft::column_stages_computed<PL>(r, c);
#pragma unroll
    for (int b = 0; b < 32; ++b) buf[rfft::slot<P>(PL * b + c)] = r[b];
  }
  __syncwarp();
#pragma unroll 4
  for (int q = 0; q <= PL; ++q) {
    const int k = lane + 32 * q;
    if (k > H) break;
    if (k == 0 || k == H) {
      row[k] = edge_power<FLOOR_BINS>(buf[0], k == H, power_floor);
    } else {
      float sn, cs;
      sincospif((float)k / (float)H, &sn, &cs);  // W_N^k
      row[k] = bin_power<FLOOR_BINS>(buf[rfft::slot<P>(k)],
                                     buf[rfft::slot<P>(H - k)],
                                     make_float2(cs, -sn), power_floor);
    }
  }
}

// The tensor-core product, tf32, mma_tf32 and split: csrc/tf32_mma.cuh.

// Phase 2: the power rows onto the packed operator op (gpu_frontend.
// signal_operator: ac0, the operator's column of the first autocorrelation
// lag (int); the run table, runs [nch][G][KS][NPW + 1] (ints); each
// block's k-step, tags [nblk] (ints); padded to 4 ints; then the blocks'
// fragments, [32] float4 (hi(b0), hi(b1), lo(b0), lo(b1)) each, in the
// order of output chunk c, column group gi, k-split share s, n-tile jn,
// k-step). Warp w takes group gi = w / KS (and gi + WARPS / KS, ... where
// the groups outnumber the warps) and share s = w % KS, a run of k-steps
// holding about an even share of the group's blocks; for each of its NPW
// n-tiles in turn it walks that n-tile's blocks in its share: the A
// fragments loaded from the power rows at the block's k-step and split,
// the B fragments loaded from device memory as the wrapper split them,
// and the three products in chains of their own (hi.hi into the n-tile's
// sums, lo.hi and hi.lo into two sums added to them at the run's end), so
// that a block's three MMAs do not wait for each other. The n-tile is
// known when the code is compiled, so no register is indexed at run time
// and no branch is taken a block. Up to 512 outputs the partial sums go
// to red [KS][FT][NOP] and are added in order into sums [FT][NOP], the
// mel sums as log(max(., floor)), the
// autocorrelation moved from column ac0 to nmel (the wrapper may start it
// at an n-tile's first column, so that no n-tile holds both); it returns
// sums. Past 512 outputs (OPL 64: KS = 1, ac0 = nmel) each chunk's sums
// go straight to the tile's rows of wsums [nf][wstride], and it returns
// nullptr. Ends on a barrier.
template <int N, int OPL>
__device__ __forceinline__ float* project(const float4* __restrict__ op,
                                          int nf, float* smem, int nmel,
                                          int nac, float power_floor,
                                          int nchunk, float* wsums,
                                          int wstride) {
  constexpr int W = warps(N), FT = ft(N), H = N / 2, NOP = rfft::nop(OPL);
  constexpr int G = groups(OPL), NPW = npw(OPL), KS = ksplit(N, OPL);
  constexpr int GW = W / KS;
  static_assert(NPW * G == OPL && (G <= W || KS == 1), "groups");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, kslot = warp % KS;
  // frame f's power row: warp f % W's region, its (f / W)-th row
  const float* rows = smem + tw_floats(N) + row_at(N);
  const float* r0 =
      g < FT ? rows + (g % W) * region(N) + (g / W) * rs(N) : nullptr;
  const float* r1 = g + 8 < FT
                        ? rows + ((g + 8) % W) * region(N) + ((g + 8) / W) * rs(N)
                        : nullptr;
  float* red = smem + tw_floats(N);  // over the rows (or warp 0's buffer)
  const int nch = OPL == 64 ? nchunk : 1;
  const int* hdr = reinterpret_cast<const int*>(op);
  const int ac0 = __ldg(hdr);
  const int* runs = hdr + 1;
  const int* tags = hdr + run_ints(N, nch, OPL);
  const int nblk = __ldg(tags - 1);  // the last run's end
  const float4* frag = op + (run_ints(N, nch, OPL) + nblk + 3) / 4;

  for (int c = 0; c < nch; ++c) {
    for (int gi = warp / KS; gi < G; gi += GW) {
      const int* run = runs + ((c * G + gi) * KS + kslot) * (NPW + 1);
      float acc[NPW][4];
#pragma unroll
      for (int jn = 0; jn < NPW; ++jn) {
        const int p = __ldg(run + jn), q = __ldg(run + jn + 1);
        float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jn][i] = 0.f;
        for (int b = p; b < q; ++b) {
          const int k = 8 * __ldg(tags + b) + t;
          const float4 v = __ldg(frag + (size_t)b * 32 + lane);
          uint32_t ah[4], al[4];
          split(r0 && k <= H ? r0[k] : 0.f, ah[0], al[0]);
          split(r1 && k <= H ? r1[k] : 0.f, ah[1], al[1]);
          split(r0 && k + 4 <= H ? r0[k + 4] : 0.f, ah[2], al[2]);
          split(r1 && k + 4 <= H ? r1[k + 4] : 0.f, ah[3], al[3]);
          const uint32_t bh0 = __float_as_uint(v.x);
          const uint32_t bh1 = __float_as_uint(v.y);
          mma_tf32(s1, al, bh0, bh1);
          mma_tf32(s2, ah, __float_as_uint(v.z), __float_as_uint(v.w));
          mma_tf32(acc[jn], ah, bh0, bh1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jn][i] += s1[i] + s2[i];
      }
      // accumulator i of n-tile jn: row g (i < 2) or g + 8, column 2 t + i % 2
      if (nch > 1) {  // OPL 64: this chunk's sums leave for wsums
#pragma unroll
        for (int jn = 0; jn < NPW; ++jn)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int f = g + 8 * (i / 2);
            const int o = 8 * (gi * NPW + jn) + 2 * t + i % 2;
            if (f < nf)
              wsums[(size_t)f * wstride + NOP * c + o] =
                  NOP * c + o < nmel ? logf(fmaxf(acc[jn][i], power_floor))
                                     : acc[jn][i];
          }
        continue;
      }
      // below BIG_N red lies over the rows: one group a warp there, so
      // every warp passes this barrier once
      if constexpr (in_place(N)) __syncthreads();
#pragma unroll
      for (int jn = 0; jn < NPW; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = g + 8 * (i / 2);
          if (f < FT)
            red[(kslot * FT + f) * NOP + 8 * (gi * NPW + jn) + 2 * t + i % 2] =
                acc[jn][i];
        }
    }
  }
  __syncthreads();
  if (nch > 1) return nullptr;  // the sums are in wsums
  float* sums = red + KS * FT * NOP;
  for (int i = threadIdx.x; i < FT * NOP; i += nth(N)) {
    const int o = i % NOP, f = i / NOP;
    if (o >= nmel + nac) continue;
    const int src = f * NOP + (o < nmel ? o : o - nmel + ac0);
    float v = red[src];
#pragma unroll
    for (int k = 1; k < KS; ++k) v += red[k * FT * NOP + src];
    sums[i] = o < nmel ? logf(fmaxf(v, power_floor)) : v;
  }
  __syncthreads();
  return sums;
}

// The tile's sums: its samples toward L2 while the twiddles are
// computed, phase 1 (the power rows), then the projection. s loads the
// tile's frames; op is gpu_frontend.signal_operator's; returns sums
// [FT][NOP] (log-mel | autocorrelation), or past 512 outputs nullptr with
// the sums in wsums (project). The block is nth(N) threads with
// 4 * smem_floats(N, OPL) bytes of shared memory. FLOOR_BINS: the power
// floored per bin before the projection (K5's function; K1's floors the
// mel sums only, as every caller's log does).
template <int N, int OPL, bool FLOOR_BINS = true>
__device__ __forceinline__ float* signal_sums(const rfft::SignalFrames& s,
                                              int nf, float* smem,
                                              const float4* __restrict__ op,
                                              int nmel, int nac,
                                              float power_floor, int nchunk,
                                              float* wsums, int wstride) {
  static_assert(N >= rfft::MIN_N && N <= rfft::MAX_N && (N & (N - 1)) == 0,
                "N");
  static_assert(4 * smem_floats(N, OPL) <= rfft::MAX_SMEM, "tile");
  static_assert(in_place(N) || red_floats(N, OPL) <= buff(N), "red");
  prefetch_tile<nth(N)>(s, nf);
  twiddles<N>(smem);
  if constexpr (in_place(N))
    fft_frames<N, FLOOR_BINS>(s, nf, smem, power_floor);
  else
    big_fft_frames<N, FLOOR_BINS>(s, nf, smem, power_floor);
  __syncthreads();
  return project<N, OPL>(op, nf, smem, nmel, nac, power_floor, nchunk,
                         wsums, wstride);
}

// Levinson-Durbin of order p <= MAXP on the autocorrelation r [p + 1]:
// levinson_in_place (csrc/packed_tile.cuh) operation for operation, its
// coefficients a_1 .. a_p in registers (every index known when the loops
// are unrolled) where that one keeps them in a local array.
template <int MAXP>
__device__ __forceinline__ void levinson_registers(const float* r,
                                                   float (&a)[MAXP], int p) {
  float e = r[0];
#pragma unroll
  for (int i = 1; i <= MAXP; ++i) {
    if (i <= p) {  // every index below is known when it is compiled
      float s = r[i];
#pragma unroll
      for (int j = 1; j < i; ++j) s += a[j - 1] * r[i - j];
      const float k = -s / e;
#pragma unroll
      for (int j = 1, l = i - 1; j <= l; ++j, --l) {
        const float lo = a[j - 1], hi = a[l - 1];
        a[j - 1] = lo + k * hi;
        if (j < l) a[l - 1] = hi + k * lo;
      }
      a[i - 1] = k;
      e = e * (1.f - k * k);
    }
  }
}

// LPC of order p <= MAXP from the autocorrelation r [p + 1], into o [p]
// with non-finite coefficients zeroed. Not inlined: one copy serves every
// instance.
template <int MAXP>
__device__ __noinline__ void lpc_in_registers(const float* r, float* o,
                                              int p) {
  float a[MAXP];
  levinson_registers<MAXP>(r, a, p);
#pragma unroll
  for (int j = 0; j < MAXP; ++j)
    if (j < p) o[j] = isfinite(a[j]) ? a[j] : 0.f;
}

// The n_lpcc - 1 LPC cepstra of order p <= MAXP from the autocorrelation
// r [p + 1], into o: lpcc_in_place (csrc/packed_tile.cuh) on the unzeroed
// coefficients of levinson_registers, operation for operation, a_l read
// from registers and a_n (n < p) from o [n - 1], where it is put first
// and which c_n then takes. Not inlined, as lpc_in_registers.
template <int MAXP>
__device__ __noinline__ void lpcc_in_registers(const float* r, float* o,
                                               int p, int n_lpcc) {
  float a[MAXP];
  levinson_registers<MAXP>(r, a, p);
#pragma unroll
  for (int j = 0; j + 1 < MAXP; ++j)
    if (j + 1 < p && j + 1 < n_lpcc) o[j] = a[j];
  for (int n = 1; n < n_lpcc; ++n) {
    const int m = min(n, p);
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < MAXP; ++l) {
      if (l < m) {
        const float al = l == 0 ? 1.f : a[l - 1];
        const float cp = n - l - 1 == 0 ? 1.f : o[n - l - 2];
        s += al * cp * ((float)(n - l) / (float)(n + 1));
      }
    }
    o[n - 1] = n < p ? o[n - 1] + s : s;
  }
  for (int j = 0; j + 1 < n_lpcc; ++j) o[j] = isfinite(o[j]) ? -o[j] : 0.f;
}

// The features of the tile's nf frames from its sums, as tile_features
// (csrc/packed_tile.cuh) computes them with fuse_lpc: the cepstra, then
// the LPC, the LPC cepstra (n_lpcc > 0) or nothing; zeros from frame
// nvalid on. An order below 32 takes lpc_in_registers or
// lpcc_in_registers, a frame a thread, with lpcc_frames' rule for a lag 0
// below the least normal float (LPC cepstra 0); every other case is
// tile_features'.
template <int OPL, int NTH>
__device__ __forceinline__ void features(const float* sums,
                                         float* __restrict__ out, int nf,
                                         int nvalid,
                                         const float* __restrict__ dct,
                                         int nmel, int nac, int nceps,
                                         int stride, int n_lpcc) {
  constexpr int MAXP = 31;
  if (nac < 2 || nac > MAXP + 1) {  // block-uniform
    tile_features<OPL, NTH>(sums, out, nf, nvalid, dct, nmel, nac, nceps,
                            true, stride, n_lpcc);
    return;
  }
  const int order = nac - 1;
  const int w = n_lpcc > 0 ? n_lpcc - 1 : order, nfeat = nceps + w;
  for (int i = threadIdx.x; i < nf * nceps; i += NTH) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + (size_t)f * stride;
    float v = 0.f;
    for (int m = 0; m < nmel; ++m) v = fmaf(lm[m], dct[m * nceps + c], v);
    out[f * nfeat + c] = f < nvalid ? v : 0.f;
  }
  for (int f = threadIdx.x; f < nf; f += NTH) {
    float* o = out + f * nfeat + nceps;
    const float* r = sums + (size_t)f * stride + nmel;
    if (n_lpcc > 0 && f < nvalid && r[0] >= FLT_MIN)
      lpcc_in_registers<MAXP>(r, o, order, n_lpcc);
    else if (n_lpcc == 0 && f < nvalid)
      lpc_in_registers<MAXP>(sums + (size_t)f * stride + nmel, o, order);
    else
      for (int j = 0; j < w; ++j) o[j] = 0.f;
  }
}

// The host side of the signal kernels (csrc/frontend_full_signals.cu's
// full_signals_kernel and csrc/frontend_lpcc_signals.cu's
// lpcc_signals_kernel, which take the same arguments): `kernel` at N and
// OPL over B utterances, one launch per as many as keep its blocks below
// 2^31 (block i takes tile i % tiles of utterance i / tiles; each
// utterance's tiles are the same blocks in any launch, so the bits do not
// depend on the split).
using SignalKernel = void (*)(const float*, const int*, const float*,
                              const float4*, const float*, float*, int, int,
                              int, int, int, int, int, float, int, float,
                              int, int, float*);

template <int N, int OPL>
cudaError_t launch(SignalKernel kernel, int B, cudaStream_t st,
                   const float* sig, const int* nv, const float* win,
                   const float4* op, const float* dct, float* feat, int Lp,
                   int T, int flen, int fshift, int nmel, int nac,
                   int nceps, float pre_emph, int preemph_first,
                   float power_floor, int n_lpcc, float* wsums) {
  constexpr long long MAX_BLOCKS = 0x7fffffffLL;
  const int smem = 4 * smem_floats(N, OPL);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const size_t nfeat = feature_width(nceps, nac, 1, n_lpcc);
  const int nchunk = rfft::out_chunks(nmel + nac);
  const size_t wstride = (size_t)rfft::nop(OPL) * nchunk;
  const int tiles = (T + ft(N) - 1) / ft(N);
  const int per = (int)(MAX_BLOCKS / tiles);
  for (int b0 = 0; b0 < B; b0 += per) {
    const int nb = min(per, B - b0);
    kernel<<<nb * tiles, nth(N), smem, st>>>(
        sig + (size_t)b0 * Lp, nv + b0, win, op, dct,
        feat + (size_t)b0 * T * nfeat, Lp, T, flen, fshift, nmel, nac, nceps,
        pre_emph, preemph_first, power_floor, n_lpcc, nchunk,
        nchunk > 1 ? wsums + (size_t)b0 * T * wstride : wsums);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// `kernel` at N and OPL on this card: out[0] blocks an SM (the occupancy
// API, at the launch's threads and shared memory), out[1] registers and
// out[2] local bytes a thread, out[3] bytes of dynamic shared memory.
template <int N, int OPL>
cudaError_t occupancy(SignalKernel kernel, int* out) {
  const int smem = 4 * smem_floats(N, OPL);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, nth(N),
                                                       smem);
}

}  // namespace sigtile
}  // namespace
