// A shared-memory real FFT over a tile of frames, folded into mel and
// autocorrelation sums: the spectral stage of the signal frontend
// (csrc/frontend.cu, K1), the frame-level frontends (csrc/frontend_fft.cu,
// K5; csrc/frontend_frames_fft.cu, K4) and the fused predict monolith
// (csrc/predict_fused.cuh, K6/K7).
//
// It replaces the dense DFT products of two TPU kernels of
// speaker_recognition_tpu/ops/pallas_frontend.py: `_run` (wp . C, wp . S)
// and `_run_packed_signals` (frames . D). Both were shaped by the TPU's
// matrix unit; a real FFT of N points costs about 2.5 N log2 N flops
// (56 kFLOP a frame at N = 2048, against 6.3 MFLOP for the dense product
// of K5) and needs no operator larger than its twiddles, so neither C, S
// nor D streams through the blocks any more.
//
// For a tile of FT frames (ft(N): 32 up to N = 2048, 16 at 4096, 4 at 8192,
// 2 at 16384), with H = N/2 and P = H + 1 bins:
//   1. each warp takes frames w, w + WARPS, ...: its lanes gather sample
//      pairs z[n] = x[2n] + i x[2n+1] (x from the caller's loader: window,
//      pre-emphasis and the fold of samples n >= N onto n mod N happen
//      there; the next loads fly during this frame's FFT), run an H-point
//      radix-2 complex FFT (tile_sums says how its stages split between
//      registers and the warp's shared buffer), and the real-input
//      post-step gives the power |X[k]|^2 of bins 0..H, floored per bin
//      when PER_BIN_FLOOR, into row f of ys [FT][P] (P odd: a column read
//      by 32 lanes hits 32 banks);
//   2. the block walks the bins in chunks of CK (4 to 32 rows, as shared
//      memory allows; project_bins, which the chirp-z kernel of
//      csrc/frontend_chirp.cu and the four-step route's fused pass of
//      csrc/rfft_big.cuh share), staging the chunk's rows of [mel |
//      acorr | 0] ([CK][NOP], NOP = 8 * OPL, from a packed copy the
//      wrapper makes once) in shared memory; lane l of a warp takes frame
//      l % FT (32 / FT lanes a frame), and the warps and the lane groups
//      of a warp split
//      the 4-column groups, so each y is loaded once per bin and group slot
//      and each 16-byte operator load is a broadcast; a group whose staged
//      block is all zero (a mel filter far from the chunk) is skipped, so
//      the triangular filters cost about their nonzeros;
//   3. the sums leave as log(max(mel, floor)) and the raw autocorrelation
//      in sums [FT][NOP], the layout of tile_features (packed_tile.cuh).
// The geometry follows N (ft, warps): 8 warps and 32-frame tiles up to
// N = 2048; four warps and 16-frame tiles at N = 4096, since a tile's power
// rows alone (16 x 2049 floats) and four FFT buffers take ~200 KB of the
// 227 KB a block may use; at N = 8192 four warps and 4-frame tiles, at
// N = 16384 two warps and 2-frame tiles (~200 KB each), where the twiddles
// are no longer staged whole (below). OPL is 9, 16, 32 or 64 (72, 128, 256
// or 512 outputs). No spectrum reaches device memory. Every sum runs in a
// fixed order and there are no atomics, so two calls give the same bits.
//
// What bounds it: the least work is bytes at 48 kHz (the frames, 6 KB
// each, read once) and FLOPs at 8 kHz (the dense bin-domain mel operator);
// the kernels stay well above that, bound by instruction issue and
// shared-memory latency at few warps per SM (one block per SM at N >= 2048,
// where the tile takes ~200-231 KB). What the design does about it: every
// load of a frame is straight-line code, so a lane's loads all fly at once;
// the FFT keeps at most 32 values a lane in registers and touches shared
// memory only to move data between lanes (one transpose at N = 2048; from
// N = 4096 on, H/1024 rounds of 32 pairs a lane, the stages across a
// lane's rounds in shared memory and the last five in column passes of 32
// slots; two-stage passes below 2048); the projection reads a pre-packed
// operator with 16-byte copies and skips zero blocks.
// speaker_recognition_tpu_torch/tools/fft_ablation.py times each stage.
//
// Twiddles come from sincospif (the angle 2k/N is exact in f32), no fast
// intrinsics: the build has no --use_fast_math, and the cepstra feed a log
// and a Levinson recursion. Up to N = 4096 they are staged whole in shared
// memory; at N >= 8192 a table of H float2 would take 32-64 KB of the
// frames' room, so only the 16 register-stage twiddles and the few hundred
// of the stages across a lane's rounds are staged, and the column stages
// and the post-step compute theirs where they use them (the same values:
// sincospif of the same exact angles).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {
namespace rfft {

constexpr int MIN_N = 64;    // every lane holds at least one sample pair
constexpr int MAX_N = 16384;
constexpr int BIG_N = 8192;  // from here on the twiddles are not staged whole
constexpr int MAX_SMEM = 232448;

// frames a tile, warps a block and threads a block at an N-point FFT
__host__ __device__ constexpr int ft(int n) {
  return n >= 16384 ? 2 : n >= 8192 ? 4 : n >= 4096 ? 16 : 32;
}
__host__ __device__ constexpr int warps(int n) {
  return n >= 16384 ? 2 : n >= 4096 ? 4 : 8;
}
__host__ __device__ constexpr int nth(int n) { return 32 * warps(n); }

__host__ __device__ constexpr int nop(int opl) { return 8 * opl; }

// bins per staged operator chunk: 16, which lets four blocks share an SM
// at N = 512; 32 at N = 2048 (16 for 256 outputs, 8 for 512), where one
// block fills it anyway; 16 at N = 4096 (8 for 256 outputs, 4 for 512),
// which is what is left; 16 from N = 8192 on (8 for 512 outputs)
__host__ __device__ constexpr int ck(int n, int opl) {
  return n >= BIG_N ? (opl > 32 ? 8 : 16)
         : n >= 4096 ? (opl > 32 ? 4 : opl > 16 ? 8 : 16)
         : n >= 2048 ? (opl > 32 ? 8 : opl > 16 ? 16 : 32) : 16;
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// float2 slots of a warp's FFT buffer: H, plus one pad slot every 32 so
// that the 32 lanes' contiguous blocks start in different banks; from
// N = 8192 on one pad slot after each lane's block of H/32 slots, which
// does the same for blocks of any length
__host__ __device__ constexpr int buf_slots(int n) {
  return n >= BIG_N ? n / 2 + 32 : n / 2 + n / 64;
}

// float2 twiddles of the stages that pair slots of different lanes'
// blocks (32 pairs per lane and more, N >= 2048): W_{2m}^j, j < m, for
// m = 32, 64, ..., H/4. From N = 8192 on: W_32^k (k < 16) for the register
// stages, then only the spans of the stages across a lane's rounds, m =
// 32, ..., H/64.
__host__ __device__ constexpr int col_twiddles(int n) {
  return n >= BIG_N ? 16 + n / 64 - 32 : n >= 2048 ? n / 4 - 32 : 0;
}

// floats of the power rows ys [FT][H + 1], which then hold the sums
// [FT][NOP]; a multiple of 4, so that the operator chunk after them is
// 16-byte aligned
__host__ __device__ constexpr int ys_floats(int n, int opl) {
  return (ft(n) * (n / 2 + 1 > nop(opl) ? n / 2 + 1 : nop(opl)) + 3) / 4 * 4;
}

// floats of shared memory: twiddles [H] (float2; none from N = 8192 on),
// per-warp buffers [WARPS][buf_slots] (float2), ys, operator chunk
// [ck][NOP], column-stage twiddles (float2)
__host__ __device__ constexpr int smem_floats(int n, int opl) {
  return (n >= BIG_N ? 0 : n) + 2 * warps(n) * buf_slots(n) +
         ys_floats(n, opl) + ck(n, opl) * nop(opl) + 2 * col_twiddles(n);
}

// the padded buffer slot of FFT element i: one pad slot every 2^SH slots
template <int SH = 5>
__device__ __forceinline__ int slot(int i) { return i + (i >> SH); }

// Output chunks of 8 * 64 = 512 a tile projects onto one after the other
// (tile_sums' `nchunk`): 1 up to 512 outputs.
__host__ __device__ constexpr int out_chunks(int nout) {
  return nout <= 512 ? 1 : (nout + 511) / 512;
}

// OPL for nout = nmel + nac outputs: 9, 16, 32 or 64 (72, 128, 256 or 512
// columns; past 512 outputs OPL 64 and out_chunks(nout) chunks)
inline int opl_of(int nout) {
  return nout <= 72 ? 9 : nout <= 128 ? 16 : nout <= 256 ? 32 : 64;
}

// OPL for nout outputs at an N-point FFT, or 0 when N is not a power of two
// in [MIN_N, MAX_N] or, unless `chunked`, nout > 512.
inline int pick_opl(int n, int nout, bool chunked = false) {
  if (n < MIN_N || n > MAX_N || (n & (n - 1)) != 0) return 0;
  const int o = nout <= 512 || chunked ? opl_of(nout) : 0;
  if (o == 0 || 4 * smem_floats(n, o) > MAX_SMEM) return 0;
  return o;
}

// rows of the packed operator at an N-point FFT: bins 0..N/2, zero rows to
// a multiple of ck(n, opl); a chunked operator stacks out_chunks of them
__host__ __device__ constexpr int op_rows(int n, int opl) {
  return (n / 2 + 1 + ck(n, opl) - 1) / ck(n, opl) * ck(n, opl);
}

// f(std::integral_constant<int, N>{}) for the FFT sizes the tile takes
template <class F>
cudaError_t with_n(int n, F&& f) {
  switch (n) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 2048: return f(std::integral_constant<int, 2048>{});
    case 4096: return f(std::integral_constant<int, 4096>{});
    case 8192: return f(std::integral_constant<int, 8192>{});
    case 16384: return f(std::integral_constant<int, 16384>{});
  }
  return cudaErrorInvalidValue;
}

// f(std::integral_constant<int, OPL>{}) for the operator widths
template <class F>
cudaError_t with_opl(int opl, F&& f) {
  switch (opl) {
    case 9: return f(std::integral_constant<int, 9>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
  }
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__host__ __device__ constexpr int brev_bits(int x, int bits) {
  return bits == 0 ? 0 : ((x & 1) << (bits - 1)) | brev_bits(x >> 1, bits - 1);
}

// Sample pairs a lane holds at once at an N-point FFT, and the rounds of
// them a frame takes: H/32 pairs a lane, in rounds of at most 32.
__host__ __device__ constexpr int rounds(int n) {
  return n / 64 > 32 ? n / 64 / 32 : 1;
}
__host__ __device__ constexpr int round_pairs(int n) {
  return n / 64 / rounds(n);
}

// Lane `lane`'s sample pairs of frame f in round rd: pair j = lane +
// 32 (R q + rd) is (x[2j], x[2j+1]), R = rounds(N); zeros for a frame past
// the tile's nf. The loads are straight-line code, so all of them are in
// flight at once; load.fold then adds what a frame longer than N folds
// onto them.
template <int N, class Load>
__device__ __forceinline__ void gather(const Load& load, int f, int rd,
                                       int nf, int lane,
                                       float2 (&v)[round_pairs(N)]) {
  constexpr int R = rounds(N), RP = round_pairs(N);
  const auto first = [&](int q) { return 2 * (lane + 32 * (R * q + rd)); };
  if (f < nf) {  // warp-uniform
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const int p = first(q);
      v[q] = make_float2(load(f, p), load(f, p + 1));
    }
    load.fold(f, v, first);
  } else {
#pragma unroll
    for (int q = 0; q < RP; ++q) v[q] = make_float2(0.f, 0.f);
  }
}

// Rows [k0, k0 + CK) of the packed operator op [rows][NOP] ([mel | acorr
// | 0], rows a multiple of CK) as this thread stages them: float4 i =
// tid + NTH q of the chunk, where it exists.
template <int CK, int OPL, int NTH>
__device__ __forceinline__ void fetch_chunk(
    float4 (&v)[(CK * nop(OPL) / 4 + NTH - 1) / NTH], int k0, int tid,
    const float4* __restrict__ op) {
  constexpr int N4 = CK * nop(OPL) / 4;
  const float4* src = op + (size_t)k0 * (nop(OPL) / 4);
#pragma unroll
  for (int q = 0; q < (N4 + NTH - 1) / NTH; ++q) {
    const int i = tid + NTH * q;
    if (i < N4) v[q] = src[i];
  }
}

// One radix-2 butterfly of stage s (span m = 2^s) on slots a, b:
// (u, v) -> (u + w v, u - w v) with w = W_{2m}^j, j the inner index of a.
template <int SH = 5>
__device__ __forceinline__ void butterfly(float2* buf, int a, int b,
                                          float2 w) {
  const float2 t = cmul(w, buf[slot<SH>(b)]);
  const float2 u = buf[slot<SH>(a)];
  buf[slot<SH>(a)] = make_float2(u.x + t.x, u.y + t.y);
  buf[slot<SH>(b)] = make_float2(u.x - t.x, u.y - t.y);
}

// The radix-2 stages 0..NS-1 on n values in registers, r[t] holding slot
// base + t of a contiguous block (base a multiple of n); tw holds
// W_{2^(LG+1)}^k for k < 2^LG (LG = log2(H): the whole table; 4: W_32^k).
template <int NS, int LG, int RN>
__device__ __forceinline__ void register_stages(float2 (&r)[RN],
                                                const float2* tw) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int m = 1 << s;
#pragma unroll
    for (int t = 0; t < RN; ++t) {
      if (t & m) continue;
      const float2 w = tw[(t & (m - 1)) << (LG - s)];
      const float2 u = r[t], v = cmul(w, r[t + m]);
      r[t] = make_float2(u.x + v.x, u.y + v.y);
      r[t + m] = make_float2(u.x - v.x, u.y - v.y);
    }
  }
}

// Five stages s0 .. s0 + 4 over the values r[b] of slots CB * b + c (b <
// 32, c the lane's column; CB a power of two, 2^s0 = CB): stage s0 + s2
// pairs b with b + 2^s2, and its twiddle W_{2m}^j, m = CB 2^s2, j = CB
// (b mod 2^s2) + c, comes from ctw (the tables of m <= H/4) or tw (m = H/2).
template <int CB, int H>
__device__ __forceinline__ void column_stages(float2 (&r)[32], int c,
                                              const float2* tw,
                                              const float2* ctw) {
#pragma unroll
  for (int s2 = 0; s2 < 5; ++s2) {
    const int mb = 1 << s2, m = CB << s2;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (b & mb) continue;
      const int j = CB * (b & (mb - 1)) + c;
      const float2 w = m < H / 2 ? ctw[m - 32 + j] : tw[j << 1];
      const float2 u = r[b], v = cmul(w, r[b + mb]);
      r[b] = make_float2(u.x + v.x, u.y + v.y);
      r[b + mb] = make_float2(u.x - v.x, u.y - v.y);
    }
  }
}

// column_stages with every twiddle computed where it is used, for
// N >= 8192: stage s0 + s2 takes mb = 2^s2 distinct twiddles W_{2m}^j, j =
// CB jb + c (jb < mb), each computed once for its 16 / mb butterflies.
template <int CB>
__device__ __forceinline__ void column_stages_computed(float2 (&r)[32],
                                                       int c) {
#pragma unroll
  for (int s2 = 0; s2 < 5; ++s2) {
    const int mb = 1 << s2, m = CB << s2;
#pragma unroll
    for (int jb = 0; jb < mb; ++jb) {
      float sn, cs;
      sincospif((float)(CB * jb + c) / (float)m, &sn, &cs);  // W_{2m}^j
      const float2 w = make_float2(cs, -sn);
#pragma unroll
      for (int b = jb; b < 32; b += 2 * mb) {
        const float2 u = r[b], v = cmul(w, r[b + mb]);
        r[b] = make_float2(u.x + v.x, u.y + v.y);
        r[b + mb] = make_float2(u.x - v.x, u.y - v.y);
      }
    }
  }
}

// Phase 1 of tile_sums from N = 8192 on (H/32 = 2^P pairs a lane, R =
// H/1024 rounds of 32): one frame per warp at a time, its power rows into
// ys [FT][H + 1]. Round rd of a lane's pairs (j = lane + 32 (R q + rd))
// fills the 32 slots brev_LG(j) = base + 32 brev(rd) + brev5(q) of the
// lane's block (base = brev5(lane) 2^P) after five stages in registers;
// the P - 5 stages across the rounds run on the lane's own block in shared
// memory, and the last five in R column passes of 32 slots (columns lane,
// lane + 32, ...). tws holds W_32^k (k < 16), then W_{2m}^j for m = 32 ..
// H/64. The buffer pads one slot after each lane's block (slot<P>).
template <int N, class Load>
__device__ __forceinline__ void big_fft_frames(const Load& load, int nf,
                                               float2* buf, float* ys,
                                               const float2* tws,
                                               float power_floor,
                                               bool per_bin_floor) {
  constexpr int FT = ft(N), WARPS = warps(N);
  constexpr int H = N / 2, NB = H + 1;
  constexpr int PL = H / 32, P = log2i(PL);
  constexpr int R = rounds(N), PR = log2i(R);
  static_assert(round_pairs(N) == 32 && R * 32 == PL, "rounds");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* mtw = tws + 16;

  float2 nxt[32];
  gather<N>(load, warp, 0, nf, lane, nxt);
  __syncthreads();  // the tables are staged

  const int base = brev_bits(lane, 5) << P;
  for (int f = warp; f < FT; f += WARPS) {
    float2 r[32];
    // the rounds in a loop (not unrolled: R copies of a round's loads and
    // stages would only lengthen the build)
#pragma unroll 1
    for (int rd = 0; rd < R; ++rd) {
#pragma unroll
      for (int q = 0; q < 32; ++q) r[brev_bits(q, 5)] = nxt[q];
      if (rd + 1 < R)
        gather<N>(load, f, rd + 1, nf, lane, nxt);
      else if (f + WARPS < FT)
        gather<N>(load, f + WARPS, 0, nf, lane, nxt);
      register_stages<5, 4>(r, tws);  // stages 0 .. 4
      const int off = base + 32 * (int)(__brev((unsigned)rd) >> (32 - PR));
#pragma unroll
      for (int t = 0; t < 32; ++t) buf[slot<P>(off + t)] = r[t];
    }
    // stages 5 .. P - 1 (spans 32 .. PL/2): within the lane's own block
#pragma unroll 1
    for (int s = 5; s < P; ++s) {
      const int m = 1 << s;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float2 w = mtw[m - 32 + j];
        for (int g = 0; g < PL / (2 * m); ++g)
          butterfly<P>(buf, base + 2 * m * g + j, base + 2 * m * g + j + m,
                       w);
      }
    }
    __syncwarp();  // every block is done before the columns cross them
#pragma unroll 1
    for (int u = 0; u < R; ++u) {  // stages P .. P + 4
      const int c = 32 * u + lane;
#pragma unroll
      for (int b = 0; b < 32; ++b) r[b] = buf[slot<P>(PL * b + c)];
      column_stages_computed<PL>(r, c);
#pragma unroll
      for (int b = 0; b < 32; ++b) buf[slot<P>(PL * b + c)] = r[b];
    }
    __syncwarp();
    // real-input post-step, as in tile_sums, W_N^k computed
#pragma unroll 4
    for (int q = 0; q <= PL; ++q) {
      const int k = lane + 32 * q;
      if (k > H) break;
      float p;
      if (k == 0 || k == H) {
        const float2 z = buf[0];
        const float x = k == 0 ? z.x + z.y : z.x - z.y;
        p = x * x;
      } else {
        const float2 a = buf[slot<P>(k)], b = buf[slot<P>(H - k)];
        const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
        float sn, cs;
        sincospif((float)k / (float)H, &sn, &cs);  // W_N^k
        const float2 wo = cmul(make_float2(cs, -sn), o);
        const float xr = e.x + wo.x, xi = e.y + wo.y;
        p = xr * xr + xi * xi;
      }
      if (per_bin_floor) p = fmaxf(p, power_floor);
      ys[f * NB + k] = p;
    }
    __syncwarp();  // every lane has read buf before the next frame fills it
  }
}

// Groups of 4 outputs a stage-2 lane sums in project_bins: the NOP / 4
// groups over the WARPS * 32 / FT group slots of a block.
__host__ __device__ constexpr int proj_gpw(int ft_, int warps_, int opl) {
  return (nop(opl) / 4 + warps_ * (32 / ft_) - 1) / (warps_ * (32 / ft_));
}

// Stage 2 of tile_sums, shared with the chirp-z kernel (csrc/
// frontend_chirp.cu) and the four-step route's fused pass (csrc/
// rfft_big.cuh): FT frames' power rows projected onto the packed operator
// op [nch * rows][NOP] ([mel | acorr | 0], chunk c of outputs from row c *
// rows), by a block of WARPS warps, nb bins in chunks of CK. Lane l takes
// frame fl = l % FT; group slot (warp, gh = l / FT) takes the groups g =
// warp + WARPS (gh + LPF i). A group whose staged block is all zero (a mel
// filter far from the chunk) is skipped, so each output's FMAs run over
// the bins in order and the skipped ones are exact zeros. Every thread
// calls fill(k0) before the barrier that publishes chunk k0; it may stage
// the chunk's power and returns the column of ys [FT][ystride] that holds
// bin k0. After output chunk c, emit(c, fl, gh) reads the sums in acc; the
// walk starts on a barrier and its last chunk ends on the readers of opc
// and ys. The next chunk's operator rows are fetched into registers while
// this one is summed. A chunk's FMAs run bin by bin over the slot's active
// groups (the tile's order: each y loaded once, best where most groups are
// active, as at 8 kHz), or, with GROUPS_OUTSIDE, group by group over the
// bins (best where few are: 200 mel filters over 751 bins). Both orders
// give each output the same FMAs in the same order.
template <int FT, int WARPS, int OPL, int CK, bool GROUPS_OUTSIDE = false,
          class Fill, class Emit>
__device__ __forceinline__ void project_bins(
    const float4* __restrict__ op, int rows, int nb, int nch, float* opc,
    const float* ys, int ystride, const Fill& fill, const Emit& emit,
    float (&acc)[proj_gpw(FT, WARPS, OPL)][4]) {
  constexpr int NTH = 32 * WARPS, NOP = nop(OPL), NG = NOP / 4;
  constexpr int LPF = 32 / FT, GPW = proj_gpw(FT, WARPS, OPL);
  constexpr int N4 = CK * NOP / 4;           // float4 of a chunk
  constexpr int PER = (N4 + NTH - 1) / NTH;  // ... staged per thread
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fl = lane % FT, gh = lane / FT;
  const unsigned peers =
      FT == 32 ? 0xffffffffu : ((1u << FT) - 1u) << (FT * gh);
  const float* yrow = ys + fl * ystride;
  // the chunk's sums, its operator rows at oc and bins k0 .. k0 + kw - 1
  // at yrow[y0 ..]
  const auto sum_chunk = [&](const float* oc, int y0, int kw) {
    // uniform over a group slot's lanes: skip a group that is zero over
    // the whole chunk (each lane tests rows fl % CK, + FT, ... < CK)
    bool act[GPW];
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      const int g = warp + WARPS * (gh + LPF * i);
      bool nz = false;
      if (g < NG)
        for (int rr = fl % CK; rr < CK; rr += FT) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(oc + rr * NOP + 4 * g);
          nz = nz || w4.x != 0.f || w4.y != 0.f || w4.z != 0.f ||
               w4.w != 0.f;
        }
      act[i] = (__ballot_sync(0xffffffffu, nz) & peers) != 0u;
    }
    if constexpr (GROUPS_OUTSIDE) {  // each active group walks the bins
#pragma unroll
      for (int i = 0; i < GPW; ++i) {
        if (!act[i]) continue;
        const float* wcol = oc + 4 * (warp + WARPS * (gh + LPF * i));
#pragma unroll 4
        for (int kk = 0; kk < kw; ++kk) {
          const float y = yrow[y0 + kk];
          const float4 w = *reinterpret_cast<const float4*>(wcol + kk * NOP);
          acc[i][0] = fmaf(y, w.x, acc[i][0]);
          acc[i][1] = fmaf(y, w.y, acc[i][1]);
          acc[i][2] = fmaf(y, w.z, acc[i][2]);
          acc[i][3] = fmaf(y, w.w, acc[i][3]);
        }
      }
    } else {  // each y is loaded once for the slot's active groups
#pragma unroll 4
      for (int kk = 0; kk < kw; ++kk) {
        const float y = yrow[y0 + kk];
#pragma unroll
        for (int i = 0; i < GPW; ++i) {
          if (!act[i]) continue;
          const float4 w = *reinterpret_cast<const float4*>(
              oc + kk * NOP + 4 * (warp + WARPS * (gh + LPF * i)));
          acc[i][0] = fmaf(y, w.x, acc[i][0]);
          acc[i][1] = fmaf(y, w.y, acc[i][1]);
          acc[i][2] = fmaf(y, w.z, acc[i][2]);
          acc[i][3] = fmaf(y, w.w, acc[i][3]);
        }
      }
    }
  };
  float4* opc4 = reinterpret_cast<float4*>(opc);
  for (int c = 0; c < nch; ++c) {
    const float4* opx = op + (size_t)c * rows * (NOP / 4);
#pragma unroll
    for (int i = 0; i < GPW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    float4 pre[PER];
    fetch_chunk<CK, OPL, NTH>(pre, 0, tid, opx);
    for (int k0 = 0; k0 < nb; k0 += CK) {
      __syncthreads();  // the FFTs, or the previous chunk's readers, are done
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (tid + NTH * q < N4) opc4[tid + NTH * q] = pre[q];
      const int y0 = fill(k0);
      __syncthreads();
      if (k0 + CK < nb) fetch_chunk<CK, OPL, NTH>(pre, k0 + CK, tid, opx);
      sum_chunk(opc, y0, min(CK, nb - k0));
    }
    emit(c, fl, gh);
  }
}

// Load(f, p) gives sample p in [0, N) of the tile's frame f < nf, in
// straight-line code (no loop, no branch); load.fold(f, v, first) adds the
// samples p + N, p + 2N, ... of a longer frame to gather's pairs (first(q)
// is pair q's first sample). op is the packed operator [rows][NOP]: row k
// holds bin k's mel weights, then its autocorrelation weights, then zeros;
// rows past N/2 are zero and there are a multiple of ck(N, OPL) of them.
// Returns sums [FT][NOP]; ends on a barrier. The block is nth(N) threads.
// Past 512 outputs (OPL 64, nchunk > 1) op stacks nchunk such operators,
// chunk c holding outputs [512 c, 512 c + 512); the power rows stay in
// shared memory while the block projects onto one chunk after the other,
// and each chunk's sums go to the tile's rows of wsums [nf][wstride] in
// device memory (the DCT needs every mel energy of a frame); then it
// returns nullptr. Each output's FMAs run over the bins in the same order
// whatever the count, so at most 512 outputs keep their bits inside a
// larger call.
//
// The FFT: pair j = lane + 32 q of a frame goes to slot brev(j) of the
// warp's buffer, which is (brev5(lane) << p) | brev_p(q) with 2^p = H/32
// pairs per lane: each lane's pairs fill a contiguous block of 2^p slots,
// so the first p radix-2 stages run in registers. The other five pair
// blocks of different lanes at the same offset: at 32 pairs per lane
// (N = 2048) a transpose through the buffer gives lane t every block's
// slot t and they run in registers too; below that they run in shared
// memory two at a time (each lane loads 4 slots, runs both stages,
// stores them), one __syncwarp apart. At 64 pairs per lane (N = 4096) a
// lane takes its pairs in two rounds of 32 (q even, then odd: the two
// halves of its block), runs five stages on each in registers, the sixth
// (across the halves) in shared memory, and the last five as at N = 2048
// in two column passes of 32 slots (column t, then t + 32).
template <int N, int OPL, bool PER_BIN_FLOOR, class Load>
__device__ __forceinline__ float* tile_sums(
    const Load& load, int nf, float* smem, const float4* __restrict__ op,
    int nmel, float power_floor, int nchunk = 1, float* wsums = nullptr,
    int wstride = 0) {
  constexpr int FT = ft(N), WARPS = warps(N), NTH = nth(N);
  constexpr int NOP = nop(OPL);
  constexpr int NG = NOP / 4;                  // 4-column groups
  constexpr int LPF = 32 / FT;                 // stage-2 lanes a frame
  constexpr int GPW = proj_gpw(FT, WARPS, OPL);
  constexpr int H = N / 2, NB = H + 1, LG = log2i(H);
  constexpr int PL = H / 32, P = log2i(PL);     // pairs per lane
  constexpr int R = rounds(N), RP = round_pairs(N), PR = log2i(RP);
  constexpr int G4 = H >= 128 ? H / 128 : 1;    // 4-slot groups per lane
  constexpr int CK = ck(N, OPL);
  static_assert(N >= MIN_N && N <= MAX_N && (N & (N - 1)) == 0, "N");
  static_assert(R * RP == PL && (R == 1 || RP == 32), "rounds");
  static_assert(4 * smem_floats(N, OPL) <= MAX_SMEM, "tile");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  constexpr int TWF = N >= BIG_N ? 0 : N;  // floats of the staged twiddles
  float2* buf = reinterpret_cast<float2*>(smem + TWF) +
                warp * buf_slots(N);                      // this warp's, padded
  float* ys = smem + TWF + 2 * WARPS * buf_slots(N);       // [FT][NB]
  float* opc = ys + ys_floats(N, OPL);                     // [CK][NOP]
  float2* ctw = reinterpret_cast<float2*>(opc + CK * NOP);  // col_twiddles

  // 1. one frame per warp at a time; the next round's loads fly during
  // this one's stages
  if constexpr (N >= BIG_N) {
    for (int i = tid; i < col_twiddles(N); i += NTH) {
      float s, c;
      if (i < 16) {
        sincospif((float)i / 16.f, &s, &c);  // W_32^i
      } else {
        const int m = 1 << (31 - __clz(i - 16 + 32));  // the table of span m
        sincospif((float)(i - 16 + 32 - m) / (float)m, &s, &c);  // W_{2m}^j
      }
      ctw[i] = make_float2(c, -s);
    }
    big_fft_frames<N>(load, nf, buf, ys, ctw, power_floor, PER_BIN_FLOOR);
  } else {
    float2* tw = reinterpret_cast<float2*>(smem);  // [H]
    for (int k = tid; k < H; k += NTH) {  // W_N^k = exp(-2 pi i k / N)
      float s, c;
      sincospif(2.f * (float)k / (float)N, &s, &c);
      tw[k] = make_float2(c, -s);
    }
    for (int i = tid; i < col_twiddles(N); i += NTH) {
      const int m = 1 << (31 - __clz(i + 32));  // the table of span m
      float s, c;
      sincospif((float)(i + 32 - m) / (float)m, &s, &c);  // W_{2m}^j
      ctw[i] = make_float2(c, -s);
    }
    float2 nxt[RP];
    gather<N>(load, warp, 0, nf, lane, nxt);
    __syncthreads();

    const int base = brev_bits(lane, 5) << P;
    for (int f = warp; f < FT; f += WARPS) {
      float2 r[RP];
  #pragma unroll
      for (int rd = 0; rd < R; ++rd) {
  #pragma unroll
        for (int q = 0; q < RP; ++q) r[brev_bits(q, PR)] = nxt[q];
        if (rd + 1 < R)
          gather<N>(load, f, rd + 1, nf, lane, nxt);
        else if (f + WARPS < FT)
          gather<N>(load, f + WARPS, 0, nf, lane, nxt);
        register_stages<PR, LG>(r, tw);  // stages within the round's block
  #pragma unroll
        for (int t = 0; t < RP; ++t) buf[slot(base + RP * rd + t)] = r[t];
      }
      __syncwarp();
      if constexpr (R == 2) {
        // stage 5 (span 32) pairs the two rounds' halves of the lane's block
  #pragma unroll 8
        for (int t = 0; t < 32; ++t) butterfly(buf, base + t, base + t + 32,
                                               ctw[t]);
        __syncwarp();
  #pragma unroll
        for (int u = 0; u < 2; ++u) {  // columns lane and lane + 32
          const int c = 32 * u + lane;
  #pragma unroll
          for (int b = 0; b < 32; ++b) r[b] = buf[slot(64 * b + c)];
          column_stages<64, H>(r, c, tw, ctw);  // stages 6 .. 10
  #pragma unroll
          for (int b = 0; b < 32; ++b) buf[slot(64 * b + c)] = r[b];
        }
        __syncwarp();
      } else if constexpr (PL == 32) {
  #pragma unroll
        for (int b = 0; b < 32; ++b) r[b] = buf[slot(32 * b + lane)];
        column_stages<32, H>(r, lane, tw, ctw);  // stages 5 .. 9
        __syncwarp();  // every lane has read its column before any is written
  #pragma unroll
        for (int b = 0; b < 32; ++b) buf[slot(32 * b + lane)] = r[b];
        __syncwarp();
      } else {
  #pragma unroll
        for (int s = P; s + 1 < LG; s += 2) {  // stages s and s + 1
          const int m = 1 << s;
  #pragma unroll
          for (int q = 0; q < G4; ++q) {
            const int g = lane + 32 * q;
            if (g >= H / 4) break;  // N = 64: a quarter of the lanes
            const int j = g & (m - 1);
            const int a0 = ((g >> s) << (s + 2)) + j;
            const float2 w1 = tw[j << (LG - s)];           // W_{2m}^j
            butterfly(buf, a0, a0 + m, w1);
            butterfly(buf, a0 + 2 * m, a0 + 3 * m, w1);
            butterfly(buf, a0, a0 + 2 * m, tw[j << (LG - s - 1)]);  // W_{4m}^j
            butterfly(buf, a0 + m, a0 + 3 * m,
                      tw[(j + m) << (LG - s - 1)]);        // W_{4m}^{j+m}
          }
          __syncwarp();
        }
        if ((LG - P) % 2) {  // the last stage alone
          constexpr int s = LG - 1, m = 1 << (LG - 1);
  #pragma unroll
          for (int q = 0; q < 2 * G4; ++q) {
            const int b = lane + 32 * q;
            if (b >= H / 2) break;
            butterfly(buf, b, b + m, tw[b << (LG - s)]);
          }
          __syncwarp();
        }
      }
      // real-input post-step: X[k] = E[k] + W_N^k O[k] with
      // E = (Z[k] + conj Z[H-k]) / 2, O = (Z[k] - conj Z[H-k]) / 2i
  #pragma unroll
      for (int q = 0; q <= PL; ++q) {
        const int k = lane + 32 * q;
        if (k > H) break;
        float p;
        if (k == 0 || k == H) {
          const float2 z = buf[0];
          const float x = k == 0 ? z.x + z.y : z.x - z.y;
          p = x * x;
        } else {
          const float2 a = buf[slot(k)], b = buf[slot(H - k)];
          const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
          const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
          const float2 wo = cmul(tw[k], o);
          const float xr = e.x + wo.x, xi = e.y + wo.y;
          p = xr * xr + xi * xi;
        }
        if (PER_BIN_FLOOR) p = fmaxf(p, power_floor);
        ys[f * NB + k] = p;
      }
      __syncwarp();  // every lane has read buf before the next frame fills it
    }
  }

  // 2. [mel | acorr] by chunks of bins (project_bins); past 512 outputs
  // each output chunk's sums leave for wsums
  const int nch = OPL == 64 ? nchunk : 1;
  float acc[GPW][4];
  project_bins<FT, WARPS, OPL, CK>(
      op, op_rows(N, OPL), NB, nch, opc, ys, NB,
      [](int k0) { return k0; },
      [&](int c, int fl, int gh) {
        if (nch > 1 && fl < nf) {  // OPL 64 only: this chunk's sums leave
#pragma unroll
          for (int i = 0; i < GPW; ++i) {
            const int g = warp + WARPS * (gh + LPF * i);
            if (g >= NG) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int o = NOP * c + 4 * g + q;
              wsums[(size_t)fl * wstride + o] =
                  o < nmel ? logf(fmaxf(acc[i][q], power_floor)) : acc[i][q];
            }
          }
        }
      },
      acc);
  const int fl = lane % FT, gh = lane / FT;
  __syncthreads();  // every lane is done with ys: it takes the sums
  if (nch > 1) return nullptr;  // the sums are in wsums

  float* sums = ys;  // [FT][NOP]: log-mel | autocorrelation
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int g = warp + WARPS * (gh + LPF * i);
    if (g >= NG) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = 4 * g + q;
      sums[fl * NOP + o] =
          o < nmel ? logf(fmaxf(acc[i][q], power_floor)) : acc[i][q];
    }
  }
  __syncthreads();
  return sums;
}

// The signal-level loader (K1, and the fused predict monolith): sample p <
// N of the tile's frame f, the windowed, pre-emphasized strided window of
// the signal, zero past flen and past the padded signal. Straight-line
// code: selects, no branches, so a lane's loads for a whole frame fly
// together.
struct SignalFrames {
  const float* sig;   // the tile's first sample
  const float* win;   // [flen]
  int avail;          // samples from sig to the end of the padded signal
  int fshift, flen;
  float a;
  bool preemph_first;
  __device__ __forceinline__ float operator()(int f, int p) const {
    const int i = f * fshift + p;
    const bool in = p < flen, prev = in && p > 0;
    const float x = in && i < avail ? sig[i] : 0.f;
    const float xm = prev && i - 1 < avail ? sig[i - 1] : 0.f;
    const float w = in ? win[p] : 0.f;
    const float wm = prev ? win[p - 1] : 0.f;
    const float first = w * (p > 0 ? x - a * xm : (1.f - a) * x);
    const float later = w * x - a * (wm * xm);
    return preemph_first ? first : later;
  }
  template <int RP, class First>
  __device__ __forceinline__ void fold(int, float2 (&)[RP], First) const {}
};

// The frame-level kernels' epilogue (K5, K4): tile_sums' sums of frames
// f0 .. f0 + nf - 1 (rows of `stride` floats: NOP in shared memory, or
// rows in device memory past 512 outputs and on the FFT of N >= 32768) ->
// pre-CMVN cepstra ceps [n, nceps] (log-mel . dct) and the raw
// autocorrelation r [n, nac], by the block's NTH threads.
template <int NOP, int NTH>
__device__ __forceinline__ void frame_outputs(
    const float* sums, const float* __restrict__ dct,
    float* __restrict__ ceps, float* __restrict__ r, int f0, int nf,
    int nmel, int nac, int nceps, int stride = NOP) {
  for (int i = threadIdx.x; i < nf * nceps; i += NTH) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + (size_t)f * stride;
    float s = 0.f;
    for (int m = 0; m < nmel; ++m) s = fmaf(lm[m], dct[m * nceps + c], s);
    ceps[(size_t)(f0 + f) * nceps + c] = s;
  }
  for (int i = threadIdx.x; i < nf * nac; i += NTH) {
    const int f = i / nac, j = i % nac;
    r[(size_t)(f0 + f) * nac + j] = sums[(size_t)f * stride + nmel + j];
  }
}

}  // namespace rfft
}  // namespace
