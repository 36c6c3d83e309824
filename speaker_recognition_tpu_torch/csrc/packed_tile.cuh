// The packed frontend's per-tile stages: tile_features and cmvn_utterance
// (and cmvn_kernel, which launches it), shared by csrc/frontend.cu (the
// signal-level frontend, on the FFT tile), csrc/frontend_full_signals.cu
// (the full-spectrum frontend from the signals) and csrc/predict_fused.cuh
// (the fused predict monolith); the dense
// tile_sums serves the routes that round the DFT operand D to bf16: the
// monolith's bf16 route and K1's and K4's mm_bf16 (csrc/frontend_bf16.cu).
// For a tile of FT consecutive frames of one utterance:
//   tile_sums      X = bf16(frame) . bf16(D) on the tensor cores, Y = X^2,
//                  and Y . [W | A] on the FP32 cores; leaves log(max(mel,
//                  floor)) and the raw autocorrelation per frame in shared
//                  memory (or, past 128 outputs, in device rows);
//   tile_features  cepstra (log-mel . dct) and LPC (Levinson, non-finite
//                  -> 0), the LPC cepstra or the raw autocorrelation per
//                  frame, zeros at frames past n_valid;
// and, per utterance, cmvn_utterance: masked two-pass mean and population
// deviation of the cepstra, in place.
//
// tile_sums replaces the dense product of the TPU kernels' bf16 mode
// (speaker_recognition_tpu/ops/pallas_frontend.py:292-296, :306-307 in
// _run_packed_signals, :118 and :452 in _run_packed; pallas_predict.py:
// 113-115 in _run): bf16 operands, f32 products and f32 sums, which is
// exactly
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
// What bounds it on this card: stage 1, 2 * flen * ncols FLOPs a frame
// (262 kFLOP at 8 kHz), at the bf16 tensor cores' 989 TFLOP/s (0.042 ms
// for the bench batch); then stage 2's 2 * ncols * (nmel + nac) f32 FLOPs
// a frame (68 kFLOP at 8 kHz) at the FP32 peak of 67 TFLOP/s (0.16 ms),
// the larger share.
// What the design does:
//   stage 1  each warp owns one m16 tile (16 frames) and NPW n8 tiles of
//            a chunk of CC = 64 packed DFT columns, f32 accumulator
//            fragments in registers (FT / 4 floats a lane). The tile's
//            samples are staged once, as bf16 (half the f32 segment). With
//            fshift % 16 == 0 (every default geometry but 44.1 kHz's) they
//            are staged in rows of fshift + 8 (row r holds samples r *
//            fshift ..): a k-step of 16 never crosses a row, every frame
//            row starts on a 16-byte boundary and the 8 rows of an 8 x 8
//            piece fall in distinct banks, so A fragments come by ldmatrix.
//            Otherwise (705 at 44.1 kHz) the samples lie contiguous and A
//            fragments come by 16-bit loads; past what a 32-frame tile's
//            shared memory holds (GSEG), from the f32 samples in device
//            memory.
//            D comes packed once by the wrapper (ops/gpu_frontend.
//            dft_mma_operator): bf16, rows padded with zeros to a multiple
//            of 16 (the MMA's depth), columns to a multiple of CC, in the
//            order of the B fragments, streamed through shared memory in
//            pieces of KC k-steps by 16-byte asynchronous copies (two
//            buffers, the next piece in flight). The kernel rounds nothing
//            itself; the samples past flen meet D's zero rows.
//            Each k-step's MMAs start from zero and their sums are added
//            to the accumulators in f32 on the FP32 cores: a chain of MMAs
//            would align each k-step's 16 products to the running total.
//   stage 2  Y = X^2 from the fragments into yt [CC][FT + 4], then Y . [W
//            | A] in f32 FMAs: a lane owns FT/32 frames x OPL outputs, over
//            the chunk's columns in order, its frames' Y and its outputs'
//            weights in 16-byte loads. W | A comes packed once by the
//            wrapper in the order the lanes read it (ops/gpu_frontend.
//            dense_wa_operator), the chunk's copy in flight during stage 1.
// Warps whose frames all lie past n_valid (or T) skip both stages.
// tools/bf16_ablation.py times each stage on the card.
// Past 128 outputs (OPL 16, nchunk > 1) the tile projects onto chunks of
// 128 outputs one after the other, running stage 1 again for each (the
// tensor cores' share is the small one) and keeping each chunk's sums in
// registers over all columns; they leave through the tile's rows of wsums
// [nf][wstride] in device memory. Each output's sum runs over the columns
// in the same order whatever the count, and X does not depend on it, so
// at most 128 outputs keep their bits inside a larger call. Every sum runs
// in a fixed order (the MMAs over k in turn): two calls, the same bits.
//
// The block is NT = 256 threads. Built without --use_fast_math: isfinite()
// must survive and logf must be the accurate one (an all-zero frame gives
// r = 0 -> 0/0 -> LPC 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block: 8 warps
constexpr int MAX_SMEM = 232448;  // shared memory a block may use
constexpr int SM_SMEM = 233472;   // an SM's, 1 KB of it reserved a block
constexpr int CC = 64;        // packed DFT columns per chunk: 8 n8 tiles
constexpr int KSTEP = 16;     // the MMA's depth: D rows a k-step
constexpr int KC = 4;         // k-steps a streamed piece of D
// 16-byte words of D a k-step: CC columns x 16 rows of bf16, 4 words a
// lane per pair of n8 tiles
constexpr int KWORDS = KSTEP * CC * 2 / 16;

// D's rows as packed: flen padded to the MMA's depth
__host__ __device__ constexpr int dft_depth(int flen) {
  return (flen + KSTEP - 1) / KSTEP * KSTEP;
}

// The staged samples' row stride: sample s at (s / fshift) * stride + s %
// fshift, rows of fshift + 8 where a k-step never crosses a row (fshift %
// 16 == 0: the ldmatrix route), contiguous otherwise.
__host__ __device__ constexpr int seg_stride(int fshift) {
  return fshift % 16 == 0 ? fshift + 8 : fshift;
}

// rows of the staged samples of a tile of ft frames: every sample a k-step
// of its frames reads
__host__ __device__ constexpr int seg_rows(int ft, int flen, int fshift) {
  return ((ft - 1) * fshift + dft_depth(flen) + fshift - 1) / fshift;
}

// their bytes, a multiple of 16
__host__ __device__ constexpr int seg_bytes(int ft, int flen, int fshift) {
  return (seg_rows(ft, flen, fshift) * seg_stride(fshift) * 2 + 15) / 16 * 16;
}

// Stage 2's layouts: the squared tile column by column, yt [CC][ft + 4]
// (a lane's frames one 16-byte load, the fragments' stores in distinct
// banks), and the W | A chunk as wa [CC][8][ogs(opl)], output og + 8 j of
// a column at og * ogs + j (a lane's outputs in 16-byte loads, the 8
// output groups of a load in distinct banks), as ops/gpu_frontend.
// dense_wa_operator packs it
__host__ __device__ constexpr int yt_stride(int ft) { return ft + 4; }
__host__ __device__ constexpr int ogs(int opl) { return opl == 9 ? 12 : 20; }

// bytes of shared memory: two pieces of D, the tile's samples (none when
// they are read from device memory, gseg), the squared tile, the W | A
// chunk
__host__ __device__ constexpr int smem_bytes(int ft, int opl, int flen,
                                             int fshift, bool gseg = false) {
  return 2 * KC * KWORDS * 16 + (gseg ? 0 : seg_bytes(ft, flen, fshift)) +
         4 * CC * (yt_stride(ft) + 8 * ogs(opl));
}

// columns of a feature row: cepstra, then the LPC (order = nac - 1), or
// with n_lpcc > 0 the n_lpcc - 1 LPC cepstra, or without fuse_lpc the nac
// raw autocorrelation lags
__host__ __device__ constexpr int feature_width(int nceps, int nac,
                                                int fuse_lpc,
                                                int n_lpcc = 0) {
  return n_lpcc > 0 ? nceps + n_lpcc - 1
                    : nceps + (fuse_lpc ? (nac > 0 ? nac - 1 : 0) : nac);
}

// Output chunks of 8 * OPL the tile projects onto one after the other: 1
// up to 128 outputs, then chunks of 128 (OPL 16).
inline int dense_chunks(int nout) { return nout <= 128 ? 1 : (nout + 127) / 128; }

// Blocks an SM holds at `bytes` of shared memory; at most 2, which the
// kernels' register bound (__launch_bounds__(NT, 2)) allows.
inline int dense_blocks(int bytes) {
  if (bytes > MAX_SMEM) return 0;
  const int b = SM_SMEM / (bytes + 1024);
  return b < 2 ? b : 2;
}

// Outputs a lane of stage 2 takes / 8: 9 up to 72 outputs, else 16 (in
// dense_chunks(nout) chunks of 128)
inline int dense_opl(int nout) { return nout <= 72 ? 9 : 16; }

// The tile for a geometry: of 128 frames (up to 72 outputs), 64 and 32,
// the one that keeps the most frames resident an SM (frames x blocks), the
// smaller tile on a tie (more blocks to hide one another's barriers);
// where none fits, 32 frames with the samples read from device memory
// (*gseg = 1).
inline void pick(int flen, int fshift, int nout, int* ft, int* opl,
                 int* gseg) {
  *opl = dense_opl(nout);
  int best = 0;
  *ft = 32;
  for (const int f : {128, 64, 32}) {
    if (f == 128 && *opl != 9) continue;
    const int frames = f * dense_blocks(smem_bytes(f, *opl, flen, fshift));
    if (frames > 0 && frames >= best) {
      best = frames;
      *ft = f;
    }
  }
  *gseg = best == 0;
}

// D += A . B for one m16n8k16 tile (bf16 operands, f32 accumulation)
__device__ __forceinline__ void dft_mma(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four 8 x 8 pieces of an A fragment, each lane giving one row address
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t bf16_pair(unsigned short lo,
                                              unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// n floats from shared memory at p, in 16-byte loads (p 16-byte aligned)
// where n allows
template <int N>
__device__ __forceinline__ void load_floats(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// sig: the tile's first sample; avail: samples from there to the end of
// the padded signal; Dp: D packed by ops/gpu_frontend.dft_mma_operator;
// WAp: W | A packed by ops/gpu_frontend.dense_wa_operator; nuse: the
// tile's frames whose sums are read (the rest, past n_valid or T, get
// none: warps whose frames all lie there skip both stages).
// Returns sums [FT][8*OPL] in shared memory: columns < nmel hold
// log(max(mel, power_floor)), the next nac the raw autocorrelation Y . A.
// Ends on a barrier. With GSEG the samples are read from device memory
// where they are used instead of staged. Past 128 outputs (OPL 16, nchunk
// > 1) the sums go to the tile's rows of wsums [nf][wstride] in device
// memory instead (and nullptr returns).
template <int FT, int OPL, bool GSEG = false>
__device__ __forceinline__ float* tile_sums(
    const float* __restrict__ sig, int avail, const uint4* __restrict__ Dp,
    const uint4* __restrict__ WAp, float* smem, int flen, int fshift,
    int ncols, int nmel, float power_floor, int nchunk,
    float* __restrict__ wsums, int wstride, int nf, int nuse) {
  constexpr int MT = FT / 16;          // m16 tiles of the tile
  constexpr int NPW = CC / 8 / (8 / MT);  // n8 tiles of a chunk a warp
  constexpr int FPL = FT / 32;         // frames a lane, stage 2
  constexpr int NOP = 8 * OPL;         // padded mel | autocorrelation outputs
  static_assert(8 * NPW == MT * (CC / 8) && NPW % 2 == 0,
                "8 warps cover the chunk's m16 x n8 tiles in pairs of n8");
  constexpr int YT = yt_stride(FT), OGS = ogs(OPL);
  static_assert(CC * (YT + 8 * OGS) >= FT * NOP, "the sums fit yt | wa");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  uint4* dbuf = reinterpret_cast<uint4*>(smem);  // [2][KC * KWORDS]
  unsigned short* seg =  // the samples as bf16 bits
      reinterpret_cast<unsigned short*>(dbuf + 2 * KC * KWORDS);
  float* yt = reinterpret_cast<float*>(
      reinterpret_cast<char*>(seg) + (GSEG ? 0 : seg_bytes(FT, flen, fshift)));
  float* wa = yt + CC * YT;  // [CC][8][OGS]  (W | A | 0) chunk

  // the stream of D's pieces: per output chunk, per column chunk, the
  // k-steps in pieces of KC
  const int ksteps = dft_depth(flen) / KSTEP;
  const int npieces = (ksteps + KC - 1) / KC;
  const int ncc = (ncols + CC - 1) / CC;
  const int nch = OPL == 16 ? nchunk : 1;
  const int nq = nch * ncc * npieces;
  auto fetch = [&](int q) {
    const int c = q / npieces % ncc, kp = q % npieces;
    const uint4* src = Dp + ((size_t)c * ksteps + kp * KC) * KWORDS;
    uint4* dst = dbuf + (q & 1) * (KC * KWORDS);
    const int n = min(KC, ksteps - kp * KC) * KWORDS;
    for (int i = tid; i < n; i += NT)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  };
  // the W | A chunk of output chunk oc and column chunk c into wa
  constexpr int WAWORDS = CC * 8 * OGS / 4;
  auto fetch_wa = [&](int oc, int c) {
    const uint4* src = WAp + (size_t)(oc * ncc + c) * WAWORDS;
    uint4* dst = reinterpret_cast<uint4*>(wa);
    for (int i = tid; i < WAWORDS; i += NT)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  };
  fetch(0);
  __pipeline_commit();

  const int RS = seg_stride(fshift);
  if (!GSEG) {  // the samples as bf16, row r of RS holding r * fshift ..
    const int n = seg_rows(FT, flen, fshift) * fshift;
    int r = tid / fshift, c = tid % fshift;  // of sample i, walked by NT
    const int dr = NT / fshift, dc = NT % fshift;
#pragma unroll 8
    for (int i = tid; i < n; i += NT) {
      seg[r * RS + c] = i < avail ? bf16_bits(sig[i]) : 0;
      r += dr;
      if ((c += dc) >= fshift) {
        c -= fshift;
        ++r;
      }
    }
  }
  const bool ldm = fshift % 16 == 0;  // block-uniform

  const int mt = warp % MT, wc = warp / MT;  // m16 tile, column group
  const int m0 = 16 * mt;
  // ldmatrix: lane gives row (lane % 8) + 8 ((lane / 8) % 2) of the m16
  // tile at column 8 (lane / 16)
  const int arow = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  const int f2 = warp * (FT / 8) + (lane / 8) * FPL;  // stage 2 frames
  const int og = lane % 8;                          // stage 2 outputs og + 8 j
  const bool mma_on = m0 < nuse, fma_on = warp * (FT / 8) < nuse;
  float acc[FPL][OPL];
  int q = 0;

  for (int oc = 0; oc < nch; ++oc) {
    const int o0 = NOP * oc;
#pragma unroll
    for (int i = 0; i < FPL; ++i)
#pragma unroll
      for (int j = 0; j < OPL; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < ncc; ++c) {
      const int c0 = c * CC, cw = min(CC, ncols - c0);
      float x[NPW][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) x[j][r] = 0.f;
      int kq = 0, kr = 0;  // k0 / fshift, k0 % fshift (the ldmatrix route)
      for (int kp = 0; kp < npieces; ++kp, ++q) {
        __pipeline_wait_prior(0);
        // piece q has landed for every thread, every reader of the other
        // buffer, of yt and of wa is done, and the samples are staged
        __syncthreads();
        if (kp == 0) fetch_wa(oc, c);  // in flight during stage 1
        if (q + 1 < nq) fetch(q + 1);
        __pipeline_commit();
        const uint4* piece = dbuf + (q & 1) * (KC * KWORDS);
        const int nk = mma_on ? min(KC, ksteps - kp * KC) : 0;
        for (int s = 0; s < nk; ++s) {
          const int k0 = (kp * KC + s) * KSTEP;
          uint32_t a[4];
          if (GSEG) {  // each sample from device memory, as staged would be
            auto v = [&](int i, int k) -> unsigned short {
              const int si = (m0 + i) * fshift + k0 + k;
              return si < avail ? bf16_bits(sig[si]) : 0;
            };
            a[0] = bf16_pair(v(g, 2 * t), v(g, 2 * t + 1));
            a[1] = bf16_pair(v(g + 8, 2 * t), v(g + 8, 2 * t + 1));
            a[2] = bf16_pair(v(g, 2 * t + 8), v(g, 2 * t + 9));
            a[3] = bf16_pair(v(g + 8, 2 * t + 8), v(g + 8, 2 * t + 9));
          } else if (ldm) {
            ldsm_x4(a, seg + (arow + kq) * RS + kr + acol);
            if ((kr += KSTEP) == fshift) {
              kr = 0;
              ++kq;
            }
          } else {  // contiguous samples (RS = fshift), 16-bit loads
            const unsigned short* r0 = seg + (m0 + g) * fshift + k0 + 2 * t;
            const unsigned short* r1 = r0 + 8 * fshift;
            a[0] = bf16_pair(r0[0], r0[1]);
            a[1] = bf16_pair(r1[0], r1[1]);
            a[2] = bf16_pair(r0[8], r0[9]);
            a[3] = bf16_pair(r1[8], r1[9]);
          }
          // each k-step's 16 products summed on the tensor cores from
          // zero, the k-steps summed in f32 on the FP32 cores (RN): the
          // chain of MMAs would round each step's sum to the running
          // total's exponent instead
          const uint4* b = piece + s * KWORDS + wc * (NPW / 2) * 32 + lane;
#pragma unroll
          for (int p = 0; p < NPW / 2; ++p) {
            const uint4 bw = b[p * 32];
            float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
            dft_mma(c0, a, bw.x, bw.y);
            dft_mma(c1, a, bw.z, bw.w);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              x[2 * p][r] += c0[r];
              x[2 * p + 1][r] += c1[r];
            }
          }
        }
      }
      // Y = X^2: frames m0 + g (+ 8), columns 8 n + 2 t (+ 1)
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        float* y0 = yt + ((wc * NPW + j) * 8 + 2 * t) * YT + m0 + g;
        y0[0] = x[j][0] * x[j][0];
        y0[YT] = x[j][1] * x[j][1];
        y0[8] = x[j][2] * x[j][2];
        y0[YT + 8] = x[j][3] * x[j][3];
      }
      __pipeline_wait_prior(0);  // this thread's copies of wa have landed
      __syncthreads();  // yt and wa are in place
#pragma unroll 2
      for (int cc = 0; cc < (fma_on ? cw : 0); ++cc) {
        float y[FPL], w[OGS];
        load_floats<FPL>(y, yt + cc * YT + f2);
        load_floats<OGS>(w, wa + (cc * 8 + og) * OGS);
#pragma unroll
        for (int i = 0; i < FPL; ++i)
#pragma unroll
          for (int j = 0; j < OPL; ++j)
            acc[i][j] = fmaf(y[i], w[j], acc[i][j]);
      }
    }
    if (nch > 1) {  // OPL 16 only: this output chunk's sums, to the rows
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        if (f2 + i >= nf) continue;
#pragma unroll
        for (int j = 0; j < OPL; ++j) {
          const int o = o0 + og + 8 * j;
          wsums[(size_t)(f2 + i) * wstride + o] =
              o < nmel ? logf(fmaxf(acc[i][j], power_floor)) : acc[i][j];
        }
      }
    }
  }
  __syncthreads();  // every lane is done with yt and wa: the sums go there
  if (nch > 1) return nullptr;  // the sums are in wsums

  float* sums = yt;  // [FT][NOP]: log-mel | autocorrelation
#pragma unroll
  for (int i = 0; i < FPL; ++i)
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int o = og + 8 * j;
      sums[(f2 + i) * NOP + o] =
          o < nmel ? logf(fmaxf(acc[i][j], power_floor)) : acc[i][j];
    }
  __syncthreads();
  return sums;
}


// Levinson-Durbin of order `order` on the autocorrelation r in the order
// of ops/levinson.levinson_unrolled, its coefficients in a[0 .. order-1]
// updated in place a symmetric pair at a time (each new value is the one
// the two-array form computes).
__device__ __forceinline__ void levinson_in_place(const float* r, float* a,
                                                  int order) {
  float e = r[0];
  for (int i = 1; i <= order; ++i) {
    float s = r[i];
    for (int j = 1; j < i; ++j) s += a[j - 1] * r[i - j];
    const float k = -s / e;
    // a[j-1] += k a[i-j-1] for j = 1 .. i-1, from the old values
    for (int j = 1, l = i - 1; j <= l; ++j, --l) {
      const float lo = a[j - 1], hi = a[l - 1];
      a[j - 1] = lo + k * hi;
      if (j < l) a[l - 1] = hi + k * lo;
    }
    a[i - 1] = k;
    e = e * (1.f - k * k);
  }
}

// The LPC cepstra of ops/levinson.lpcc_from_lpc (src/feature/LPC.py
// lpc_to_cc) from a[0 .. p-1] = a_1 .. a_p, as levinson_in_place leaves
// them, non-finite ones included: with a_0 = c_0 = 1,
//     c_n = (a_n if n < p else 0) + sum_{l < min(n, p)} a_l c_{n-l-1} (n-l)/(n+1)
// for n = 1 .. n_lpcc - 1, into o[n - 1] (c_n is kept there during the
// recursion), then each as -c_n, a non-finite one as 0: the JAX package's
// nan_to_num after the recursion (features/extract.py:339-344), so a
// silent frame's NaN coefficients give 0, not the recursion on zeroed ones
// (c_n = 1 / (n + 1)).
__device__ __forceinline__ void lpcc_in_place(const float* a, float* o,
                                              int p, int n_lpcc) {
  for (int n = 1; n < n_lpcc; ++n) {
    float s = 0.f;
    for (int l = 0, m = min(n, p); l < m; ++l) {
      const float al = l == 0 ? 1.f : a[l - 1];
      const float cp = n - l - 1 == 0 ? 1.f : o[n - l - 2];
      s += al * cp * ((float)(n - l) / (float)(n + 1));
    }
    o[n - 1] = n < p ? a[n - 1] + s : s;
  }
  for (int j = 0; j + 1 < n_lpcc; ++j) o[j] = isfinite(o[j]) ? -o[j] : 0.f;
}

// The LPC cepstra (lpcc_in_place) of frames first, first + step, ... < nf
// of a tile, one thread a frame: the raw autocorrelation at column nmel of
// sums rows of `stride` floats, the cepstra from column nceps of out rows
// of nfeat floats; zeros at frames at or past nvalid. A lag 0 below the
// least normal float (an all-floor frame of the full-spectrum route: floor
// / flen) is taken as r = 0, whose NaN coefficients give 0, as in the JAX
// package's f32 route, which flushes subnormals (gpu_frontend.lpc_columns).
// Not inlined: the tile kernels that can take this mode carry one call in
// place of its loops and local array.
template <int NOP>
__device__ __noinline__ void lpcc_frames(const float* sums, float* out,
                                         int nf, int nvalid, int nmel,
                                         int order, int nceps, int nfeat,
                                         int stride, int n_lpcc, int first,
                                         int step) {
  for (int f = first; f < nf; f += step) {
    float* o = out + (size_t)f * nfeat + nceps;
    const float* r = sums + (size_t)f * stride + nmel;
    if (f >= nvalid || !(r[0] >= FLT_MIN)) {
      for (int j = 0; j + 1 < n_lpcc; ++j) o[j] = 0.f;
      continue;
    }
    float a[NOP];
    levinson_in_place(r, a, order);
    lpcc_in_place(a, o, order, n_lpcc);
  }
}

// The features of the tile's nf frames from tile_sums' sums (rows of
// `stride` floats: 8 * OPL in shared memory, or rows in device memory past
// 512 outputs and on the FFT of N >= 32768), into out [nf][nfeat]:
// cepstra, then with fuse_lpc the LPC (nfeat = nceps + order, order = nac
// - 1, or 0 without LPC) by Levinson-Durbin with non-finite coefficients
// zeroed, or with n_lpcc > 0 the n_lpcc - 1 LPC cepstra of the unzeroed
// coefficients (lpcc_frames; nfeat = nceps + n_lpcc - 1; order < 8 * OPL,
// which ops/gpu_frontend checks), and without fuse_lpc the raw
// autocorrelation as it stands in sums (nfeat = nceps + nac). Frames at or
// past nvalid (counted from the tile's first frame) get zeros. NTH threads
// run it; the recursion takes any order, one thread a frame, its
// coefficients in a local array below 8 * OPL and in the frame's output
// row past it (LPC only).
template <int OPL, int NTH = NT>
__device__ __forceinline__ void tile_features(
    const float* sums, float* __restrict__ out, int nf, int nvalid,
    const float* __restrict__ dct, int nmel, int nac, int nceps,
    bool fuse_lpc, int stride = 8 * OPL, int n_lpcc = 0) {
  constexpr int NOP = 8 * OPL;
  const int order = nac > 0 ? nac - 1 : 0;
  const int nfeat =
      n_lpcc > 0 ? nceps + n_lpcc - 1 : nceps + (fuse_lpc ? order : nac);
  const int tid = threadIdx.x;

  for (int i = tid; i < nf * nceps; i += NTH) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + (size_t)f * stride;
    float s = 0.f;
    for (int m = 0; m < nmel; ++m) s = fmaf(lm[m], dct[m * nceps + c], s);
    out[f * nfeat + c] = f < nvalid ? s : 0.f;
  }

  if (!fuse_lpc) {
    for (int i = tid; i < nf * nac; i += NTH) {
      const int f = i / nac, j = i % nac;
      out[f * nfeat + nceps + j] =
          f < nvalid ? sums[(size_t)f * stride + nmel + j] : 0.f;
    }
    return;
  }
  if (n_lpcc > 0) {  // block-uniform
    lpcc_frames<NOP>(sums, out, nf, nvalid, nmel, order, nceps, nfeat,
                     stride, n_lpcc, tid, NTH);
    return;
  }
  if (order == 0) return;
  for (int f = tid; f < nf; f += NTH) {
    float* o = out + f * nfeat + nceps;
    if (f >= nvalid) {
      for (int j = 0; j < order; ++j) o[j] = 0.f;
      continue;
    }
    const float* r = sums + (size_t)f * stride + nmel;
    if (order < NOP) {
      float a[NOP];
      levinson_in_place(r, a, order);
      for (int j = 0; j < order; ++j) o[j] = isfinite(a[j]) ? a[j] : 0.f;
    } else {
      levinson_in_place(r, o, order);
      for (int j = 0; j < order; ++j) o[j] = isfinite(o[j]) ? o[j] : 0.f;
    }
  }
}

// Masked per-utterance CMVN of x[:nv, :nceps] (row stride nfeat), in
// place: two-pass mean and population variance, the identity at <= 1
// valid frame (src/feature/MFCC.py:74-77). Threads are 32 columns (c) x CG
// frame groups (g), walking the columns 32 at a time; red [CG][32] and
// stat [2][32] are shared scratch. The partial sums combine in a fixed
// order, so the result is deterministic.
template <int CG>
__device__ __forceinline__ void cmvn_utterance(
    float* __restrict__ x, int nv, int nfeat, int nceps, int c, int g,
    float (*red)[32], float (*stat)[32]) {
  if (nv <= 1) return;  // block-uniform
  for (int c0 = 0; c0 < nceps; c0 += 32) {
    const int cc = c0 + c;
    const bool col = cc < nceps;
    float s = 0.f;
    if (col)
      for (int t = g; t < nv; t += CG) s += x[(size_t)t * nfeat + cc];
    red[g][c] = s;
    __syncthreads();
    if (g == 0) {
      float tot = 0.f;
      for (int k = 0; k < CG; ++k) tot += red[k][c];
      stat[0][c] = tot / (float)nv;
    }
    __syncthreads();
    const float mu = stat[0][c];
    s = 0.f;
    if (col)
      for (int t = g; t < nv; t += CG) {
        const float d = x[(size_t)t * nfeat + cc] - mu;
        s += d * d;
      }
    red[g][c] = s;
    __syncthreads();
    if (g == 0) {
      float tot = 0.f;
      for (int k = 0; k < CG; ++k) tot += red[k][c];
      stat[1][c] = sqrtf(tot / (float)nv);
    }
    __syncthreads();
    const float sd = stat[1][c];
    if (col)
      for (int t = g; t < nv; t += CG) {
        float* v = x + (size_t)t * nfeat + cc;
        *v = (*v - mu) / sd;
      }
    __syncthreads();  // red and stat are free for the next columns
  }
}

// Masked per-utterance CMVN of feat[b, :n_valid[b], :nceps], in place
// (cmvn_utterance), a block an utterance: 32 columns at a time x CG frame
// groups. The second kernel of the signal frontends (csrc/frontend.cu,
// frontend_bf16.cu, frontend_full_signals.cu).
constexpr int CG = 16;

__global__ void __launch_bounds__(32 * CG) cmvn_kernel(
    float* __restrict__ feat, const int* __restrict__ n_valid, int T,
    int nfeat, int nceps) {
  __shared__ float red[CG][32];
  __shared__ float stat[2][32];
  const int b = blockIdx.x;
  cmvn_utterance<CG>(feat + (size_t)b * T * nfeat, n_valid[b], nfeat, nceps,
                     threadIdx.x, threadIdx.y, red, stat);
}

}  // namespace
