// Per-frame floored log-likelihoods under a speaker bank's GMMs on the
// tensor cores, bf16 operands with f32 accumulation: the inner loop of
// csrc/gmm_score_bf16.cu (batched, K2's precision="bf16") and
// csrc/gmm_serial_bf16.cu (one utterance, K3's).
//
// The JAX kernels' bf16 mode (speaker_recognition_tpu/ops/pallas_gmm.py:
// 136-140, 176-177, 244-247) feeds both matmuls of
//     logp[t, k] = [x_t^2 | x_t] . [a_k | b_k] + cw_k
// bf16 operands and accumulates in f32: exactly what
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// computes, D[16 x 8] = A[16 x 16] . B[16 x 8] + C, with the 16 rows of A
// 16 frames, the 8 columns of B 8 components and C the components' cw, so
// the accumulator starts at cw and each k-step adds 16 terms of the dot.
//
// Layouts (GmmBank.mma_operator; the frames staged here the same way):
//   a row of RW 32-bit words = dk bf16 values and a 16-byte tail; dk is 2d
//   rounded up to a multiple of 16 (the MMA's depth), the values [a (d) |
//   b (d) | 0] for a component, [x^2 (d) | x (d) | 0] for a frame, so that
//   the zero-padded depth adds exact zeros; a component's tail holds cw as
//   an f32 (word dk/2). RW = dk/2 + 4 is 4 mod 8, so the 8 rows x 4 words
//   that a fragment load touches fall in 32 distinct banks.
//   A speaker's K components are padded to kp, a multiple of 8 (the MMA's
//   width), by rows of zero terms with cw = -1e30 (models/gmm.PAD_CW):
//   beside any real component exp(-1e30 - m) is exactly 0, and never
//   -inf - -inf (NaN) in the online logsumexp.
// x^2 is rounded as each JAX kernel rounds it: from the rounded x, rounded
// again (the batched kernel: x * x in the operand dtype), or squared in f32
// and rounded once (the serial kernel).
//
// Fragments (PTX ISA, m16n8k16 with .bf16): lane = 4 g + t. A's registers
// hold rows g and g + 8 at depths 2t, 2t + 1 and 2t + 8, 2t + 9; B's the
// component g at depths 2t, 2t + 1 and 2t + 8, 2t + 9; the accumulator
// frames g and g + 8 at components 2t, 2t + 1. So a lane folds 2 frames x
// 2 components of each n8 tile into its own online logsumexp per frame
// (OnlineLse of csrc/gmm_lse.cuh, carried over the speaker's tiles), and
// at a speaker's last tile the 4 lanes of a quad merge theirs by two
// butterfly shuffles in a fixed order.
//
// A warp takes WF = 32 frames (two m16 tiles, each B fragment feeding two
// MMAs). Two routes, chosen on the depth:
//   staged  (dk <= MAX_STAGED_DK) the warp's frames as bf16 rows in shared
//           memory, the components streamed through shared memory in
//           chunks by 16-byte asynchronous copies (RowStream of
//           csrc/gmm_lse.cuh, two buffers, the next chunk in flight), the
//           logsumexp carried across chunks: no cap on K;
//   wide    any depth: the fragments built from the f32 frames in device
//           memory and the component rows read where they lie.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_lse.cuh"

namespace {

constexpr int WF = 32;              // frames a warp
constexpr int MT = WF / 16;         // m16 tiles a warp
constexpr int MAX_STAGED_DK = 512;  // widest depth of the staged route
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int mma_depth(int d) { return (2 * d + 15) / 16 * 16; }
// 32-bit words a row (bf16 values and the tail)
__host__ __device__ inline int mma_row_words(int d) { return mma_depth(d) / 2 + 4; }
__host__ __device__ inline int mma_components(int K) { return (K + 7) / 8 * 8; }

// Rows a staged chunk holds (a multiple of 8) for rows of RW words: all
// `rows` in one buffer when they take at most one_buffer bytes, else chunks
// of about CHUNK_BYTES (at least 8 rows) in two buffers. *smem: its bytes.
inline int mma_chunk(int rows, int RW, int one_buffer, int* smem) {
  const size_t row_bytes = (size_t)RW * 4;
  if ((size_t)rows * row_bytes <= (size_t)one_buffer) {
    *smem = (int)((size_t)rows * row_bytes);
    return rows;
  }
  int ch = (int)(CHUNK_BYTES / row_bytes) / 8 * 8;
  if (ch < 8) ch = 8;
  *smem = (int)(2 * ch * row_bytes);
  return ch;
}

// D += A . B for one m16n8k16 tile (bf16 operands, f32 accumulation).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x and x^2 of one feature as the JAX kernel rounds them (see above)
template <bool SQUARE_ROUNDED>
__device__ __forceinline__ void round_pair(float v, __nv_bfloat16* x2,
                                           __nv_bfloat16* xb) {
  *xb = __float2bfloat16_rn(v);
  const float r = __bfloat162float(*xb);
  *x2 = __float2bfloat16_rn(SQUARE_ROUNDED ? __fmul_rn(r, r)
                                           : __fmul_rn(v, v));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The staged route's frames: the warp's WF frames as bf16 rows of RW words
// in shared memory.
struct SmemFrames {
  const uint32_t* at;  // [WF][RW]
  int RW;
  __device__ __forceinline__ void frag(int mt, int ks,
                                       uint32_t (&a)[4]) const {
    const int lane = threadIdx.x % 32;
    const uint32_t* p = at + (size_t)(mt * 16 + lane / 4) * RW + 8 * ks +
                        lane % 4;
    a[0] = p[0];
    a[1] = p[8 * RW];
    a[2] = p[4];
    a[3] = p[8 * RW + 4];
  }
};

// Stage nf frames from x [nf][d] (f32, rows of d) into at [WF][RW] as
// [x^2 | x | 0], zero rows past nf. The warp's lanes walk the frames'
// values in order (coalesced reads); a __syncwarp ends it.
template <bool SQUARE_ROUNDED>
__device__ __forceinline__ void stage_frames(uint32_t* at, int RW,
                                             const float* __restrict__ x,
                                             int nf, int d) {
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(at);
  const int rowe = 2 * RW, dk = 2 * (RW - 4), pad = dk - 2 * d;
  for (int e = lane; e < WF * d; e += 32) {
    const int i = e / d, j = e % d;
    __nv_bfloat16 x2, xb;
    round_pair<SQUARE_ROUNDED>(i < nf ? x[e] : 0.f, &x2, &xb);
    ab[(size_t)i * rowe + j] = x2;
    ab[(size_t)i * rowe + d + j] = xb;
  }
  for (int e = lane; e < WF * pad; e += 32) {
    const int i = e / pad;
    ab[(size_t)i * rowe + 2 * d + e % pad] = __float2bfloat16_rn(0.f);
  }
  __syncwarp();
}

// The wide route's frames: each fragment built from the f32 frames where
// they lie, x [nf][d], zeros past nf and past 2d.
template <bool SQUARE_ROUNDED>
struct GlobalFrames {
  const float* x;
  int nf, d;
  __device__ __forceinline__ __nv_bfloat16 value(int i, int k) const {
    if (i >= nf || k >= 2 * d) return __float2bfloat16_rn(0.f);
    __nv_bfloat16 x2, xb;
    round_pair<SQUARE_ROUNDED>(x[(size_t)i * d + (k < d ? k : k - d)], &x2,
                               &xb);
    return k < d ? x2 : xb;
  }
  __device__ __forceinline__ void frag(int mt, int ks,
                                       uint32_t (&a)[4]) const {
    const int lane = threadIdx.x % 32;
    const int i = mt * 16 + lane / 4, k = 16 * ks + 2 * (lane % 4);
    a[0] = pack(value(i, k), value(i, k + 1));
    a[1] = pack(value(i + 8, k), value(i + 8, k + 1));
    a[2] = pack(value(i, k + 8), value(i, k + 9));
    a[3] = pack(value(i + 8, k + 8), value(i + 8, k + 9));
  }
};

// The 4 lanes of a quad merge their online logsumexps (over the
// components 2t, 2t + 1 of each tile) into the frame's: two butterfly
// steps, each a sum of two products rounded apart, so both lanes of a pair
// compute the same bits.
__device__ __forceinline__ void quad_merge(OnlineLse& l) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(FULL_MASK, l.m, off);
    const float s2 = __shfl_xor_sync(FULL_MASK, l.sum, off);
    const float m = fmaxf(l.m, m2);
    l.sum = __fadd_rn(__fmul_rn(l.sum, exp2_approx(LOG2E * (l.m - m))),
                      __fmul_rn(s2, exp2_approx(LOG2E * (m2 - m))));
    l.m = m;
  }
}

// Every frame's online logsumexp back to empty (m = -inf, sum = 0), field
// by field. Also at the start, not left to OnlineLse's default member
// initializers: for a 2-D local array the front end emits a memset of 0 and
// the m = -inf stores, and the device optimizer of CUDA 12.9 keeps the
// stores of the first row only, so the second m16 tile's sums started at
// m = 0 and underflowed once a frame's lse fell below -87
// (tools/nvcc_array_init.cu reproduces it; gmm_lse.cuh's 1-D array is not
// affected).
__device__ __forceinline__ void reset(OnlineLse (&lse)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse[mt][h].m = -INFINITY;
      lse[mt][h].sum = 0.f;
    }
}

// Walks st's component rows (RW words each), kp to a speaker, over the
// warp's frames `fr` (SmemFrames or GlobalFrames) at nks k-steps: after a
// speaker's last tile, emit(s, lse) with s counted from the run's first
// speaker and lse[mt][h] the merged online logsumexp of frame mt * 16 +
// lane / 4 + 8 h, the same in the 4 lanes of a quad. STAGED: the caller
// has started st.fetch(0) and every thread of the block calls; a warp that
// is not `active` only keeps the copies and barriers going. Otherwise the
// rows are read where they lie and an inactive warp returns.
template <bool STAGED, class Frames, class Emit>
__device__ __forceinline__ void walk_mma(const RowStream& st, int kp, int nks,
                                         bool active, const Frames& fr,
                                         Emit&& emit) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int RW = st.P, cwo = RW - 4;
  OnlineLse lse[MT][2];
  reset(lse);
  int kk = 0, s = 0;
  // n rows (a multiple of 8) from base, an n8 tile at a time
  auto run = [&](const float* base, int n) {
    const uint32_t* rows = reinterpret_cast<const uint32_t*>(base);
    for (int r0 = 0; r0 < n; r0 += 8) {
      const uint32_t* br = rows + (size_t)(r0 + g) * RW;
      const float cw0 = __uint_as_float(rows[(size_t)(r0 + 2 * t) * RW + cwo]);
      const float cw1 =
          __uint_as_float(rows[(size_t)(r0 + 2 * t + 1) * RW + cwo]);
      float c[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        c[mt][0] = c[mt][2] = cw0;
        c[mt][1] = c[mt][3] = cw1;
      }
      for (int ks = 0; ks < nks; ++ks) {
        const uint32_t b0 = br[8 * ks + t], b1 = br[8 * ks + 4 + t];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          fr.frag(mt, ks, a);
          mma_bf16(c[mt], a, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        lse[mt][0].add(c[mt][0]);
        lse[mt][0].add(c[mt][1]);
        lse[mt][1].add(c[mt][2]);
        lse[mt][1].add(c[mt][3]);
      }
      kk += 8;
      if (kk == kp) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          quad_merge(lse[mt][0]);
          quad_merge(lse[mt][1]);
        }
        emit(s++, lse);
        kk = 0;
        reset(lse);
      }
    }
  };
  if constexpr (!STAGED) {
    if (active) run(st.rows, st.n_rows);
  } else {
    const int nchunks = (st.n_rows + st.ch - 1) / st.ch;
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        st.fetch(c + 1);  // into the buffer chunk c - 1 was read from
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // chunk c has landed for every thread
      if (active) run(st.chunk(c), st.rows_in(c));
      if (c + 1 < nchunks) __syncthreads();  // chunk c is read: reusable
    }
  }
}

}  // namespace
