// Per-frame floored log-likelihoods under a speaker bank's GMMs, shared by
// csrc/gmm_serial.cu (one utterance), csrc/predict_fused.cuh (the fused
// predict monolith's scoring phase) and csrc/gmm_score.cu (batched bank
// scoring: its wide route, past the tensor route's depth; the bf16 kernels
// of csrc/gmm_mma.cuh take OnlineLse and RowStream).
//
// The scoring kernels read the bank component by component from
// GmmBank.component_operator: rows [S*K][P], P = 2*DP + 4 floats with DP the
// feature dimension d rounded up to 4 (in the monolith up to 32 or 128,
// csrc/predict_fused.cuh): the quadratic terms a (zero-padded to DP), the
// linear terms b (likewise), cw and three zeros, so that
//     logp[k] = sum_j x_j (a_kj x_j + b_kj) + cw_k
// is two FMAs a term and every row starts on a 16-byte boundary. A lane
// owns FPL frames and every lane of a block walks the same row at the same
// time, so a 16-byte load of a_k or b_k is one broadcast for the warp's
// frames. Three pieces:
//   RegFrames<DP, FPL>  the lane's frames in registers (DP <= MAX_REG_DP),
//                       the terms in four independent FMA chains a frame;
//   WideFrames          any wider d: the lane's frame stays in device
//                       memory and is read through L1 as it is needed;
//   walk_components     the rows of a run of speakers, either streamed
//                       through shared memory in chunks by 16-byte
//                       asynchronous copies (two buffers, the next chunk in
//                       flight while this one is summed) or, for the wide
//                       route, read where they lie; the logsumexp over a
//                       speaker's K rows runs online (OnlineLse: one
//                       exponential per component, no branch) and is
//                       carried across chunks, so shared memory does not
//                       grow with K.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// log(1e-15), the reference's probability floor (src/gmm/src/gmm.cc:482-492)
constexpr float LOG_MIN_PROB = -34.538776394910684f;
constexpr float UNDERFLOW_LOG = -745.f;

// Feature dims are padded to a multiple of DSTEP: what a 16-byte load
// needs (padding to 8 measured slower, PERF.md).
constexpr int DSTEP = 4;
constexpr int MAX_REG_DP = 128;   // widest padded d a lane keeps in registers
constexpr int CHUNK_BYTES = 32768;  // a staged chunk of rows, when streaming
constexpr int BLOCK_SMEM = 232448;  // shared memory a block may use on sm_90

__host__ __device__ inline int padded_dim(int d) {
  return (d + DSTEP - 1) / DSTEP * DSTEP;
}

// floats per component row at feature dimension d
__host__ __device__ inline int row_floats(int d) {
  return 2 * padded_dim(d) + 4;
}

// Rows per staged chunk for a run of `rows` rows of P floats: all of them in
// one buffer when that takes at most `one_buffer` bytes, else chunks of
// CHUNK_BYTES in two buffers. Returns the chunk; *smem its bytes.
inline int plan_chunks(int rows, int P, int one_buffer, int* smem) {
  const size_t whole = (size_t)rows * P * sizeof(float);
  if (whole <= (size_t)one_buffer) {
    *smem = (int)whole;
    return rows;
  }
  const int ch = CHUNK_BYTES / (P * (int)sizeof(float));  // P <= 260: >= 31
  *smem = 2 * ch * P * (int)sizeof(float);
  return ch;
}

// 2^x for x <= 0 by the special-function unit alone (ex2.approx: relative
// error 2^-22, 0 at -inf), where expf spends seven more instructions on
// range reduction; the sums it feeds pass through a log afterwards. The g++
// stand-in of tests/cuda_standin defines it for the CPU.
#ifndef CUSIM_ASM
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#endif

// logsumexp of the values added so far, one exponential per value and no
// branch (the lanes of a warp would take both sides): with e =
// exp(-|l - m|), a new maximum rescales the sum, sum e + 1, and anything
// else adds e
struct OnlineLse {
  float m = -INFINITY, sum = 0.f;
  __device__ __forceinline__ void add(float l) {
    const float diff = l - m;
    const float e = exp2_approx(-1.4426950408889634f * fabsf(diff));
    sum = diff > 0.f ? fmaf(sum, e, 1.f) : sum + e;
    m = fmaxf(m, l);
  }
  // floored: > -745 ? lse : log(1e-15)
  __device__ __forceinline__ float floored() const {
    const float lse = m + logf(sum);
    return lse > UNDERFLOW_LOG ? lse : LOG_MIN_PROB;
  }
};

__device__ __forceinline__ float quad(float a, float b, float x, float acc) {
  return fmaf(fmaf(a, x, b), x, acc);
}

// A lane's FPL frames in registers, zeros past d (their a and b are 0).
template <int DP, int FPL_>
struct RegFrames {
  static constexpr int FPL = FPL_;
  static constexpr bool STAGED = true;
  float xv[FPL][DP];

  // frame i from x [d], or zeros when x is null
  __device__ __forceinline__ void load(int i, const float* __restrict__ x,
                                       int d) {
    // d % 4 == 0: every row is 16-byte aligned when the first is (a view
    // into a larger storage may start anywhere; then the scalar loads)
    if (x != nullptr && d == DP &&
        (reinterpret_cast<unsigned long long>(x) & 15ull) == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 v = x4[q];
        xv[i][4 * q] = v.x;
        xv[i][4 * q + 1] = v.y;
        xv[i][4 * q + 2] = v.z;
        xv[i][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < DP; ++j)
        xv[i][j] = (x != nullptr && j < d) ? x[j] : 0.f;
    }
  }

  // l[i] = logp of frame i under the component row p
  __device__ __forceinline__ void eval(const float* p, float (&l)[FPL]) const {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float cw = p[2 * DP];
    float acc[FPL][4];
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      acc[i][0] = cw;
      acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      const float4 a = p4[q], b = p4[DP / 4 + q];
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        acc[i][0] = quad(a.x, b.x, xv[i][4 * q], acc[i][0]);
        acc[i][1] = quad(a.y, b.y, xv[i][4 * q + 1], acc[i][1]);
        acc[i][2] = quad(a.z, b.z, xv[i][4 * q + 2], acc[i][2]);
        acc[i][3] = quad(a.w, b.w, xv[i][4 * q + 3], acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < FPL; ++i)
      l[i] = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
  }
};

// One frame a lane, left in device memory: any d. The rows are read from
// device memory too (every lane the same address: one transaction a warp).
struct WideFrames {
  static constexpr int FPL = 1;
  static constexpr bool STAGED = false;
  const float* x;  // the lane's frame [d], or null
  int d, dp;

  __device__ __forceinline__ void load(int, const float* __restrict__ x_,
                                       int d_) {
    x = x_;
    d = d_;
    dp = padded_dim(d_);
  }

  __device__ __forceinline__ void eval(const float* p, float (&l)[1]) const {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (x != nullptr) {
      for (int j = 0; j < dp; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + j);
        const float4 b = *reinterpret_cast<const float4*>(p + dp + j);
        acc[0] = quad(a.x, b.x, x[j], acc[0]);
        acc[1] = quad(a.y, b.y, j + 1 < d ? x[j + 1] : 0.f, acc[1]);
        acc[2] = quad(a.z, b.z, j + 2 < d ? x[j + 2] : 0.f, acc[2]);
        acc[3] = quad(a.w, b.w, j + 3 < d ? x[j + 3] : 0.f, acc[3]);
      }
    }
    l[0] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + p[2 * dp];
  }
};

// A run of component rows [n_rows][P] in device memory and the block's
// staging buffers: chunks of ch rows, two buffers when ch < n_rows.
struct RowStream {
  const float* rows;
  float* buf;
  int n_rows, P, ch;

  __device__ __forceinline__ int rows_in(int c) const {
    return min(ch, n_rows - c * ch);
  }
  __device__ __forceinline__ float* chunk(int c) const {
    return buf + (size_t)(c & 1) * ch * P;
  }
  // start the block's copy of chunk c (every thread calls)
  __device__ __forceinline__ void fetch(int c) const {
    const float* src = rows + (size_t)c * ch * P;
    float* dst = chunk(c);
    const int n = rows_in(c) * P;
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
  }
};

// Walks st's rows, K to a speaker, over the lane's frames: after a
// speaker's last row, emit(s, lse) with s counted from the run's first
// speaker and lse[i] the online logsumexp of frame i. Frames::STAGED: the
// caller has started st.fetch(0); every thread of the block calls, and a
// warp that is not `active` only keeps the copies and barriers going.
// Otherwise the rows are read where they lie and an inactive warp returns.
template <class Frames, class Emit>
__device__ __forceinline__ void walk_components(const RowStream& st, int K,
                                                bool active, const Frames& fr,
                                                Emit&& emit) {
  constexpr int FPL = Frames::FPL;
  OnlineLse lse[FPL];
  int kk = 0, s = 0;
  // n rows from base, in runs that end with the chunk or with a speaker
  auto run = [&](const float* base, int n) {
    while (n > 0) {
      const int seg = min(n, K - kk);
#pragma unroll 2
      for (int r = 0; r < seg; ++r) {
        float l[FPL];
        fr.eval(base + (size_t)r * st.P, l);
#pragma unroll
        for (int i = 0; i < FPL; ++i) lse[i].add(l[i]);
      }
      base += (size_t)seg * st.P;
      n -= seg;
      kk += seg;
      if (kk == K) {
        emit(s++, lse);
        kk = 0;
#pragma unroll
        for (int i = 0; i < FPL; ++i) lse[i] = OnlineLse();
      }
    }
  };
  if constexpr (!Frames::STAGED) {
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
