// Single-utterance speaker-bank scoring for Hopper (sm_90a), plain C
// interface: the serial and open-set path (GMMSet._scores, llr_scores).
//
// Replaces speaker_recognition_tpu/ops/pallas_gmm.py:_run (the kernel under
// bank_sum_loglik / bank_avg_loglik): for one utterance x [n, d] with mask
// [n] and a bank of S GMMs with K components each,
//     logp[t, k] = sum_j op[j, s*K+k] * [x_t^2 | x_t]_j + cw[s*K+k]
//     lse[t]     = logsumexp_k logp[t, k], floored: lse > -745 ? lse
//                                                         : log(1e-15)
//     out[s]     = sum_t mask[t] * lse[t]      (or / max(sum_t mask[t], 1))
// with op [2d, S*K] and cw [S*K] from models/gmm.bank_operators, read here
// component by component from GmmBank.component_operator (the row layout
// of csrc/gmm_lse.cuh). Unlike the TPU kernel it applies the floor, as
// models/gmm.per_frame_loglik does.
//
// What bounds it on this card: per frame and speaker it does 2*d*K FMAs
// and K exponentials against d floats of features; a speaker's parameters
// (K*P floats, 62 KB at K=256, d=28) are reused by every frame. A loop
// that reads a frame value and two parameters from shared memory per two
// FMAs is capped by shared-memory bandwidth at ~21 FMA/clk/SM (a first
// version of that shape ran at 7 TFLOP/s); and the serial path's few
// hundred frames leave few warps.
//
// What the design does about it: the grid is (chunk of NT frames,
// speaker). A block streams its speaker's component rows through shared
// memory with 16-byte asynchronous copies (all K rows in one buffer while
// they fit a block's shared memory, else chunks in two buffers, so K has
// no cap) and each lane keeps its frame's features in registers
// (RegFrames of csrc/gmm_lse.cuh, the inner loop the batched kernel
// shares): a parameter load is one broadcast for the warp's 32 frames and
// a_j x^2 + b_j x is x (a_j x + b_j), two FMAs in four independent chains.
// The route follows the feature dimension: registers up to a padded d of
// 128, and past that WideFrames, which leaves the frame and the rows in
// device memory and so takes any d. The logsumexp over components runs
// online. Each block writes its partial sum and valid-frame count to a
// scratch buffer; a second kernel, one block per speaker, adds the chunks
// in a fixed order. No reduction uses atomics, so scores are the same bit
// for bit from run to run (calibrate_rejection thresholds on them).

#include <cuda_runtime.h>
#include <math.h>

#include "gmm_lse.cuh"

namespace {

constexpr int NT = 128;      // threads per chunk block = frames per chunk
constexpr int RT = 128;      // threads of the chunk-reduction block
// a block's dynamic shared memory beside the static reduction arrays
constexpr int ONE_BUFFER = BLOCK_SMEM - 2 * NT * (int)sizeof(float);

// Frames: RegFrames<DP, 1> or WideFrames; ch: rows per staged chunk.
template <class Frames>
__global__ void __launch_bounds__(NT) serial_chunk_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ comp, float2* __restrict__ partial, int n,
    int d, int K, int ch) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red_s[NT], red_c[NT];
  const int c = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int P = row_floats(d);

  const RowStream st{comp + (size_t)s * K * P, sm, K, P, ch};
  if (Frames::STAGED) st.fetch(0);
  const int t = c * NT + tid;
  Frames fr;
  fr.load(0, t < n ? x + (size_t)t * d : nullptr, d);
  float lse = 0.f;
  walk_components(st, K, true, fr,
                  [&](int, OnlineLse (&v)[1]) { lse = v[0].floored(); });
  float acc = 0.f, cnt = 0.f;
  if (t < n && mask[t]) {
    acc = lse;
    cnt = 1.f;
  }
  red_s[tid] = acc;
  red_c[tid] = cnt;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_s[tid] += red_s[tid + w];
      red_c[tid] += red_c[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0)
    partial[(size_t)s * gridDim.x + c] = make_float2(red_s[0], red_c[0]);
}

// out[s] = sum of speaker s's chunk partials, each thread taking chunks
// tid, tid + RT, ... in order, then a fixed tree; divided by max(count, 1)
// when avg is set.
__global__ void __launch_bounds__(RT) serial_reduce_kernel(
    const float2* __restrict__ partial, float* __restrict__ out, int C,
    int avg) {
  __shared__ float red_s[RT], red_c[RT];
  const int s = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f, cnt = 0.f;
  for (int c = tid; c < C; c += RT) {
    const float2 p = partial[(size_t)s * C + c];
    acc += p.x;
    cnt += p.y;
  }
  red_s[tid] = acc;
  red_c[tid] = cnt;
  __syncthreads();
  for (int w = RT / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_s[tid] += red_s[tid + w];
      red_c[tid] += red_c[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) out[s] = avg ? red_s[0] / fmaxf(red_c[0], 1.f) : red_s[0];
}

template <class Frames>
cudaError_t launch_chunks(dim3 grid, int smem, cudaStream_t st,
                          const float* x, const unsigned char* mask,
                          const float* comp, float2* partial, int n, int d,
                          int K, int ch) {
  cudaError_t err = cudaFuncSetAttribute(
      serial_chunk_kernel<Frames>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  serial_chunk_kernel<Frames><<<grid, NT, smem, st>>>(x, mask, comp, partial,
                                                      n, d, K, ch);
  return cudaGetLastError();
}

}  // namespace

// Floats per component in GmmBank.component_operator at feature dimension
// d: the row both scoring kernels read.
extern "C" int srt_component_row(int d) { return d < 1 ? -1 : row_floats(d); }

// Chunk blocks per speaker for an n-frame utterance: the partial buffer
// holds S x this many (sum, count) pairs.
extern "C" int srt_serial_chunks(int n) {
  return n > 0 ? (n + NT - 1) / NT : 1;
}

extern "C" int srt_bank_sum_loglik(const void* x, const void* mask,
                                   const void* comp, void* partial, void* out,
                                   int n, int d, int S, int K, int avg,
                                   void* stream) {
  if (d < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(srt_serial_chunks(n), S);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const unsigned char* mk = (const unsigned char*)mask;
  const float* cp = (const float*)comp;
  float2* pt = (float2*)partial;
  const int dp = padded_dim(d);
  cudaError_t err;
  if (dp > MAX_REG_DP) {
    err = launch_chunks<WideFrames>(grid, 0, st, xf, mk, cp, pt, n, d, K, K);
  } else {
    int smem;
    const int ch = plan_chunks(K, row_floats(d), ONE_BUFFER, &smem);
    switch (dp) {
#define SRT_SERIAL_CASE(DP)                                              \
  case DP:                                                               \
    err = launch_chunks<RegFrames<DP, 1>>(grid, smem, st, xf, mk, cp, pt, n, \
                                          d, K, ch);                     \
    break;
      SRT_SERIAL_CASE(4) SRT_SERIAL_CASE(8) SRT_SERIAL_CASE(12)
      SRT_SERIAL_CASE(16) SRT_SERIAL_CASE(20) SRT_SERIAL_CASE(24)
      SRT_SERIAL_CASE(28) SRT_SERIAL_CASE(32) SRT_SERIAL_CASE(36)
      SRT_SERIAL_CASE(40) SRT_SERIAL_CASE(44) SRT_SERIAL_CASE(48)
      SRT_SERIAL_CASE(52) SRT_SERIAL_CASE(56) SRT_SERIAL_CASE(60)
      SRT_SERIAL_CASE(64) SRT_SERIAL_CASE(68) SRT_SERIAL_CASE(72)
      SRT_SERIAL_CASE(76) SRT_SERIAL_CASE(80) SRT_SERIAL_CASE(84)
      SRT_SERIAL_CASE(88) SRT_SERIAL_CASE(92) SRT_SERIAL_CASE(96)
      SRT_SERIAL_CASE(100) SRT_SERIAL_CASE(104) SRT_SERIAL_CASE(108)
      SRT_SERIAL_CASE(112) SRT_SERIAL_CASE(116) SRT_SERIAL_CASE(120)
      SRT_SERIAL_CASE(124) SRT_SERIAL_CASE(128)
#undef SRT_SERIAL_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  serial_reduce_kernel<<<S, RT, 0, st>>>(pt, (float*)out, grid.x, avg);
  return (int)cudaGetLastError();
}
