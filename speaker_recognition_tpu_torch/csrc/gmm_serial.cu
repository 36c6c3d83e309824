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
// component by component from GmmBank.serial_operator: comp [S, K, P],
// per component the quadratic terms a (zero-padded to DP), the linear terms
// b (likewise), cw and zeros (P = 2*DP + 4, DP = d rounded up to 8). Unlike
// the TPU kernel it applies the floor, as models/gmm.per_frame_loglik does.
//
// What bounds it on this card: per frame and speaker it does 2*d*K FMAs
// and K exponentials against d floats of features; a speaker's parameters
// (K*P floats, 70 KB at K=256, d=28) are reused by every frame. A loop
// that reads a frame value and two parameters from shared memory per two
// FMAs is capped by shared-memory bandwidth at ~21 FMA/clk/SM (a first
// version of that shape ran at 7 TFLOP/s); and the serial path's few
// hundred frames leave few warps.
//
// What the design does about it: the grid is (chunk of NT frames,
// speaker). A block copies its speaker's component-major parameters into
// shared memory with 16-byte asynchronous copies, and each lane keeps its
// frame's features in registers. Every lane walks the same component at
// the same time, so a parameter load is one broadcast wavefront for the
// warp's 32 frames, and a_j x^2 + b_j x is x (a_j x + b_j): two FMAs,
// in four independent chains. The logsumexp over components runs online
// (one exponential per component). Each block writes its partial sum and
// valid-frame count to a scratch buffer; a second kernel, one block per
// speaker, adds the chunks in a fixed order. No reduction uses atomics,
// so scores are the same bit for bit from run to run (calibrate_rejection
// thresholds on them).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;      // threads per chunk block = frames per chunk
constexpr int RT = 128;      // threads of the chunk-reduction block
constexpr int DSTEP = 8;     // feature dims are padded to a multiple of this
constexpr int MAX_DP = 96;   // widest padded feature dimension compiled
// log(1e-15), the reference's probability floor (src/gmm/src/gmm.cc:482-492)
constexpr float LOG_MIN_PROB = -34.538776394910684f;
constexpr float UNDERFLOW_LOG = -745.f;

int padded_dim(int d) { return (d + DSTEP - 1) / DSTEP * DSTEP; }

template <int DP>
__global__ void __launch_bounds__(NT) serial_chunk_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ comp, float2* __restrict__ partial, int n,
    int d, int K) {
  constexpr int P = 2 * DP + 4;
  extern __shared__ __align__(16) float sm[];
  float* red_s = sm + K * P;
  float* red_c = red_s + NT;
  const int c = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;

  const float* src = comp + (size_t)s * K * P;
  for (int i = tid * 4; i < K * P; i += NT * 4)
    __pipeline_memcpy_async(sm + i, src + i, 16);
  __pipeline_commit();

  // this lane's frame in registers, zeros past d (their a and b are 0)
  const int t = c * NT + tid;
  float xv[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j)
    xv[j] = (t < n && j < d) ? x[(size_t)t * d + j] : 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();

  float m = -INFINITY, sum = 0.f;
  for (int k = 0; k < K; ++k) {
    const float4* p = reinterpret_cast<const float4*>(sm + k * P);
    float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      const float4 a = p[q], b = p[DP / 4 + q];
      l0 = fmaf(fmaf(a.x, xv[4 * q], b.x), xv[4 * q], l0);
      l1 = fmaf(fmaf(a.y, xv[4 * q + 1], b.y), xv[4 * q + 1], l1);
      l2 = fmaf(fmaf(a.z, xv[4 * q + 2], b.z), xv[4 * q + 2], l2);
      l3 = fmaf(fmaf(a.w, xv[4 * q + 3], b.w), xv[4 * q + 3], l3);
    }
    const float l = ((l0 + l1) + (l2 + l3)) + sm[k * P + 2 * DP];
    if (l > m) {
      sum = sum * expf(m - l) + 1.f;
      m = l;
    } else {
      sum += expf(l - m);
    }
  }
  float acc = 0.f, cnt = 0.f;
  if (t < n && mask[t]) {
    const float lse = m + logf(sum);
    acc = lse > UNDERFLOW_LOG ? lse : LOG_MIN_PROB;
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

template <int DP>
cudaError_t launch_chunks(dim3 grid, int smem, cudaStream_t st,
                          const float* x, const unsigned char* mask,
                          const float* comp, float2* partial, int n, int d,
                          int K) {
  cudaError_t err = cudaFuncSetAttribute(
      serial_chunk_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  serial_chunk_kernel<DP><<<grid, NT, smem, st>>>(x, mask, comp, partial, n,
                                                  d, K);
  return cudaGetLastError();
}

}  // namespace

// Floats per component in GmmBank.serial_operator at feature dimension d,
// or -1 past the widest compiled dimension.
extern "C" int srt_serial_row(int d) {
  const int dp = padded_dim(d);
  return d < 1 || dp > MAX_DP ? -1 : 2 * dp + 4;
}

// Chunk blocks per speaker for an n-frame utterance: the partial buffer
// holds S x this many (sum, count) pairs.
extern "C" int srt_serial_chunks(int n) {
  return n > 0 ? (n + NT - 1) / NT : 1;
}

// A chunk block's shared memory (parameters, reduction), all of it dynamic.
extern "C" int srt_serial_smem_bytes(int d, int K) {
  return (int)(sizeof(float) * ((size_t)K * srt_serial_row(d) + 2 * NT));
}

extern "C" int srt_bank_sum_loglik(const void* x, const void* mask,
                                   const void* comp, void* partial, void* out,
                                   int n, int d, int S, int K, int avg,
                                   void* stream) {
  const dim3 grid(srt_serial_chunks(n), S);
  const int smem = srt_serial_smem_bytes(d, K);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const unsigned char* mk = (const unsigned char*)mask;
  const float* cp = (const float*)comp;
  float2* pt = (float2*)partial;
  cudaError_t err;
  switch (padded_dim(d)) {
#define SRT_SERIAL_CASE(DP)                                          \
  case DP:                                                           \
    err = launch_chunks<DP>(grid, smem, st, xf, mk, cp, pt, n, d, K); \
    break;
    SRT_SERIAL_CASE(8) SRT_SERIAL_CASE(16) SRT_SERIAL_CASE(24)
    SRT_SERIAL_CASE(32) SRT_SERIAL_CASE(40) SRT_SERIAL_CASE(48)
    SRT_SERIAL_CASE(56) SRT_SERIAL_CASE(64) SRT_SERIAL_CASE(72)
    SRT_SERIAL_CASE(80) SRT_SERIAL_CASE(88) SRT_SERIAL_CASE(96)
#undef SRT_SERIAL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  serial_reduce_kernel<<<S, RT, 0, st>>>(pt, (float*)out, grid.x, avg);
  return (int)cudaGetLastError();
}
