// Speaker-bank GMM scoring for Hopper (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_gmm.py:_run_batch_lse together
// with the epilogue of its wrapper batch_bank_avg_loglik: for utterance b and
// speaker s,
//     logp[t, k] = sum_j op[j, s*K+k] * [x_t^2 | x_t]_j + cw[s*K+k]
//     lse[t]     = logsumexp_k logp[t, k], floored: lse > -745 ? lse
//                                                         : log(1e-15)
//     out[b, s]  = sum_t mask[b,t] * lse[t] / max(sum_t mask[b,t], 1)
// with op [2d, S*K] and cw [S*K] the frame-major joint-density operator of
// models/gmm.bank_operators.
//
// What bounds it on this card: per frame and speaker it reads d floats of
// features and does 2*d*K FMAs and K exponentials, so it is compute- and
// shared-memory-bound; the unfused form writes a [B*T, S*K] log-density
// tensor to device memory and reads it back (84 MB at the bench batch).
//
// What the design does about it: one block per (speaker, utterance) keeps
// that speaker's K components (K*(2d+1) floats: 7 KB at K=32, d=28; 58 KB
// at K=256) in shared memory, stages FT frames at a time, and gives each
// thread one frame whose logsumexp over K runs online (one exponential per
// component), so no [n, S*K] tensor exists. The floor, the mask and the
// per-utterance mean are fused; the block sums its frames in a fixed tree
// order, so the result is deterministic and needs no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GT = 128;  // threads per block = frames per staged tile
// log(1e-15), the reference's probability floor (src/gmm/src/gmm.cc:482-492)
constexpr float LOG_MIN_PROB = -34.538776394910684f;
constexpr float UNDERFLOW_LOG = -745.f;

__global__ void __launch_bounds__(GT) bank_score_kernel(
    const float* __restrict__ feats, const unsigned char* __restrict__ mask,
    const float* __restrict__ op, const float* __restrict__ cw,
    float* __restrict__ out, int T, int d, int S, int K) {
  extern __shared__ float sm[];
  __shared__ float red_s[GT], red_c[GT];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int SK = S * K;
  const int P = 2 * d + 1;   // per component: quadratic d, linear d, cw
  const int XS = d + 1;      // odd row stride: conflict-free frame reads
  float* prm = sm;           // [K][P]
  float* xt = prm + K * P;   // [GT][XS]

  for (int i = tid; i < 2 * d * K; i += GT) {
    const int j = i / K, k = i % K;
    prm[k * P + j] = op[(size_t)j * SK + s * K + k];
  }
  for (int k = tid; k < K; k += GT) prm[k * P + 2 * d] = cw[s * K + k];

  const float* xb = feats + (size_t)b * T * d;
  const unsigned char* mb = mask + (size_t)b * T;
  float acc = 0.f, cnt = 0.f;
  for (int t0 = 0; t0 < T; t0 += GT) {
    const int nt = min(GT, T - t0);
    __syncthreads();  // parameters staged / previous tile consumed
    for (int i = tid; i < nt * d; i += GT)
      xt[(i / d) * XS + i % d] = xb[(size_t)t0 * d + i];
    __syncthreads();
    if (tid < nt && mb[t0 + tid]) {
      const float* x = xt + tid * XS;
      float m = -INFINITY, sum = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* p = prm + k * P;
        float l = 0.f;
        for (int j = 0; j < d; ++j) {
          const float v = x[j];
          l = fmaf(p[j], v * v, l);
          l = fmaf(p[d + j], v, l);
        }
        l += p[2 * d];
        if (l > m) {
          sum = sum * expf(m - l) + 1.f;
          m = l;
        } else {
          sum += expf(l - m);
        }
      }
      const float lse = m + logf(sum);
      acc += lse > UNDERFLOW_LOG ? lse : LOG_MIN_PROB;
      cnt += 1.f;
    }
  }
  red_s[tid] = acc;
  red_c[tid] = cnt;
  __syncthreads();
  for (int w = GT / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_s[tid] += red_s[tid + w];
      red_c[tid] += red_c[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) out[(size_t)b * S + s] = red_s[0] / fmaxf(red_c[0], 1.f);
}

}  // namespace

extern "C" int srt_gmm_smem_bytes(int d, int K) {
  return (int)(sizeof(float) * ((size_t)K * (2 * d + 1) + GT * (d + 1)));
}

extern "C" int srt_bank_avg_loglik(const void* feats, const void* mask,
                                   const void* op, const void* cw, void* out,
                                   int B, int T, int d, int S, int K,
                                   void* stream) {
  const int smem = srt_gmm_smem_bytes(d, K);
  cudaError_t err = cudaFuncSetAttribute(
      bank_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bank_score_kernel<<<dim3(S, B), GT, smem, (cudaStream_t)stream>>>(
      (const float*)feats, (const unsigned char*)mask, (const float*)op,
      (const float*)cw, (float*)out, T, d, S, K);
  return (int)cudaGetLastError();
}
