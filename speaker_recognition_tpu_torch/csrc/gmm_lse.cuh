// One frame's floored log-likelihood under one speaker's GMM, shared by
// csrc/gmm_score.cu (batched bank scoring) and csrc/predict_fused.cu (the
// fused predict monolith).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// log(1e-15), the reference's probability floor (src/gmm/src/gmm.cc:482-492)
constexpr float LOG_MIN_PROB = -34.538776394910684f;
constexpr float UNDERFLOW_LOG = -745.f;

// x [d] against the components prm [K][2d+1] (d quadratic terms, d linear
// terms, then cw, as models/gmm.bank_operators folds them):
//     logp[k] = sum_j prm[k][j] x_j^2 + prm[k][d+j] x_j + prm[k][2d]
// returns logsumexp_k logp[k], computed online (one exponential per
// component), floored: > -745 ? lse : log(1e-15).
__device__ __forceinline__ float floored_lse(const float* x, const float* prm,
                                             int d, int K) {
  const int P = 2 * d + 1;
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
  return lse > UNDERFLOW_LOG ? lse : LOG_MIN_PROB;
}

}  // namespace
