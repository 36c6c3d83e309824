// What the two batched scoring kernels share, csrc/gmm_score.cu (f32) and
// csrc/gmm_score_bf16.cu (bf16 on the tensor cores): the SM count their
// launch plans read, and the second kernel that adds the warp tiles'
// partial sums [B][NW][S] in tile order and divides by the valid frames.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RT = 128;  // threads of the reduction block

// The current device's SM count, asked of the runtime once per device.
cudaError_t sm_count(int* nsm) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES];  // 0: not asked yet; every writer agrees
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *nsm = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cached[dev] = *nsm;
  return err;
}

// out[b, s] = the warp tiles' partial sums, added in tile order, over
// max(valid frames, 1); one thread per (b, s).
__global__ void __launch_bounds__(RT) bank_mean_kernel(
    const float* __restrict__ partial, const float* __restrict__ count,
    float* __restrict__ out, long long BS, int S, int NW) {
  const long long i = (long long)blockIdx.x * RT + threadIdx.x;
  if (i >= BS) return;
  const long long b = i / S;
  const int s = (int)(i % S);
  float acc = 0.f, n = 0.f;
  for (int w = 0; w < NW; ++w) {
    acc += partial[((size_t)b * NW + w) * S + s];
    n += count[(size_t)b * NW + w];
  }
  out[i] = acc / fmaxf(n, 1.f);
}

}  // namespace
