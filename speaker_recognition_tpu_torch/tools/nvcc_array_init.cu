// The compiler fault behind reset() in csrc/gmm_mma.cuh, reduced: a 2-D
// local array of a struct with default member initializers, folded in a
// loop. nvcc's front end lowers `L lse[2][2];` to a memset of 0 and the four
// `m = -INFINITY` stores; the device optimizer of CUDA 12.9 (V12.9.86) keeps
// the stores of the first row only, so lse[1][*] start at m = 0 and a fold of
// values below -87 underflows there. The 1-D array and the array reset field
// by field come out right. Build and run on a Hopper card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o nvcc_array_init nvcc_array_init.cu && ./nvcc_array_init
//
// It prints each variant's m and sum and exits 1 when the 2-D array's
// initializers were lost.
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

struct L {
  float m = -INFINITY, sum = 0.f;
  __device__ __forceinline__ void add(float l) {
    const float diff = l - m;
    const float e = exp2f(-1.4426950408889634f * fabsf(diff));
    sum = diff > 0.f ? fmaf(sum, e, 1.f) : sum + e;
    m = fmaxf(m, l);
  }
};

// VARIANT 0: L[2][2] by its initializers; 1: the same, reset field by field
// first; 2: L[4] by its initializers.
template <int VARIANT>
__global__ void fold(const float* v, int n, float* out) {
  L a[2][2], b[4];
  if (VARIANT == 1)
    for (int i = 0; i < 4; ++i) {
      a[i / 2][i % 2].m = -INFINITY;
      a[i / 2][i % 2].sum = 0.f;
    }
  for (int r = 0; r < n; r += 4)
    for (int i = 0; i < 4; ++i) {
      if (VARIANT == 2)
        b[i].add(v[r + i]);
      else
        a[i / 2][i % 2].add(v[r + i]);
    }
  for (int i = 0; i < 4; ++i) {
    const L& l = VARIANT == 2 ? b[i] : a[i / 2][i % 2];
    out[2 * i] = l.m;
    out[2 * i + 1] = l.sum;
  }
}

int main() {
  const int n = 16;
  float h[n];
  for (int i = 0; i < n; ++i) h[i] = -100.f - 0.25f * i;  // all below -87
  float *v, *out;
  cudaMalloc(&v, sizeof h);
  cudaMalloc(&out, 8 * sizeof(float));
  cudaMemcpy(v, h, sizeof h, cudaMemcpyHostToDevice);
  const char* names[] = {"L[2][2], initializers", "L[2][2], reset by field",
                         "L[4], initializers"};
  bool lost = false;
  for (int k = 0; k < 3; ++k) {
    if (k == 0) fold<0><<<1, 1>>>(v, n, out);
    if (k == 1) fold<1><<<1, 1>>>(v, n, out);
    if (k == 2) fold<2><<<1, 1>>>(v, n, out);
    float r[8];
    if (cudaMemcpy(r, out, sizeof r, cudaMemcpyDeviceToHost) != cudaSuccess)
      return 2;
    printf("%-26s", names[k]);
    for (int i = 0; i < 4; ++i) {
      // m is the largest of the values folded: -100 - 0.25 i
      printf("  [%d] m %.2f sum %.3g", i, r[2 * i], r[2 * i + 1]);
      if (r[2 * i] != h[i]) {
        printf(" (want m %.2f)", h[i]);
        if (k == 0) lost = true;
      }
    }
    printf("\n");
  }
  return lost ? 1 : 0;
}
