// The rate of mma.sync on this card as the signal kernel's projection
// (csrc/signal_tile.cuh) issues it: m16n8k8 with TF32 operands and f32
// accumulators, and m16n8k16 with bf16 operands for comparison, by warps a
// block (four blocks an SM) and independent accumulator chains a warp.
// A chain's products wait for each other, so the rate at one chain a warp
// is the instruction's latency, and the tensor cores fill only with
// several chains in flight on each SM sub-partition. Build and run on a
// Hopper card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o mma_rate mma_rate.cu && ./mma_rate
//
// It prints TFLOP/s and cycles an MMA an SM (at the clock in GHz given
// as its argument, else the card's cudaDevAttrClockRate) for each case.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

// CH chains of `iters` m16n8k8 TF32 (or, BF16, m16n8k16 bf16) products
template <int CH, bool BF16>
__global__ void chains(float* out, int iters) {
  float c[CH][4] = {};
  uint32_t a[4];
  const uint32_t b0 = threadIdx.x, b1 = 3 * threadIdx.x;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 1);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[ch][0]), "+f"(c[ch][1]), "+f"(c[ch][2]), "+f"(c[ch][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[ch][0]), "+f"(c[ch][1]), "+f"(c[ch][2]), "+f"(c[ch][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int ch = 0; ch < CH; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH, bool BF16>
void run(int sms, double ghz, int warps, float* out) {
  const int iters = 4096, blocks = 4 * sms;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  chains<CH, BF16><<<blocks, 32 * warps>>>(out, 16);
  cudaEventRecord(a);
  chains<CH, BF16><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double mmas = (double)blocks * warps * iters * CH;
  const double flop = BF16 ? 4096.0 : 2048.0;
  printf("%s, %d warps a block (4 blocks an SM), %d chains a warp: %.3f ms, "
         "%.1f TFLOP/s, %.2f cycles an MMA an SM\n",
         BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8", warps, CH, ms,
         mmas * flop / ms / 1e9, ms * 1e-3 * ghz * 1e9 / (mmas / sms));
}

int main(int argc, char** argv) {
  int dev = 0, sms = 0, khz = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  const double ghz = argc > 1 ? atof(argv[1]) : khz / 1e6;
  float* out;
  if (cudaMalloc(&out, (size_t)4 * sms * 8 * 32 * sizeof(float)) != 0)
    return 1;
  for (int w : {1, 2, 4, 8}) {
    run<1, false>(sms, ghz, w, out);
    run<4, false>(sms, ghz, w, out);
    run<8, false>(sms, ghz, w, out);
    run<4, true>(sms, ghz, w, out);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
