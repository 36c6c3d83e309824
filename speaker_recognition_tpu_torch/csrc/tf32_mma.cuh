// The tensor cores' TF32 product in three terms, shared by the signal
// tile's projection (csrc/signal_tile.cuh) and the batched bank scoring
// (csrc/gmm_score.cu): an operand x is split as hi = tf32(x) and lo =
// tf32(x - hi), and A . B is summed as lo.hi + hi.lo + hi.hi, three
// mma.sync m16n8k8 products with f32 accumulation. hi carries 11 bits of
// x's 24 and lo the next 11, so the split leaves ~2^-22 of x, and the
// dropped lo.lo is ~2^-22 of the product, where one TF32 term alone errs
// by ~2^-11 a product.
//
// The accumulation is not IEEE: the tensor cores add C and a k-step's 8
// exact products aligned to the largest of them, cut toward zero below its
// 24th bit, and cut the sum toward zero to a float. A sum carried in C
// across k-steps thus loses up to an ulp of the running sum each product,
// all in one direction: on an H100, bank scores whose accumulators started
// at the components' cw (O(50-200)) read 1.1e-4 (d = 38) to 1.05e-3 (d =
// 128) from float64, against 1.2e-5 to 4.1e-5 on the FP32 cores. So
// csrc/gmm_score.cu sums its product in parts, each into an accumulator
// from zero (mma_tf32_zero, then the other terms), adds the parts in f32
// to nearest, and cw last.
//
// tf32(x) rounds to nearest, ties away, as cvt.rna.tf32.f32 does (the low
// 13 bits cleared after adding half their unit), in two integer operations
// where the conversion takes the slower conversion pipe; mma_tf32 adds
// A . B to one m16n8k8 accumulator tile, mma_tf32_zero writes A . B to it.
// Fragments (PTX ISA, m16n8k8 with .tf32), lane = 4 g + t: A's registers
// hold A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; B's B[t][g],
// B[t + 4][g]; the accumulator C[g][2 t], C[g][2 t + 1], C[g + 8][2 t],
// C[g + 8][2 t + 1]. The g++ stand-in of tests/cuda_standin defines tf32
// and mma_tf32 for the CPU, the adder as described.
//
// ROADMAP precision rule: the tensor cores' TF32 only through the
// three-term split; torch.backends.cuda.matmul.allow_tf32 stays False.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef CUSIM_ASM
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

__device__ __forceinline__ void mma_tf32_zero(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma_tf32(c, a, b0, b1);
}

// x = hi + lo, both TF32, lo what hi leaves
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

}  // namespace
