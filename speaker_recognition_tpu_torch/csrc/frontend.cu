// Packed MFCC + LPC frontend for Hopper (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run_packed_signals
// (the signal-level fused frontend): for frame f of utterance b,
//     x  = signals[b, f*fshift : f*fshift + flen]
//     X  = x . D                    (window, pre-emphasis and half-spectrum
//                                    DFT folded into D [flen, ncols])
//     Y  = X^2
//     ceps = log(max(Y . W, floor)) . dct        -> feat[b, f, :nceps]
//     r  = Y . A,  lpc = Levinson(r), non-finite -> 0
//                                                -> feat[b, f, nceps:]
// then masked per-utterance CMVN over the first n_valid[b] frames (second
// kernel), and every frame at or past n_valid[b] is zero.
//
// What bounds it on this card: the DFT product is ~2*flen*ncols FLOPs per
// frame (262k at 8 kHz) against 4*fshift bytes of new signal per frame, so
// it is compute-bound on FP32 CUDA cores (no TF32: the features feed a
// log and a Levinson recursion that amplify rounding), and within the SM
// the limit is shared-memory bandwidth as much as FMA issue. D is
// [256, 512] f32 = 512 KB at 8 kHz, more than a block's shared memory.
//
// What the design does about it:
//   * a block owns FT consecutive frames of one utterance and stages their
//     overlapping samples once in shared memory (frame f is a strided
//     window: no frame matrix in device memory, no roll);
//   * the packed columns are walked in chunks of CC = 128. Per chunk each
//     warp computes X for its FT/8 frames x 128 columns, a lane holding
//     FT/8 frames x 4 columns in registers: per 4 k one 16-byte broadcast
//     load per frame (4 samples) and four 16-byte loads of D, so loads
//     issue back to back ahead of 64 FMAs per frame;
//   * Y = X^2 goes to shared memory only to be folded into the mel and
//     autocorrelation sums (both linear in Y), whose [FT, 8*OPL] tile stays
//     in registers across all chunks (a lane: FT/32 frames x OPL outputs),
//     so X, Y and the partial sums never reach device memory;
//   * log/DCT and the order-p Levinson run per frame at the end of the
//     block, one thread per frame with the recursion in local memory;
//   * tiles that lie wholly past n_valid only write zeros.
// The tile stages and the CMVN live in csrc/packed_tile.cuh, shared with
// the fused predict monolith (csrc/predict_fused.cu).
// Built without --use_fast_math: isfinite() must survive and logf must be
// the accurate one (an all-zero frame gives r = 0 -> 0/0 -> LPC 0).

#include <cuda_runtime.h>

#include "packed_tile.cuh"

namespace {

template <int FT, int OPL>
__global__ void __launch_bounds__(NT, 1) packed_frontend_kernel(
    const float* __restrict__ signals, const int* __restrict__ n_valid,
    const float* __restrict__ D, const float* __restrict__ W,
    const float* __restrict__ A, const float* __restrict__ dct,
    float* __restrict__ feat, int Lp, int T, int flen, int fshift, int ncols,
    int nmel, int nac, int nceps, float power_floor) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, T - f0);
  const int order = nac > 0 ? nac - 1 : 0;
  const int nfeat = nceps + order;
  const int nvalid = n_valid[b];
  float* out = feat + ((size_t)b * T + f0) * nfeat;

  if (f0 >= nvalid) {  // block-uniform: the whole tile is padding
    for (int i = threadIdx.x; i < nf * nfeat; i += NT) out[i] = 0.f;
    return;
  }
  const float* sums = tile_sums<FT, OPL, false>(
      signals + (size_t)b * Lp + (size_t)f0 * fshift, Lp - f0 * fshift, D, W,
      A, smem, flen, fshift, ncols, nmel, nac, power_floor);
  tile_features<OPL>(sums, out, nf, nvalid - f0, dct, nmel, nac, nceps);
}

// Masked per-utterance CMVN of feat[b, :n_valid[b], :nceps], in place
// (cmvn_utterance): 32 columns x 16 frame groups per block.
constexpr int CG = 16;

__global__ void __launch_bounds__(32 * CG) cmvn_kernel(
    float* __restrict__ feat, const int* __restrict__ n_valid, int T,
    int nfeat, int nceps) {
  __shared__ float red[CG][32];
  __shared__ float stat[2][32];
  const int b = blockIdx.x;
  cmvn_utterance<CG>(feat + (size_t)b * T * nfeat, n_valid[b], nfeat, nceps,
                     threadIdx.x, threadIdx.y, red, stat);
}

template <int FT, int OPL>
cudaError_t launch(dim3 grid, int smem, cudaStream_t st, const float* sig,
                   const int* nv, const float* D, const float* W,
                   const float* A, const float* dct, float* feat, int Lp,
                   int T, int flen, int fshift, int ncols, int nmel, int nac,
                   int nceps, float power_floor) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_frontend_kernel<FT, OPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  packed_frontend_kernel<FT, OPL><<<grid, NT, smem, st>>>(
      sig, nv, D, W, A, dct, feat, Lp, T, flen, fshift, ncols, nmel, nac,
      nceps, power_floor);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the frontend block takes at this geometry, or -1
// when no tiling fits (nmel + nac > 128, or frames too long).
extern "C" int srt_frontend_smem_bytes(int flen, int fshift, int nmel,
                                       int nac) {
  int ft, opl;
  if (!pick(flen, fshift, nmel + nac, &ft, &opl)) return -1;
  return 4 * smem_floats(ft, opl, flen, fshift);
}

extern "C" int srt_packed_frontend(
    const void* signals, const void* n_valid, const void* D, const void* W,
    const void* A, const void* dct, void* feat, int B, int Lp, int T,
    int flen, int fshift, int ncols, int nmel, int nac, int nceps,
    float power_floor, int cmvn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int ft, opl;
  if (!pick(flen, fshift, nmel + nac, &ft, &opl))
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * smem_floats(ft, opl, flen, fshift);
  const dim3 grid((T + ft - 1) / ft, B);
  const auto* sig = (const float*)signals;
  const auto* nv = (const int*)n_valid;
  cudaError_t err;
  if (ft == 128)
    err = launch<128, 9>(grid, smem, st, sig, nv, (const float*)D,
                         (const float*)W, (const float*)A, (const float*)dct,
                         (float*)feat, Lp, T, flen, fshift, ncols, nmel, nac,
                         nceps, power_floor);
  else if (opl == 9)
    err = launch<64, 9>(grid, smem, st, sig, nv, (const float*)D,
                        (const float*)W, (const float*)A, (const float*)dct,
                        (float*)feat, Lp, T, flen, fshift, ncols, nmel, nac,
                        nceps, power_floor);
  else
    err = launch<64, 16>(grid, smem, st, sig, nv, (const float*)D,
                         (const float*)W, (const float*)A, (const float*)dct,
                         (float*)feat, Lp, T, flen, fshift, ncols, nmel, nac,
                         nceps, power_floor);
  if (err != cudaSuccess || !cmvn) return (int)err;
  const int order = nac > 0 ? nac - 1 : 0;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>((float*)feat, nv, T, nceps + order,
                                          nceps);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
