// The packed frontend with bf16 DFT operands, for Hopper (sm_90a), plain C
// interface: K1's and K4's mm_bf16 mode.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run_packed_signals
// with mm_bf16 (packed_from_signals, :397; the cast in the kernel at
// :292-296) and :_run_packed with bf16 frames and D (packed_from_frames,
// :441; the cast at :452). For frame f,
//     X = bf16(frame) . bf16(D),  Y = X^2      (products exact in f32, f32
//                                              sums)
//     ceps = log(max(Y . W, floor)) . dct,  r = Y . A
// the TPU kernel's dense product with its DFT operands rounded to bf16
// (nearest even); Y and everything after it stay f32. K1 (srt_frontend_bf16)
// frames a padded signal batch itself (frame f of utterance b is
// signals[b, f*fshift : f*fshift + flen]) and writes feat [B, T, nceps +
// order] (Levinson, non-finite -> 0) or, without fuse_lpc, [B, T, nceps +
// nac] (the raw autocorrelation the LPC cepstra take), zeros at frames past
// n_valid, then masked per-utterance CMVN of the cepstra; MFCC only is nac
// = 0. K4 (srt_frames_bf16) takes independent raw frames [n, flen] and
// writes pre-CMVN cepstra | raw autocorrelation [n, nceps + nac].
//
// What bounds it on this card: the dense product, 2 * flen * ncols FLOPs a
// frame (262 kFLOP at 8 kHz), which the rounding is about: the FFT of the
// f32 route (csrc/frontend.cu) would not round D at all. At the bf16 tensor
// cores' peak that is 0.04 ms for the bench batch, its 84 MB of signal
// 0.025 ms at the memory rate; past the products, the f32 projection onto
// the mel and autocorrelation outputs (68 kFLOP a frame at 8 kHz, 0.16 ms
// at the FP32 peak), the larger share.
//
// What the design does: the fused predict monolith's bf16 frontend phase
// (csrc/predict_fused.cuh, DenseBf16Tile) with the scoring compiled out,
// one block a tile of FT frames: tile_sums<FT, OPL> of csrc/packed_tile.cuh
// runs X = frame . D on the tensor cores (mma.sync m16n8k16, bf16 operands
// and f32 sums) from the samples staged once as bf16 and D packed once by
// the wrapper in the B fragments' order (ops/gpu_frontend.
// dft_mma_operator), then Y = X^2 . [W | A] in f32 FMAs, W | A packed once
// by the wrapper too (dense_wa_operator) and streamed in; tile_features
// takes the log-mel through the DCT and runs the Levinson. Any output
// count (chunks of 128 through device rows past 128) and any frame length
// and shift (tiles of 128, 64 or 32 frames, whichever keeps the most frames
// resident an SM, the samples read from device memory past what a 32-frame
// tile's shared memory holds), as the monolith's bf16 route takes them.
// K4's frames are the same tile over a frame matrix: consecutive rows of
// flen samples are a signal with fshift = flen. Every sum runs in a fixed
// order: two calls, the same bits. Built without --use_fast_math, for the
// accurate logf and isfinite.

#include <cuda_runtime.h>

#include <algorithm>

#include "packed_tile.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;  // utterances a launch takes

// One tile of FT frames of utterance blockIdx.y: sig [B][Lp] with frames f
// at f * fshift (K4: one utterance of n frames, fshift = flen), n_valid [B]
// or null (every frame valid), Dp the packed bf16 D, WAp the packed W |
// A. Past 128 outputs the sums go to rows of wsums [B * T][128 * nchunk]
// and tile_features reads them there.
template <int FT, int OPL, bool GSEG>
__global__ void __launch_bounds__(NT, 2) dense_bf16_kernel(
    const float* __restrict__ sig, const int* __restrict__ n_valid,
    const uint4* __restrict__ Dp, const uint4* __restrict__ WAp,
    const float* __restrict__ dct, float* __restrict__ feat,
    float* __restrict__ wsums, long long Lp, int T, int flen, int fshift,
    int ncols, int nmel, int nac, int nceps, float power_floor, int fuse_lpc,
    int nchunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const int nf = min(FT, T - f0);
  const int nfeat = feature_width(nceps, nac, fuse_lpc);
  const int nvalid = n_valid != nullptr ? n_valid[b] : T;
  float* out = feat + ((size_t)b * T + f0) * nfeat;
  if (f0 >= nvalid) {  // block-uniform: the whole tile is padding
    for (int i = threadIdx.x; i < nf * nfeat; i += NT) out[i] = 0.f;
    return;
  }
  const int wstride = 8 * OPL * nchunk;
  float* wrows = nchunk > 1 ? wsums + ((size_t)b * T + f0) * wstride
                            : nullptr;
  // samples from the tile's first to the end of the utterance (K4's run
  // may pass an int's range; a tile reads fewer than 2^30)
  const long long rest = Lp - (long long)f0 * fshift;
  const float* sums = tile_sums<FT, OPL, GSEG>(
      sig + (size_t)b * Lp + (size_t)f0 * fshift,
      rest < (1 << 30) ? (int)rest : (1 << 30), Dp, WAp, smem, flen, fshift,
      ncols, nmel, power_floor, nchunk, wrows, wstride, nf,
      min(nf, nvalid - f0));
  if (OPL == 16 && nchunk > 1)
    tile_features<OPL>(wrows, out, nf, nvalid - f0, dct, nmel, nac, nceps,
                       fuse_lpc != 0, wstride);
  else
    tile_features<OPL>(sums, out, nf, nvalid - f0, dct, nmel, nac, nceps,
                       fuse_lpc != 0);
}

// The tile of the geometry's pick (csrc/packed_tile.cuh), one launch per
// MAX_GRID_Y utterances.
template <int FT, int OPL, bool GSEG>
cudaError_t launch(int B, cudaStream_t st, const float* sig, const int* nv,
                   const uint4* Dp, const uint4* WAp, const float* dct,
                   float* feat, float* wsums, long long Lp,
                   int T, int flen, int fshift, int ncols, int nmel, int nac,
                   int nceps, float power_floor, int fuse_lpc, int nchunk) {
  const int smem = smem_bytes(FT, OPL, flen, fshift, GSEG);
  cudaError_t err = cudaFuncSetAttribute(
      dense_bf16_kernel<FT, OPL, GSEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const size_t nfeat = feature_width(nceps, nac, fuse_lpc);
  const size_t wstride = (size_t)8 * OPL * nchunk;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const dim3 grid((T + FT - 1) / FT, std::min(MAX_GRID_Y, B - b0));
    dense_bf16_kernel<FT, OPL, GSEG><<<grid, NT, smem, st>>>(
        sig + (size_t)b0 * Lp, nv != nullptr ? nv + b0 : nullptr, Dp, WAp,
        dct, feat + (size_t)b0 * T * nfeat,
        nchunk > 1 ? wsums + (size_t)b0 * T * wstride : nullptr, Lp, T, flen,
        fshift, ncols, nmel, nac, nceps, power_floor, fuse_lpc, nchunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_pick(int B, cudaStream_t st, const float* sig,
                        const int* nv, const uint4* Dp, const uint4* WAp,
                        const float* dct, float* feat,
                        float* wsums, long long Lp, int T, int flen,
                        int fshift, int ncols, int nmel, int nac, int nceps,
                        float power_floor, int fuse_lpc) {
  int ft, opl, gseg;
  pick(flen, fshift, nmel + nac, &ft, &opl, &gseg);
  const int nchunk = dense_chunks(nmel + nac);
  if (nchunk > 1 && wsums == nullptr) return cudaErrorInvalidValue;
#define SRT_BF16_LAUNCH(FT, OPL, GSEG)                                        \
  launch<FT, OPL, GSEG>(B, st, sig, nv, Dp, WAp, dct, feat, wsums, Lp, T,    \
                        flen, fshift, ncols, nmel, nac, nceps, power_floor,   \
                        fuse_lpc, nchunk)
  if (ft == 128) return SRT_BF16_LAUNCH(128, 9, false);
  if (ft == 64 && opl == 9) return SRT_BF16_LAUNCH(64, 9, false);
  if (ft == 64) return SRT_BF16_LAUNCH(64, 16, false);
  if (opl == 9)
    return gseg ? SRT_BF16_LAUNCH(32, 9, true) : SRT_BF16_LAUNCH(32, 9, false);
  return gseg ? SRT_BF16_LAUNCH(32, 16, true) : SRT_BF16_LAUNCH(32, 16, false);
#undef SRT_BF16_LAUNCH
}

// The resident blocks an SM of the tile at FT, OPL, GSEG with smem bytes.
template <int FT, int OPL, bool GSEG>
cudaError_t tile_occupancy(int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_bf16_kernel<FT, OPL, GSEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dense_bf16_kernel<FT, OPL, GSEG>, NT, smem);
}

}  // namespace

// The bf16 tile at a geometry (csrc/packed_tile.cuh pick) on the current
// device: out[0] its frames, out[1] its dynamic shared memory in bytes,
// out[2] its resident blocks an SM by the occupancy API. Returns a CUDA
// error code.
extern "C" int srt_frontend_bf16_occupancy(int flen, int fshift, int nout,
                                           int* out) {
  int ft, opl, gseg;
  pick(flen, fshift, nout, &ft, &opl, &gseg);
  const int smem = smem_bytes(ft, opl, flen, fshift, gseg);
  out[0] = ft;
  out[1] = smem;
  int* blocks = &out[2];
  if (ft == 128) return (int)tile_occupancy<128, 9, false>(smem, blocks);
  if (ft == 64 && opl == 9)
    return (int)tile_occupancy<64, 9, false>(smem, blocks);
  if (ft == 64) return (int)tile_occupancy<64, 16, false>(smem, blocks);
  if (opl == 9)
    return (int)(gseg ? tile_occupancy<32, 9, true>(smem, blocks)
                      : tile_occupancy<32, 9, false>(smem, blocks));
  return (int)(gseg ? tile_occupancy<32, 16, true>(smem, blocks)
                    : tile_occupancy<32, 16, false>(smem, blocks));
}

// Floats of device scratch a call over nframes frames takes past 128 mel +
// autocorrelation outputs: rows [nframes][128 * chunks] of the sums; 0 up
// to 128 outputs.
extern "C" long long srt_frontend_bf16_wide_floats(long long nframes,
                                                   int nout) {
  const int c = dense_chunks(nout);
  return c > 1 ? nframes * 128 * c : 0;
}

// K1 with bf16 DFT operands: signals [B, Lp], n_valid [B], Dp the packed
// D [flen, ncols] (ops/gpu_frontend.dft_mma_operator), WAp the packed W
// [ncols, nmel] | A [ncols, nac] (dense_wa_operator; nac = 0: MFCC only),
// dct [nmel, nceps], wsums of
// srt_frontend_bf16_wide_floats(B * T, nmel + nac); writes feat [B, T,
// nceps + nac - 1] (nceps without LPC), or with fuse_lpc 0 feat [B, T,
// nceps + nac], then CMVN of the cepstra when cmvn. Any B.
extern "C" int srt_frontend_bf16(const void* signals, const void* n_valid,
                                 const void* Dp, const void* WAp,
                                 const void* dct, void* feat, void* wsums,
                                 int B, int Lp, int T, int flen, int fshift,
                                 int ncols, int nmel, int nac, int nceps,
                                 float power_floor, int cmvn, int fuse_lpc,
                                 void* stream) {
  if (B < 1 || T < 1 || flen < 1 || fshift < 1 || Lp < flen)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* nv = (const int*)n_valid;
  cudaError_t err = launch_pick(
      B, st, (const float*)signals, nv, (const uint4*)Dp, (const uint4*)WAp,
      (const float*)dct, (float*)feat, (float*)wsums, Lp, T,
      flen, fshift, ncols, nmel, nac, nceps, power_floor, fuse_lpc);
  if (err != cudaSuccess || !cmvn) return (int)err;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>(
      (float*)feat, nv, T, feature_width(nceps, nac, fuse_lpc), nceps);
  return (int)cudaGetLastError();
}

// K4 with bf16 frames and D: frames [n, flen], Dp, WAp and dct as above,
// wsums of srt_frontend_bf16_wide_floats(n, nmel + nac); writes out [n,
// nceps + nac]: pre-CMVN cepstra | raw autocorrelation.
extern "C" int srt_frames_bf16(const void* frames, const void* Dp,
                               const void* WAp, const void* dct,
                               void* out, void* wsums, int n, int flen,
                               int ncols, int nmel, int nac, int nceps,
                               float power_floor, void* stream) {
  if (n < 1 || flen < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_pick(
      1, (cudaStream_t)stream, (const float*)frames, nullptr,
      (const uint4*)Dp, (const uint4*)WAp, (const float*)dct,
      (float*)out, (float*)wsums, (long long)n * flen, n, flen, flen, ncols,
      nmel, nac, nceps, power_floor, 0);
}
