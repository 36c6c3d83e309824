// Full-spectrum MFCC frontend on an FFT, for Hopper (sm_90a), plain C
// interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run
// (mfcc_from_frames) wherever fft_size is a power of two:
//     power = max(|FFT_N(wp)|^2, floor)     (bins 0..N/2, per bin)
//     ceps  = log(max(power . mel, floor)) . dct,   r = power . acorr
// for windowed, pre-emphasized frames wp [n, flen] zero-padded to N;
// frames longer than N fold sample t onto t mod N, which is what the TPU
// kernel's C and S compute there (their columns alias). N = 64 .. 16384
// (fft_size 4096 at 44.1/48 kHz, 8192 and 16384 as at 96 and 192 kHz), up
// to 512 mel + autocorrelation outputs where a block's shared memory holds
// the tile (rfft::pick_opl). Writes pre-CMVN cepstra [n, nceps] and the RAW autocorrelation
// [n, nac] (nac = 0 for an MFCC-only config), as csrc/frontend_frames.cu's
// dense template does. An fft_size that is not a power of two takes the
// chirp-z kernel (csrc/frontend_chirp.cu) or, past its reach, the dense
// template; one of 32768 points or more the four-step route
// (csrc/frontend_big.cu).
//
// What bounds it on this card, and what the design does about it: see
// csrc/rfft_tile.cuh. The TPU kernel's dense product moved 12.6 MB of C
// and S through every block (34.6 GB a batch at 48 kHz); here each block
// reads its rfft::ft(N) frames once (6 KB each at 48 kHz) and the
// mel and autocorrelation rows once, and computes its twiddles.
// Built without --use_fast_math, for the accurate logf.

#include <cuda_runtime.h>

#include "rfft_tile.cuh"

namespace {

// Sample p < N of the tile's frame f: sample p of the frame, 0 past it;
// fold adds the samples t = p + N, p + 2N, ... of a frame longer than N,
// in that order (a block-uniform branch after all the first loads).
struct FrameRows {
  const float* fr;
  int flen, n;
  __device__ __forceinline__ float operator()(int f, int p) const {
    return p < flen ? fr[(size_t)f * flen + p] : 0.f;
  }
  template <int RP, class First>
  __device__ __forceinline__ void fold(int f, float2 (&v)[RP],
                                       First first) const {
    if (flen <= n) return;
    const float* x = fr + (size_t)f * flen;
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const int p = first(q);
      for (int t = p + n; t < flen; t += n) v[q].x += x[t];
      for (int t = p + 1 + n; t < flen; t += n) v[q].y += x[t];
    }
  }
};

// Past 512 outputs (OPL 64, nchunk > 1) the tile's sums go to rows of
// wsums [n][wstride] and the epilogue reads them there.
template <int N, int OPL>
__global__ void __launch_bounds__(rfft::nth(N)) fft_frames_kernel(
    const float* __restrict__ frames, const float4* __restrict__ op,
    const float* __restrict__ dct, float* __restrict__ ceps,
    float* __restrict__ r, int n, int flen, int nmel, int nac, int nceps,
    float power_floor, int nchunk, float* __restrict__ wsums) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int f0 = blockIdx.x * rfft::ft(N);
  const int nf = min(rfft::ft(N), n - f0);
  const FrameRows load{frames + (size_t)f0 * flen, flen, N};
  constexpr int NOP = rfft::nop(OPL);
  const int wstride = NOP * nchunk;
  float* wrows = wsums + (size_t)f0 * wstride;
  const float* sums = rfft::tile_sums<N, OPL, true>(
      load, nf, smem, op, nmel, power_floor, nchunk, wrows, wstride);
  if (OPL == 64 && nchunk > 1)
    rfft::frame_outputs<NOP, rfft::nth(N)>(wrows, dct, ceps, r, f0, nf, nmel,
                                           nac, nceps, wstride);
  else
    rfft::frame_outputs<NOP, rfft::nth(N)>(sums, dct, ceps, r, f0, nf, nmel,
                                           nac, nceps);
}

template <int N, int OPL>
cudaError_t launch(cudaStream_t st, const float* frames, const float4* op,
                   const float* dct, float* ceps, float* r, int n, int flen,
                   int nmel, int nac, int nceps, float power_floor,
                   float* wsums) {
  const int smem = 4 * rfft::smem_floats(N, OPL);
  cudaError_t err = cudaFuncSetAttribute(
      fft_frames_kernel<N, OPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fft_frames_kernel<N, OPL>
      <<<(n + rfft::ft(N) - 1) / rfft::ft(N), rfft::nth(N), smem, st>>>(
          frames, op, dct, ceps, r, n, flen, nmel, nac, nceps, power_floor,
          rfft::out_chunks(nmel + nac), wsums);
  return cudaGetLastError();
}

}  // namespace

// The packed operator an FFT tile takes at an nfft-point FFT with nout =
// nmel + nac outputs: rows x cols floats, row k = [mel row k | acorr row k
// | 0] for k <= nfft/2, zero rows after; past 512 outputs *chunks stacked
// operators of 512 columns, chunk c holding outputs [512 c, 512 c + 512).
// Returns -1 when no tile serves them (nfft not a power of two in [64,
// 16384]). The fused predict monolith takes one chunk only.
extern "C" int srt_fft_operator_shape(int nfft, int nout, int* rows,
                                      int* cols, int* chunks) {
  const int opl = rfft::pick_opl(nfft, nout, true);
  if (opl == 0) return -1;
  *chunks = rfft::out_chunks(nout);
  *rows = rfft::op_rows(nfft, opl) * *chunks;
  *cols = rfft::nop(opl);
  return 0;
}

// Floats of the device rows a tile call keeps its sums in past 512
// outputs: [nframes][512 * chunks]; 0 up to 512 outputs.
extern "C" long long srt_fft_wide_floats(long long nframes, int nout) {
  const int c = rfft::out_chunks(nout);
  return c > 1 ? nframes * rfft::nop(64) * c : 0;
}

// frames [n, flen] windowed and pre-emphasized; op the packed [mel |
// acorr] operator of srt_fft_operator_shape; dct [nmel, nceps]; wsums the
// srt_fft_wide_floats(n, nmel + nac) floats past 512 outputs; writes ceps
// [n, nceps] and r [n, nac].
extern "C" int srt_fft_frames_frontend(
    const void* frames, const void* op, const void* dct, void* ceps, void* r,
    void* wsums, int n, int flen, int nfft, int nmel, int nac, int nceps,
    float power_floor, void* stream) {
  const int opl = rfft::pick_opl(nfft, nmel + nac, true);
  if (n < 1 || opl == 0) return (int)cudaErrorInvalidValue;
  return (int)rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      return launch<decltype(nc)::value, decltype(oc)::value>(
          (cudaStream_t)stream, (const float*)frames, (const float4*)op,
          (const float*)dct, (float*)ceps, (float*)r, n, flen, nmel, nac,
          nceps, power_floor, (float*)wsums);
    });
  });
}
