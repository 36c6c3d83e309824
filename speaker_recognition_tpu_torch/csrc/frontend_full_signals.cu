// Full-spectrum MFCC + LPC frontend from the signals, on an FFT, for Hopper
// (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run
// (mfcc_from_frames) with the XLA work the JAX package's full route runs
// around it (speaker_recognition_tpu/features/extract.py:224 framing,
// window_preemph, then :306-350 masked CMVN and LPC or LPC cepstra), for
// an fft_size N that is a power of two (64 .. 16384). For frame f of
// utterance b,
//     x     = signals[b, f*fshift : f*fshift + flen]
//     y     = window and pre-emphasis of x, samples t >= N folded onto
//             t mod N (what C and S of a DFT shorter than the frame do)
//     power = max(|FFT_N(y)|^2, floor)      (bins 0..N/2, per bin)
//     ceps  = log(max(power . mel, floor)) . dct    -> feat[b, f, :nceps]
//     r     = power . acorr, then LPC = Levinson(r), non-finite -> 0, or
//             with n_lpcc > 0 the LPC cepstra of the unzeroed coefficients,
//             non-finite -> 0                       -> feat[b, f, nceps:]
// then masked per-utterance CMVN of the cepstra over the first n_valid[b]
// frames (cmvn_kernel, a second kernel), and every frame at or past
// n_valid[b] is zero.
//
// csrc/frontend_fft.cu computes the same spectrum from [B * T, flen] frames
// that torch windows and pre-emphasizes first (ops/framing), and its
// callers ran CMVN and the Levinson in torch after it: at 48 kHz two
// [B, T, 1536] f32 tensors (978 MB each for 512 x 5 s) written and one
// read back, then ~20 launches of torch for the tail. Here the tile loads
// each frame as a strided window of the signal, windowed and pre-emphasized
// per sample (rfft::SignalFrames, csrc/frontend.cu's loader), plus the fold
// of samples past N taken from the signal; its power floor is K5's, per
// bin (tile_sums<N, OPL, true>), not K1's (mel sums only), so the two
// kernels compute different functions; its tail is K1's (tile_features,
// csrc/packed_tile.cuh, with the LPC cepstra mode), and a tile wholly past
// n_valid writes zeros only.
//
// What bounds it on this card: the signals, read once (492 MB at 48 kHz
// for 512 x 5 s: 0.147 ms at 3.35 TB/s), beside ~15 GFLOP of FFT,
// projection and Levinson (0.2 ms at the FP32 peak). The tile (csrc/
// rfft_tile.cuh) is unchanged and sets the pace, as in csrc/frontend_fft.cu:
// one 32-frame block an SM at N = 2048. A file of its own so that nvcc
// builds its instantiations beside frontend_fft.cu's.
// Built without --use_fast_math: isfinite() must survive and logf must be
// the accurate one.

#include <cuda_runtime.h>

#include "packed_tile.cuh"
#include "rfft_tile.cuh"

namespace {

// What frame f of the tile folds onto its sample pair (p, p + 1) of an
// n-point FFT: the samples t = p + n, p + 2n, ... < flen (and from p + 1)
// summed in that order, each windowed and pre-emphasized as sample p is.
// Not inlined: inlined into each of a tile's unrolled loads it kept nvcc
// on this file several times as long as the rest of the build, for a path
// that only frames longer than the FFT take.
__device__ __noinline__ float2 fold_pair(const rfft::SignalFrames s, int f,
                                         int p, int n) {
  float2 v = make_float2(0.f, 0.f);
  for (int t = p + n; t < s.flen; t += n) v.x += s(f, t);
  for (int t = p + 1 + n; t < s.flen; t += n) v.y += s(f, t);
  return v;
}

// rfft::SignalFrames (sample p < N of the tile's frame f, windowed and
// pre-emphasized) and, for a frame longer than N, the fold (fold_pair; a
// block-uniform branch after all the first loads).
struct FoldedSignalFrames {
  rfft::SignalFrames s;
  int n;
  __device__ __forceinline__ float operator()(int f, int p) const {
    return s(f, p);
  }
  template <int RP, class First>
  __device__ __forceinline__ void fold(int f, float2 (&v)[RP],
                                       First first) const {
    if (s.flen <= n) return;
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const float2 w = fold_pair(s, f, first(q), n);
      v[q].x += w.x;
      v[q].y += w.y;
    }
  }
};

// Past 512 outputs (OPL 64, nchunk > 1) the tile's sums go to rows of
// wsums [B * T][wstride] and tile_features reads them there.
template <int N, int OPL>
__global__ void __launch_bounds__(rfft::nth(N)) full_signals_kernel(
    const float* __restrict__ signals, const int* __restrict__ n_valid,
    const float* __restrict__ win, const float4* __restrict__ op,
    const float* __restrict__ dct, float* __restrict__ feat, int Lp, int T,
    int flen, int fshift, int nmel, int nac, int nceps, float pre_emph,
    int preemph_first, float power_floor, int n_lpcc, int nchunk,
    float* __restrict__ wsums) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  constexpr int FT = rfft::ft(N), NTH = rfft::nth(N);
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, T - f0);
  const int nfeat = feature_width(nceps, nac, 1, n_lpcc);
  const int nvalid = n_valid[b];
  float* out = feat + ((size_t)b * T + f0) * nfeat;

  if (f0 >= nvalid) {  // block-uniform: the whole tile is padding
    for (int i = threadIdx.x; i < nf * nfeat; i += NTH) out[i] = 0.f;
    return;
  }
  const FoldedSignalFrames load{
      {signals + (size_t)b * Lp + (size_t)f0 * fshift, win, Lp - f0 * fshift,
       fshift, flen, pre_emph, preemph_first != 0},
      N};
  const int wstride = rfft::nop(OPL) * nchunk;
  float* wrows = wsums + ((size_t)b * T + f0) * wstride;
  const float* sums = rfft::tile_sums<N, OPL, true>(
      load, nf, smem, op, nmel, power_floor, nchunk, wrows, wstride);
  if (OPL == 64 && nchunk > 1)
    tile_features<OPL, NTH>(wrows, out, nf, nvalid - f0, dct, nmel, nac,
                            nceps, true, wstride, n_lpcc);
  else
    tile_features<OPL, NTH>(sums, out, nf, nvalid - f0, dct, nmel, nac,
                            nceps, true, 8 * OPL, n_lpcc);
}

// utterances a launch takes: the grid's y dimension
constexpr int MAX_GRID_Y = 65535;

// One launch per MAX_GRID_Y utterances (each utterance's tiles are the same
// blocks in any of them, so the bits do not depend on the split).
template <int N, int OPL>
cudaError_t launch(int B, cudaStream_t st, const float* sig, const int* nv,
                   const float* win, const float4* op, const float* dct,
                   float* feat, int Lp, int T, int flen, int fshift,
                   int nmel, int nac, int nceps, float pre_emph,
                   int preemph_first, float power_floor, int n_lpcc,
                   float* wsums) {
  const int smem = 4 * rfft::smem_floats(N, OPL);
  cudaError_t err = cudaFuncSetAttribute(
      full_signals_kernel<N, OPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const size_t nfeat = feature_width(nceps, nac, 1, n_lpcc);
  const int nchunk = rfft::out_chunks(nmel + nac);
  const size_t wstride = (size_t)rfft::nop(OPL) * nchunk;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const dim3 grid((T + rfft::ft(N) - 1) / rfft::ft(N),
                    min(MAX_GRID_Y, B - b0));
    full_signals_kernel<N, OPL><<<grid, rfft::nth(N), smem, st>>>(
        sig + (size_t)b0 * Lp, nv + b0, win, op, dct,
        feat + (size_t)b0 * T * nfeat, Lp, T, flen, fshift, nmel, nac, nceps,
        pre_emph, preemph_first, power_floor, n_lpcc, nchunk,
        nchunk > 1 ? wsums + (size_t)b0 * T * wstride : wsums);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// signals [B, Lp], n_valid [B], win [flen] (the window), op the packed
// [mel | acorr] operator of srt_fft_operator_shape (csrc/frontend_fft.cu),
// dct [nmel, nceps], wsums the srt_fft_wide_floats(B * T, nmel + nac)
// floats past 512 outputs; writes feat [B, T, nceps + nac - 1] (nceps
// without LPC), or with n_lpcc > 0 feat [B, T, nceps + n_lpcc - 1] (nac at
// most the tile's operator width), then CMVN of the cepstra when cmvn. Any
// B; frames of any length (folded past nfft).
extern "C" int srt_full_signals_frontend(
    const void* signals, const void* n_valid, const void* win,
    const void* op, const void* dct, void* feat, void* wsums, int B, int Lp,
    int T, int flen, int fshift, int nfft, int nmel, int nac, int nceps,
    float pre_emph, int preemph_first, float power_floor, int cmvn,
    int n_lpcc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int opl = rfft::pick_opl(nfft, nmel + nac, true);
  if (opl == 0 || B < 1 || T < 1 || flen > Lp ||
      (n_lpcc > 0 && nac > rfft::nop(opl)))
    return (int)cudaErrorInvalidValue;
  const auto* nv = (const int*)n_valid;
  const cudaError_t err = rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      return launch<decltype(nc)::value, decltype(oc)::value>(
          B, st, (const float*)signals, nv, (const float*)win,
          (const float4*)op, (const float*)dct, (float*)feat, Lp, T, flen,
          fshift, nmel, nac, nceps, pre_emph, preemph_first, power_floor,
          n_lpcc, (float*)wsums);
    });
  });
  if (err != cudaSuccess || !cmvn) return (int)err;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>(
      (float*)feat, nv, T, feature_width(nceps, nac, 1, n_lpcc), nceps);
  return (int)cudaGetLastError();
}
