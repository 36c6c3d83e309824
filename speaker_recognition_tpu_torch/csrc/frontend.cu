// Packed MFCC + LPC frontend for Hopper (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run_packed_signals
// (the signal-level fused frontend): for frame f of utterance b,
//     x  = signals[b, f*fshift : f*fshift + flen]
//     y  = window and pre-emphasis of x
//     Y  = |FFT_N(y)|^2             (bins 0..N/2)
//     ceps = log(max(Y . M, floor)) . dct        -> feat[b, f, :nceps]
//     r  = Y . R,  lpc = Levinson(r), non-finite -> 0
//                                                -> feat[b, f, nceps:]
// (or, without fuse_lpc, the raw autocorrelation r itself there: the JAX
// kernel's fuse_lpc=False, which the bf16 route's LPC cepstra take), then
// masked per-utterance CMVN of the cepstra over the first n_valid[b]
// frames (cmvn_kernel), and every frame at or past n_valid[b] is zero.
// The LPC-cepstra mode (n_lpcc > 0) is csrc/frontend_lpcc_signals.cu's
// kernel below N = 32768; from N = 32768 on srt_big_packed_frontend runs
// the raw mode, then lpcc_kernel (tile_features' LPC-cepstra tail).
//
// What bounds it on this card, and what the design does about it: see
// csrc/rfft_tile.cuh. The TPU kernel ran the window, the pre-emphasis and
// a 2*flen-point DFT as one dense product frames . D (262 kFLOP a frame at
// 8 kHz, D 512 KB); here an N-point real FFT (N the least power of two
// >= 2*flen: 512 at 8 kHz, 2048 at 22.05 kHz, 4096 at 44.1 and 48 kHz
// with fft_size 4096, 8192 at 96 kHz and 16384 at 192 kHz with fft_size
// >= 2*flen) of the windowed,
// pre-emphasized frame gives the power of bins 0..N/2, and the bin-domain
// operators M = H . mel (H: the exact map from the N-point to the
// fft_size-point power spectrum, ops/frontend.halfspec_to_fullspec) and
// the biased autocorrelation R fold it into the sums. Per tile of
// rfft::ft(N) frames (32, or 16, 4, 2 at N = 4096, 8192, 16384) of one
// utterance:
//   * sample p of frame f is the strided window signal[f*fshift + p] (no
//     frame matrix, no roll), windowed and pre-emphasized in f32 as it is
//     gathered, in either order of ops/frontend.windowed_preemph_operator:
//       default:        y[p] = w[p] x[p] - a (w[p-1] x[p-1]),  y[0] = w[0] x[0]
//       preemph_first:  y[p] = w[p] (x[p] - a x[p-1]),  y[0] = w[0] (1-a) x[0]
//   * tiles that lie wholly past n_valid only write zeros;
//   * log/DCT and the order-p Levinson run per frame at the end of the
//     block, one thread per frame with the recursion in local memory, of
//     any order the tile's outputs admit (tile_features of
//     csrc/packed_tile.cuh, which the fused predict monolith and the
//     full-spectrum frontend from the signals share); CMVN takes any
//     number of cepstra, 32 at a time.
// The batch has no limit: the wrapper's launch walks it in runs of 65535
// utterances (the grid's y dimension).
// Built without --use_fast_math: isfinite() must survive and logf must be
// the accurate one (an all-zero frame gives r = 0 -> 0/0 -> LPC 0).

#include <cuda_runtime.h>

#include <algorithm>

#include "big_signal.cuh"
#include "packed_tile.cuh"
#include "rfft_big.cuh"
#include "rfft_tile.cuh"

namespace {

// Past 512 outputs (OPL 64, nchunk > 1) the tile's sums go to rows of
// wsums [B * T][wstride] and tile_features reads them there.
template <int N, int OPL>
__global__ void __launch_bounds__(rfft::nth(N)) packed_frontend_kernel(
    const float* __restrict__ signals, const int* __restrict__ n_valid,
    const float* __restrict__ win, const float4* __restrict__ op,
    const float* __restrict__ dct,
    float* __restrict__ feat, int Lp, int T, int flen, int fshift, int nmel,
    int nac, int nceps, float pre_emph, int preemph_first,
    float power_floor, int fuse_lpc, int nchunk, float* __restrict__ wsums) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  constexpr int FT = rfft::ft(N), NTH = rfft::nth(N);
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, T - f0);
  const int nfeat = feature_width(nceps, nac, fuse_lpc);
  const int nvalid = n_valid[b];
  float* out = feat + ((size_t)b * T + f0) * nfeat;

  if (f0 >= nvalid) {  // block-uniform: the whole tile is padding
    for (int i = threadIdx.x; i < nf * nfeat; i += NTH) out[i] = 0.f;
    return;
  }
  const rfft::SignalFrames load{
      signals + (size_t)b * Lp + (size_t)f0 * fshift, win, Lp - f0 * fshift,
      fshift, flen, pre_emph, preemph_first != 0};
  const int wstride = rfft::nop(OPL) * nchunk;
  float* wrows = wsums + ((size_t)b * T + f0) * wstride;
  const float* sums = rfft::tile_sums<N, OPL, false>(
      load, nf, smem, op, nmel, power_floor, nchunk, wrows, wstride);
  if (OPL == 64 && nchunk > 1)
    tile_features<OPL, NTH>(wrows, out, nf, nvalid - f0, dct, nmel, nac,
                            nceps, fuse_lpc != 0, wstride);
  else
    tile_features<OPL, NTH>(sums, out, nf, nvalid - f0, dct, nmel, nac,
                            nceps, fuse_lpc != 0);
}

// autocorrelation lags the LPC cepstra take (ops/gpu_frontend.
// LPCC_MAX_LAGS): lpcc_kernel's local coefficients
constexpr int MAX_LAGS = 512;

// K1's LPC-cepstra mode on the four-step route (N >= 32768), after its
// raw-autocorrelation pass: rows raw [n][nceps + nac] (cepstra | raw
// autocorrelation) -> feat [n][nceps + n_lpcc - 1] (the cepstra, then
// tile_features' LPC-cepstra tail, lpcc_frames), a thread a frame of the
// batch's n = B * T. Below N = 32768 the mode is one kernel from the
// signals (csrc/frontend_lpcc_signals.cu).
__global__ void __launch_bounds__(128) lpcc_kernel(
    const float* __restrict__ raw, const int* __restrict__ n_valid,
    float* __restrict__ feat, long long n, int T, int nceps, int nac,
    int n_lpcc) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int stride = nceps + nac, nfeat = nceps + n_lpcc - 1;
  const float* row = raw + g * stride;
  float* out = feat + g * nfeat;
  for (int c = 0; c < nceps; ++c) out[c] = row[c];
  lpcc_frames<MAX_LAGS>(row, out, 1, n_valid[g / T] - (int)(g % T), nceps,
                        nac - 1, nceps, nfeat, stride, n_lpcc, 0, 1);
}

// lpcc_kernel over the batch's B * T rows, then CMVN when cmvn: the end of
// the four-step route's LPC-cepstra mode.
cudaError_t lpcc_tail(const float* raw, const int* nv, float* feat, int B,
                      int T, int nceps, int nac, int n_lpcc, int cmvn,
                      cudaStream_t st) {
  const long long n = (long long)B * T;
  lpcc_kernel<<<(unsigned)((n + 127) / 128), 128, 0, st>>>(
      raw, nv, feat, n, T, nceps, nac, n_lpcc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !cmvn) return err;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>(feat, nv, T, nceps + n_lpcc - 1,
                                          nceps);
  return cudaGetLastError();
}

// utterances a launch takes: the grid's y dimension
constexpr int MAX_GRID_Y = 65535;

// One launch per MAX_GRID_Y utterances (each utterance's tiles are the same
// blocks in any of them, so the bits do not depend on the split).
template <int N, int OPL>
cudaError_t launch(int B, cudaStream_t st, const float* sig,
                   const int* nv, const float* win, const float4* op,
                   const float* dct, float* feat, int Lp,
                   int T, int flen, int fshift, int nmel, int nac, int nceps,
                   float pre_emph, int preemph_first, float power_floor,
                   int fuse_lpc, float* wsums) {
  const int smem = 4 * rfft::smem_floats(N, OPL);
  cudaError_t err = cudaFuncSetAttribute(
      packed_frontend_kernel<N, OPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const size_t nfeat = feature_width(nceps, nac, fuse_lpc);
  const int nchunk = rfft::out_chunks(nmel + nac);
  const size_t wstride = (size_t)rfft::nop(OPL) * nchunk;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const dim3 grid((T + rfft::ft(N) - 1) / rfft::ft(N),
                    min(MAX_GRID_Y, B - b0));
    packed_frontend_kernel<N, OPL><<<grid, rfft::nth(N), smem, st>>>(
        sig + (size_t)b0 * Lp, nv + b0, win, op, dct,
        feat + (size_t)b0 * T * nfeat, Lp, T, flen, fshift, nmel, nac, nceps,
        pre_emph, preemph_first, power_floor, fuse_lpc, nchunk,
        nchunk > 1 ? wsums + (size_t)b0 * T * wstride : wsums);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// signals [B, Lp], n_valid [B], win [flen] (the window), op the packed
// [M | R] operator of srt_fft_operator_shape (csrc/frontend_fft.cu: the
// bin-domain mel and autocorrelation operators), dct [nmel, nceps], wsums
// the srt_fft_wide_floats(B * T, nmel + nac) floats past 512 outputs;
// writes feat [B, T, nceps + nac - 1] (nceps without LPC), or with
// fuse_lpc 0 feat [B, T, nceps + nac] (cepstra | raw autocorrelation),
// then CMVN of the cepstra when cmvn. Any B.
extern "C" int srt_packed_frontend(
    const void* signals, const void* n_valid, const void* win,
    const void* op, const void* dct, void* feat, void* wsums, int B, int Lp,
    int T, int flen, int fshift, int nfft, int nmel, int nac, int nceps,
    float pre_emph, int preemph_first, float power_floor, int cmvn,
    int fuse_lpc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int opl = rfft::pick_opl(nfft, nmel + nac, true);
  if (opl == 0 || 2 * flen > nfft) return (int)cudaErrorInvalidValue;
  const cudaError_t err = rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      return launch<decltype(nc)::value, decltype(oc)::value>(
          B, st, (const float*)signals, (const int*)n_valid,
          (const float*)win, (const float4*)op, (const float*)dct,
          (float*)feat, Lp, T, flen, fshift, nmel, nac, nceps, pre_emph,
          preemph_first, power_floor, fuse_lpc, (float*)wsums);
    });
  });
  if (err != cudaSuccess || !cmvn) return (int)err;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>(
      (float*)feat, (const int*)n_valid, T,
      feature_width(nceps, nac, fuse_lpc), nceps);
  return (int)cudaGetLastError();
}

// K1 at an nfft-point FFT, nfft a power of two >= 32768 (csrc/rfft_big.cuh):
// the arguments of srt_packed_frontend, with the packed operator of
// srt_big_operator_shape in place of the tile's and scratch of
// srt_big_scratch_floats(nfft, nmel + nac, chunk) (both csrc/
// frontend_big.cu) for chunks of `chunk` frames of the batch; with
// n_lpcc > 0 (and fuse_lpc) feat [B, T, nceps + n_lpcc - 1] (cepstra | LPC
// cepstra; nac <= MAX_LAGS) through raw [B, T, nceps + nac].
extern "C" int srt_big_packed_frontend(
    const void* signals, const void* n_valid, const void* win,
    const void* op, const void* dct, void* feat,
    void* scratch, int B, int Lp, int T, int flen, int fshift, int nfft,
    int nmel, int nac, int nceps, float pre_emph, int preemph_first,
    float power_floor, int cmvn, int fuse_lpc, int n_lpcc, void* raw,
    int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * T;
  const bool lpcc = n_lpcc > 0;
  if (!rfft_big::takes(nfft) || 2 * flen > nfft || chunk < 1 ||
      chunk > 65535 || n < 1 || n > 0x7fffffffLL ||
      (lpcc && (!fuse_lpc || nac < 1 || nac > MAX_LAGS || !raw)))
    return (int)cudaErrorInvalidValue;
  const auto* nv = (const int*)n_valid;
  const srt_cluster::FrameSource fr =
      signal_frames((const float*)signals, nv, (const float*)win, Lp, T,
                    fshift, flen, pre_emph, preemph_first);
  float* sc = (float*)scratch;
  for (int g0 = 0; g0 < (int)n; g0 += chunk) {
    const int nfc = (int)std::min<long long>(chunk, n - g0);
    cudaError_t err = srt_cluster::spectra(fr, g0, nfc, nfft, sc,
                                           (const float4*)op, nmel, nac,
                                           power_floor, false, st);
    if (err != cudaSuccess) return (int)err;
    big_features_kernel<<<nfc, 128, 0, st>>>(
        rfft_big::sums_rows(sc, nfft, nfc), nv, (const float*)dct,
        (float*)(lpcc ? raw : feat), T, g0, nmel, nac, nceps,
        lpcc ? 0 : fuse_lpc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (lpcc)
    return (int)lpcc_tail((const float*)raw, nv, (float*)feat, B, T, nceps,
                          nac, n_lpcc, cmvn, st);
  if (!cmvn) return 0;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>(
      (float*)feat, nv, T, feature_width(nceps, nac, fuse_lpc), nceps);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
