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
// read back, then ~20 launches of torch for the tail. Here the tile
// (csrc/signal_tile.cuh) loads each frame as a strided window of the
// signal, a float2 of samples a lane at a time, windowed and pre-emphasized
// per sample, plus the fold of samples past N taken from the signal; its
// power floor is K5's, per bin, not K1's (mel sums only), so the two
// kernels compute different functions; it projects the power rows onto
// mel and autocorrelation on the tensor cores (3 x TF32); its tail
// computes what K1's does (tile_features, csrc/packed_tile.cuh, with the
// LPC cepstra mode), below order 32 with the recursions' coefficients in
// registers, and a tile wholly past n_valid writes zeros only.
//
// What bounds it on this card: the signals, read once (492 MB at 48 kHz
// for 512 x 5 s: 0.147 ms at 3.35 TB/s), beside the FFT and Levinson on
// the FP32 pipes and the projection's three products on the TF32 tensor
// cores (chip_smoke.py prints the bound). The tile's latency
// sets the pace; 16-frame tiles, power rows over the FFT buffers and no
// prefetch registers give two blocks an SM at N = 2048 (signal_tile.cuh).
// Built without --use_fast_math: isfinite() must survive and logf must be
// the accurate one.

#include <cuda_runtime.h>

#include "packed_tile.cuh"
#include "rfft_tile.cuh"
#include "signal_tile.cuh"

namespace {

// Block i takes tile i % tiles of utterance i / tiles (tiles an
// utterance's; sigtile::launch). Past 512 outputs (OPL 64, nchunk > 1) the
// tile's sums go to rows of wsums [B * T][wstride] and the tail reads them
// there.
template <int N, int OPL>
__global__ void __launch_bounds__(sigtile::nth(N), sigtile::min_blocks(N))
    full_signals_kernel(
    const float* __restrict__ signals, const int* __restrict__ n_valid,
    const float* __restrict__ win, const float4* __restrict__ op,
    const float* __restrict__ dct, float* __restrict__ feat, int Lp, int T,
    int flen, int fshift, int nmel, int nac, int nceps, float pre_emph,
    int preemph_first, float power_floor, int n_lpcc, int nchunk,
    float* __restrict__ wsums) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int FT = sigtile::ft(N), NTH = sigtile::nth(N);
  const int tiles = (T + FT - 1) / FT;
  const int b = blockIdx.x / tiles, f0 = blockIdx.x % tiles * FT;
  const int nf = min(FT, T - f0);
  const int nfeat = feature_width(nceps, nac, 1, n_lpcc);
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
  const float* sums = sigtile::signal_sums<N, OPL>(
      load, nf, smem, op, nmel, nac, power_floor, nchunk, wrows, wstride);
  if (OPL == 64 && nchunk > 1)
    sigtile::features<OPL, NTH>(wrows, out, nf, nvalid - f0, dct, nmel, nac,
                                nceps, wstride, n_lpcc);
  else
    sigtile::features<OPL, NTH>(sums, out, nf, nvalid - f0, dct, nmel, nac,
                                nceps, 8 * OPL, n_lpcc);
}

}  // namespace

// Shape of the packed operator of an nfft-point FFT and nout = nmel + nac
// outputs (gpu_frontend.signal_operator builds it): the tile's OPL (8 OPL
// columns an output chunk), its column groups, output chunks and the
// warps that split a group's k-steps; -1 when nfft is not a power of two
// in [64, 16384].
extern "C" int srt_full_signals_operator_shape(int nfft, int nout, int* opl,
                                               int* groups, int* chunks,
                                               int* ksplit) {
  const int o = sigtile::pick_opl(nfft, nout);
  if (o == 0) return -1;
  *opl = o;
  *groups = sigtile::groups(o);
  *chunks = rfft::out_chunks(nout);
  *ksplit = sigtile::ksplit(nfft, o);
  return 0;
}

// full_signals_kernel<nfft, OPL of nout> on this card: out[0] blocks an SM
// (the occupancy API, at the launch's threads and shared memory), out[1]
// registers and out[2] local bytes a thread, out[3] bytes of dynamic
// shared memory.
extern "C" int srt_full_signals_occupancy(int nfft, int nout, int* out) {
  const int opl = sigtile::pick_opl(nfft, nout);
  if (opl == 0) return (int)cudaErrorInvalidValue;
  return (int)rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      constexpr int N = decltype(nc)::value, OPL = decltype(oc)::value;
      return sigtile::occupancy<N, OPL>(full_signals_kernel<N, OPL>, out);
    });
  });
}

// signals [B, Lp], n_valid [B], win [flen] (the window), op the packed
// operator of srt_full_signals_operator_shape,
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
  const int opl = sigtile::pick_opl(nfft, nmel + nac);
  if (opl == 0 || B < 1 || T < 1 || flen > Lp ||
      (n_lpcc > 0 && nac > rfft::nop(opl)))
    return (int)cudaErrorInvalidValue;
  const auto* nv = (const int*)n_valid;
  const cudaError_t err = rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      constexpr int N = decltype(nc)::value, OPL = decltype(oc)::value;
      return sigtile::launch<N, OPL>(
          full_signals_kernel<N, OPL>, B, st, (const float*)signals, nv,
          (const float*)win, (const float4*)op, (const float*)dct,
          (float*)feat, Lp, T, flen, fshift, nmel, nac, nceps, pre_emph,
          preemph_first, power_floor, n_lpcc, (float*)wsums);
    });
  });
  if (err != cudaSuccess || !cmvn) return (int)err;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>(
      (float*)feat, nv, T, feature_width(nceps, nac, 1, n_lpcc), nceps);
  return (int)cudaGetLastError();
}
