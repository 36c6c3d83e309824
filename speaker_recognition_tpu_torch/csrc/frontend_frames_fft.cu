// Frame-level packed MFCC frontend on an FFT, for Hopper (sm_90a), plain C
// interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run_packed
// (packed_from_frames): for raw frames x [n, flen],
//     X = x . D,  Y = X^2            (D: window, pre-emphasis, half-spectrum
//                                      DFT of 2*flen points)
//     ceps = log(max(Y . W, floor)) . dct,   r = Y . A
// writing pre-CMVN cepstra [n, nceps] and the RAW autocorrelation [n, nac]
// (nac = 0 for an MFCC-only config). The floor applies to mel only.
//
// What bounds it on this card: FLOPs of the bin-domain mel operator at
// 8 kHz, as in the signal frontend (csrc/frontend.cu), plus the frames,
// read once (1 KB each at 8 kHz). The TPU kernel's dense product x . D
// (262 kFLOP a frame at 8 kHz) has a real FFT in its place: the same
// function as the signal frontend's, per frame of a frame matrix instead
// of a strided window of a signal. The tile (csrc/rfft_tile.cuh) gathers
// each raw frame row, windows and pre-emphasizes it per sample in either
// order of ops/frontend.windowed_preemph_operator, takes the power of bins
// 0..N/2 of its N-point FFT (N = ops/frontend.rfft_size(flen) >= 2*flen,
// so the power determines the 2*flen-point spectrum and the
// autocorrelation without aliasing), and folds it into the bin-domain
// operators M and R of ops/frontend.fft_packed_operators. No spectrum
// reaches device memory; every sum runs in a fixed order.
// Built without --use_fast_math, for the accurate logf.

#include <cuda_runtime.h>

#include "rfft_big.cuh"
#include "rfft_tile.cuh"

namespace {

// Sample p < N of the tile's frame f: the windowed, pre-emphasized raw
// frame row, zero past flen. Straight-line code: selects, no branches, so
// a lane's loads for a whole frame fly together.
struct WindowedRows {
  const float* fr;   // the tile's first frame
  const float* win;  // [flen]
  int flen;
  float a;
  bool preemph_first;
  __device__ __forceinline__ float operator()(int f, int p) const {
    const float* row = fr + (size_t)f * flen;
    const bool in = p < flen, prev = in && p > 0;
    const float x = in ? row[p] : 0.f;
    const float xm = prev ? row[p - 1] : 0.f;
    const float w = in ? win[p] : 0.f;
    const float wm = prev ? win[p - 1] : 0.f;
    const float first = w * (p > 0 ? x - a * xm : (1.f - a) * x);
    const float later = w * x - a * (wm * xm);
    return preemph_first ? first : later;
  }
  template <int RP, class First>
  __device__ __forceinline__ void fold(int, float2 (&)[RP], First) const {}
};

// Past 512 outputs (OPL 64, nchunk > 1) the tile's sums go to rows of
// wsums [n][wstride] and the epilogue reads them there.
template <int N, int OPL>
__global__ void __launch_bounds__(rfft::nth(N)) fft_packed_frames_kernel(
    const float* __restrict__ frames, const float* __restrict__ win,
    const float4* __restrict__ op, const float* __restrict__ dct,
    float* __restrict__ ceps, float* __restrict__ r, int n, int flen,
    int nmel, int nac, int nceps, float pre_emph, int preemph_first,
    float power_floor, int nchunk, float* __restrict__ wsums) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int f0 = blockIdx.x * rfft::ft(N);
  const int nf = min(rfft::ft(N), n - f0);
  const WindowedRows load{frames + (size_t)f0 * flen, win, flen, pre_emph,
                          preemph_first != 0};
  constexpr int NOP = rfft::nop(OPL);
  const int wstride = NOP * nchunk;
  float* wrows = wsums + (size_t)f0 * wstride;
  const float* sums = rfft::tile_sums<N, OPL, false>(
      load, nf, smem, op, nmel, power_floor, nchunk, wrows, wstride);
  if (OPL == 64 && nchunk > 1)
    rfft::frame_outputs<NOP, rfft::nth(N)>(wrows, dct, ceps, r, f0, nf, nmel,
                                           nac, nceps, wstride);
  else
    rfft::frame_outputs<NOP, rfft::nth(N)>(sums, dct, ceps, r, f0, nf, nmel,
                                           nac, nceps);
}

template <int N, int OPL>
cudaError_t launch(cudaStream_t st, const float* frames, const float* win,
                   const float4* op, const float* dct, float* ceps, float* r,
                   int n, int flen, int nmel, int nac, int nceps,
                   float pre_emph, int preemph_first, float power_floor,
                   float* wsums) {
  const int smem = 4 * rfft::smem_floats(N, OPL);
  cudaError_t err = cudaFuncSetAttribute(
      fft_packed_frames_kernel<N, OPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fft_packed_frames_kernel<N, OPL>
      <<<(n + rfft::ft(N) - 1) / rfft::ft(N), rfft::nth(N), smem, st>>>(
          frames, win, op, dct, ceps, r, n, flen, nmel, nac, nceps, pre_emph,
          preemph_first, power_floor, rfft::out_chunks(nmel + nac), wsums);
  return cudaGetLastError();
}

}  // namespace

// frames [n, flen] raw; win [flen] the window; op the packed [M | R]
// operator of srt_fft_operator_shape (csrc/frontend_fft.cu) at nfft >=
// 2*flen; dct [nmel, nceps]; wsums the srt_fft_wide_floats(n, nmel + nac)
// floats past 512 outputs; writes ceps [n, nceps] and r [n, nac].
extern "C" int srt_fft_packed_frames(
    const void* frames, const void* win, const void* op, const void* dct,
    void* ceps, void* r, void* wsums, int n, int flen, int nfft, int nmel,
    int nac, int nceps, float pre_emph, int preemph_first, float power_floor,
    void* stream) {
  const int opl = rfft::pick_opl(nfft, nmel + nac, true);
  if (n < 1 || opl == 0 || 2 * flen > nfft) return (int)cudaErrorInvalidValue;
  return (int)rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      return launch<decltype(nc)::value, decltype(oc)::value>(
          (cudaStream_t)stream, (const float*)frames, (const float*)win,
          (const float4*)op, (const float*)dct, (float*)ceps, (float*)r, n,
          flen, nmel, nac, nceps, pre_emph, preemph_first, power_floor,
          (float*)wsums);
    });
  });
}

// K4 at an nfft-point FFT, nfft a power of two >= 32768 (csrc/rfft_big.cuh):
// frames [n, flen] raw, win [flen], op the packed [mel | acorr] operator
// of srt_big_operator_shape (csrc/frontend_big.cu), dct [nmel, nceps],
// scratch of srt_big_scratch_floats(nfft, nmel + nac, chunk); writes ceps
// [n, nceps] and r [n, nac].
extern "C" int srt_big_packed_frames(
    const void* frames, const void* win, const void* op, const void* dct,
    void* ceps, void* r, void* scratch, int n, int flen, int nfft, int nmel,
    int nac, int nceps, float pre_emph, int preemph_first, float power_floor,
    int chunk, void* stream) {
  if (n < 1 || 2 * flen > nfft) return (int)cudaErrorInvalidValue;
  // raw row f, windowed and pre-emphasized per sample as on the tile
  srt_cluster::FrameSource fr{};
  fr.kind = srt_cluster::FrameSource::WINDOWED;
  fr.x = (const float*)frames;
  fr.win = (const float*)win;
  fr.flen = flen;
  fr.a = pre_emph;
  fr.preemph_first = preemph_first;
  return (int)rfft_big::frame_level(
      fr, n, chunk, nfft, (float*)scratch, (const float4*)op,
      (const float*)dct, (float*)ceps, (float*)r, nmel, nac, nceps,
      power_floor, false, (cudaStream_t)stream);
}
