// K1's LPC-cepstra mode from the signals, for Hopper (sm_90a), plain C
// interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:
// _run_packed_signals with fuse_lpc=False (the raw autocorrelation) and
// the JAX extractor's Levinson and LPC cepstra after it
// (speaker_recognition_tpu/features/extract.py:339-344), for an N-point
// FFT, N a power of two in [64, 16384] with 2 * flen <= N (ops/frontend.
// rfft_size). For frame f of utterance b,
//     x    = signals[b, f*fshift : f*fshift + flen]
//     y    = window and pre-emphasis of x (either order)
//     Y    = |FFT_N(y)|^2                   (bins 0..N/2, not floored)
//     ceps = log(max(Y . M, floor)) . dct           -> feat[b, f, :nceps]
//     r    = Y . R, then the n_lpcc - 1 LPC cepstra of Levinson(r) (the
//            recursion on the unzeroed coefficients), non-finite -> 0, and
//            0 where r[0] is below the least normal float
//                                                   -> feat[b, f, nceps:]
// then masked per-utterance CMVN of the cepstra over the first n_valid[b]
// frames (cmvn_kernel, a second kernel), and every frame at or past
// n_valid[b] is zero. M = H . mel and R are K1's bin-domain operators
// (ops/frontend.fft_packed_operators), the function csrc/frontend.cu's raw
// tile and lpcc_kernel computed in two kernels with the autocorrelation in
// device memory between them.
//
// The tile is csrc/signal_tile.cuh's (K5 from the signals): 16-frame
// tiles up to N = 4096; each frame gathered from the signal a float2 of
// samples a lane at a time (at 8 kHz the hop of 128 samples keeps every
// frame 8-byte aligned), the previous sample by a shuffle; the power rows
// written over the FFT buffers; the projection onto [M | R] as mma.sync
// m16n8k8 TF32 products in three terms (hi.hi + hi.lo + lo.hi) from the
// blocks gpu_frontend.signal_operator packs and splits once; the LPC
// cepstra up to order 15 and 16 cepstra (the default) all in registers
// (lpcc_short), past it in a local array (tile_features' lpcc_frames).
// What differs from K5's kernel: the power is not floored per bin
// (signal_sums<N, OPL, false>: K1 floors the mel sums only), no frame is
// longer than the FFT (the fold is never taken), the tail always takes the
// LPC cepstra and keeps their recursion in registers (K5's reads each c_n
// back from the output row in device memory and divides its factors at
// run time: 0.36 ms more of the kernel at 8 kHz, tools/fft_ablation.py
// --route lpcc), and below N = 2048 the launch bounds ask for four blocks
// an SM (the tile's shared memory, ~43 KB at N = 512, leaves the
// registers to set the blocks an SM).
//
// What bounds it on this card: the signals read once (84 MB for 512 x 5 s
// at 8 kHz: 0.025 ms at 3.35 TB/s) beside the FFT, DCT and the recursions
// on the FP32 pipes and the projection's three products on the TF32
// tensor cores (chip_smoke.py phase 22 prints the bound). The tile's
// latency sets the pace (by the ablation at 8 kHz the loads, FFT, DCT and
// writes ~0.48 ms of ~0.87, the projection ~0.30, the tail's recursions
// ~0.10), and the blocks an SM hide each other's.
// Built without --use_fast_math: isfinite() must survive and logf must be
// the accurate one.

#include <cuda_runtime.h>

#include "packed_tile.cuh"
#include "rfft_tile.cuh"
#include "signal_tile.cuh"

namespace {

// blocks an SM the launch bounds ask for: below N = 2048 SMALL_BLOCKS (at
// most 65536 / (256 * SMALL_BLOCKS) registers a thread: 4 blocks of 64
// registers, a few spills, were faster than 3 of 80 and 2 of 100 at 8 and
// 16 kHz, tools/fft_ablation.py --route lpcc), else the tile's (two at N =
// 2048, one past it)
constexpr int SMALL_BLOCKS = 4;
__host__ __device__ constexpr int min_blocks(int n) {
  return n < 2048 ? SMALL_BLOCKS : sigtile::min_blocks(n);
}

// The short tail's reach: LPC order and LPC cepstra up to SHORT (the
// default, LpcConfig's order 15 and 16 cepstra)
constexpr int SHORT = 15;

// The n_lpcc - 1 LPC cepstra of order p <= SHORT from the autocorrelation
// r [p + 1] (n_lpcc <= SHORT + 1), into o: sigtile::lpcc_in_registers'
// recursion operation for operation, with c_n in registers and every
// index known when it is compiled, so the factors (n - l) / (n + 1) are
// constants and no c_n is read back from the output row in device
// memory (the recursion's chain stays in registers). Not inlined: one
// copy serves every instance.
__device__ __noinline__ void lpcc_short(const float* r, float* o, int p,
                                        int n_lpcc) {
  float a[SHORT], c[SHORT];
  sigtile::levinson_registers<SHORT>(r, a, p);
#pragma unroll
  for (int n = 1; n <= SHORT; ++n) {
    const int m = min(n, p);
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < n; ++l) {
      if (l < m) {
        const float al = l == 0 ? 1.f : a[l - 1];
        const float cp = n - l - 1 == 0 ? 1.f : c[n - l - 2];
        s += al * cp * ((float)(n - l) / (float)(n + 1));
      }
    }
    c[n - 1] = n < p ? a[n - 1] + s : s;
  }
#pragma unroll
  for (int j = 0; j < SHORT; ++j)
    if (j + 1 < n_lpcc) o[j] = isfinite(c[j]) ? -c[j] : 0.f;
}

// The tile's features from its sums (rows of `stride` floats): the
// cepstra, then the LPC cepstra, zeros from frame nvalid on and where lag
// 0 is below the least normal float; within SHORT by lpcc_short, a frame a
// thread, past it by tile_features (lpcc_frames: the recursion in a local
// array). Not sigtile::features, K5's tail: its LPC and register-held
// paths, inlined into each of the 36 instances, kept nvcc on this file
// half as long again (205 s against 137 alone on the chip's host).
template <int OPL, int NTH>
__device__ __forceinline__ void lpcc_features(const float* sums,
                                              float* __restrict__ out,
                                              int nf, int nvalid,
                                              const float* __restrict__ dct,
                                              int nmel, int nac, int nceps,
                                              int stride, int n_lpcc) {
  if (nac < 2 || nac > SHORT + 1 || n_lpcc > SHORT + 1) {  // block-uniform
    tile_features<OPL, NTH>(sums, out, nf, nvalid, dct, nmel, nac, nceps,
                            true, stride, n_lpcc);
    return;
  }
  const int nfeat = nceps + n_lpcc - 1;
  for (int i = threadIdx.x; i < nf * nceps; i += NTH) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + (size_t)f * stride;
    float v = 0.f;
    for (int m = 0; m < nmel; ++m) v = fmaf(lm[m], dct[m * nceps + c], v);
    out[f * nfeat + c] = f < nvalid ? v : 0.f;
  }
  for (int f = threadIdx.x; f < nf; f += NTH) {
    float* o = out + f * nfeat + nceps;
    const float* r = sums + (size_t)f * stride + nmel;
    if (f < nvalid && r[0] >= FLT_MIN)
      lpcc_short(r, o, nac - 1, n_lpcc);
    else
      for (int j = 0; j + 1 < n_lpcc; ++j) o[j] = 0.f;
  }
}

// Block i takes tile i % tiles of utterance i / tiles (tiles an
// utterance's; sigtile::launch). Past 512 outputs (OPL 64, nchunk > 1) the
// tile's sums go to rows of wsums [B * T][wstride] and the tail reads them
// there.
template <int N, int OPL>
__global__ void __launch_bounds__(sigtile::nth(N), min_blocks(N))
    lpcc_signals_kernel(
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
  const int nfeat = nceps + n_lpcc - 1;
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
  const float* sums = sigtile::signal_sums<N, OPL, false>(
      load, nf, smem, op, nmel, nac, power_floor, nchunk, wrows, wstride);
  if (OPL == 64 && nchunk > 1)
    lpcc_features<OPL, NTH>(wrows, out, nf, nvalid - f0, dct, nmel, nac,
                            nceps, wstride, n_lpcc);
  else
    lpcc_features<OPL, NTH>(sums, out, nf, nvalid - f0, dct, nmel, nac,
                            nceps, 8 * OPL, n_lpcc);
}

}  // namespace

// lpcc_signals_kernel<nfft, OPL of nout> on this card: out[0] blocks an SM
// (the occupancy API, at the launch's threads and shared memory), out[1]
// registers and out[2] local bytes a thread, out[3] bytes of dynamic
// shared memory.
extern "C" int srt_lpcc_signals_occupancy(int nfft, int nout, int* out) {
  const int opl = sigtile::pick_opl(nfft, nout);
  if (opl == 0) return (int)cudaErrorInvalidValue;
  return (int)rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      constexpr int N = decltype(nc)::value, OPL = decltype(oc)::value;
      return sigtile::occupancy<N, OPL>(lpcc_signals_kernel<N, OPL>, out);
    });
  });
}

// signals [B, Lp], n_valid [B], win [flen] (the window), op K1's [M | R]
// packed as csrc/frontend_full_signals.cu's srt_full_signals_operator_shape
// gives it (gpu_frontend.signal_operator), dct [nmel, nceps], wsums the
// srt_fft_wide_floats(B * T, nmel + nac) floats past 512 outputs; writes
// feat [B, T, nceps + n_lpcc - 1] (n_lpcc >= 1; 1 <= nac <= the tile's
// operator width, at most 512 lags), then CMVN of the cepstra when cmvn.
// Any B; 2 * flen <= nfft.
extern "C" int srt_lpcc_signals_frontend(
    const void* signals, const void* n_valid, const void* win,
    const void* op, const void* dct, void* feat, void* wsums, int B, int Lp,
    int T, int flen, int fshift, int nfft, int nmel, int nac, int nceps,
    float pre_emph, int preemph_first, float power_floor, int cmvn,
    int n_lpcc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int opl = sigtile::pick_opl(nfft, nmel + nac);
  if (opl == 0 || B < 1 || T < 1 || flen > Lp || 2 * flen > nfft ||
      n_lpcc < 1 || nac < 1 || nac > rfft::nop(opl))
    return (int)cudaErrorInvalidValue;
  const auto* nv = (const int*)n_valid;
  const cudaError_t err = rfft::with_n(nfft, [&](auto nc) {
    return rfft::with_opl(opl, [&](auto oc) {
      constexpr int N = decltype(nc)::value, OPL = decltype(oc)::value;
      return sigtile::launch<N, OPL>(
          lpcc_signals_kernel<N, OPL>, B, st, (const float*)signals, nv,
          (const float*)win, (const float4*)op, (const float*)dct,
          (float*)feat, Lp, T, flen, fshift, nmel, nac, nceps, pre_emph,
          preemph_first, power_floor, n_lpcc, (float*)wsums);
    });
  });
  if (err != cudaSuccess || !cmvn) return (int)err;
  cmvn_kernel<<<B, dim3(32, CG), 0, st>>>((float*)feat, nv, T,
                                          nceps + n_lpcc - 1, nceps);
  return (int)cudaGetLastError();
}
