// Dense full-spectrum MFCC frontend for Hopper (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run
// (mfcc_from_frames) at an fft_size that is not a power of two, where the
// FFT kernel (csrc/frontend_fft.cu) does not serve:
//     re = wp . C,  im = wp . S      (C, S: [flen, nb], nb = fft/2 + 1)
//     power = max(re^2 + im^2, floor)     (per bin, before mel)
//     ceps = log(max(power . mel, floor)) . dct,  r = power . acorr
// for windowed, pre-emphasized frames wp [n, flen]. It writes pre-CMVN
// cepstra [n, nceps] and the RAW autocorrelation [n, nac] (nac = 0 for an
// MFCC-only config): the LPC cepstra run a Levinson recursion on it
// outside the kernel.
//
// What bounds it on this card: the DFT products, 2*flen*ncols FLOPs per
// frame and matrix (6.3 MFLOP per frame for the full spectrum at 48 kHz:
// flen 1536, nb 1025), against 4*flen bytes of frame: compute-bound on
// FP32 CUDA cores (no TF32: the features feed a log and a Levinson
// recursion that amplify rounding). C and S are 12.6 MB at 48 kHz and a
// 64-frame tile of 1536 samples is 384 KB, so neither fits a block's
// shared memory and nothing can be staged whole.
//
// What the design does about it:
//   * a block owns FT = 64 frames and walks the DFT columns in chunks of
//     CC;
//   * for each chunk it streams K-slices of KT samples of the frame tile
//     and of C and S through two shared-memory stage buffers, filled by
//     asynchronous copies (cp.async, zero-filled past the edges; 16 bytes
//     where rows are 16-byte aligned, else 4), so slice s + 1 is in flight
//     while slice s is multiplied. That staging, not the FMA loop, bounds
//     the kernel: each 64-frame block reads all of C and S from L2 (see
//     PERF.md);
//   * a lane holds FT/8 frames x 4 columns of re and im in registers, with
//     16-byte broadcast loads of 4 samples and 16-byte operator loads, 16
//     FMAs per load, over a fully unrolled slice;
//   * a narrow chunk (at most 4 columns: the one-bin tail of fft/2 + 1
//     bins) puts the slice's samples on the lanes instead of the columns
//     and sums the lanes with shuffles, so it costs a few percent of a full
//     chunk, not a full one;
//   * it forms re^2 + im^2 with the per-bin floor and sums the chunk's
//     power onto the nmel + nac outputs in f32 registers (a lane: FT/32
//     frames x OPL outputs), in order over the chunk's at most CC bins,
//     then adds that partial to the output's running sum over the chunks,
//     held in float64, so re, im and the power spectrum never reach device
//     memory. One f32 running sum over all bins drifted by percents at
//     fft_size 16777218 (8.4M bins: each term a few ulps of the sum, and
//     every add rounded the same way); a sum of CC terms in f32 and a
//     float64 sum across chunks keep the error near f32 rounding at any
//     column count;
//   * log and DCT run per frame at the end of the block.
// Any frame length is taken (K-slices are zero-padded: 1411 samples at
// 44.1 kHz), any column count (FullFrontend pads its bins to a multiple of
// 4 for the 16-byte copies), and any number of mel + autocorrelation
// outputs. Up to 192 (OPL 9, 16 or 24 a lane) the sums stay in registers
// from the first column chunk to the last. Past 192 the projection loops
// over output chunks of 192 inside each column chunk, and each chunk's
// sums live between column chunks in the block's rows of a global
// scratch of doubles [blocks * FT, chunks * 192] (L2-resident: a lane
// reloads and stores its own entries, the same sums as in registers); the
// last column chunk writes the log-mel rows there and the DCT reads them.
// The
// DFT runs once whatever the count; at most 192 outputs take no scratch
// and their arithmetic is unchanged.
// Built without --use_fast_math, for the accurate logf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CC = 128;       // DFT columns per chunk
constexpr int YS = CC + 1;    // padded row stride of the squared tile
constexpr int KT = 32;        // frame samples per staged K-slice
constexpr int NT = 256;       // threads per block: 8 warps
constexpr int FT = 64;        // frames per block
constexpr int MAX_SMEM = 232448;

// floats of one stage buffer: frames [FT][KT], then C and S [KT][CC]
constexpr int SF = FT * KT + 2 * KT * CC;

__host__ __device__ constexpr int smem_floats(int opl) {
  return 2 * SF + FT * YS + CC * 8 * opl;
}

__device__ __forceinline__ void fma4(float (&x)[4], float a, float4 b) {
  x[0] = fmaf(a, b.x, x[0]);
  x[1] = fmaf(a, b.y, x[1]);
  x[2] = fmaf(a, b.z, x[2]);
  x[3] = fmaf(a, b.w, x[3]);
}

// 4-byte asynchronous copy to shared memory; zero-fills when !ok (src is
// then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 16-byte asynchronous copy (both addresses 16-byte aligned), zero-filled
// when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of K-slice k0 of the frame tile and of the operators'
// chunk c0 into one stage buffer: frames [FT][KT], then C and S as
// [KT][CC], or, for a narrow chunk (cw <= 4 columns), as [4][KT]. Rows
// that are 16-byte aligned (flen, resp. ncols, a multiple of 4: vf, vo)
// are copied 16 bytes at a time; quads are then wholly in or out.
__device__ __forceinline__ void stage_slice(
    float* buf, const float* fr, const float* C, const float* S, int nf,
    int flen, int ncols, int k0, int c0, int cw, bool narrow, bool vf,
    bool vo, int tid) {
  if (vf) {
    for (int i = tid; i < FT * KT / 4; i += NT) {
      const int f = i / (KT / 4), kk = i % (KT / 4) * 4;
      const bool ok = f < nf && k0 + kk < flen;
      cp_async16(buf + f * KT + kk,
                 ok ? fr + (size_t)f * flen + k0 + kk : fr, ok);
    }
  } else {
    for (int i = tid; i < FT * KT; i += NT) {
      const int f = i / KT, kk = i % KT;
      const bool ok = f < nf && k0 + kk < flen;
      cp_async4(buf + i, ok ? fr + (size_t)f * flen + k0 + kk : fr, ok);
    }
  }
  float* ct = buf + FT * KT;
  float* st = ct + KT * CC;
  if (vo && !narrow) {
    for (int i = tid; i < KT * CC / 4; i += NT) {
      const int kk = i / (CC / 4), cc = i % (CC / 4) * 4;
      const bool ok = k0 + kk < flen && cc < cw;
      const size_t at = ok ? (size_t)(k0 + kk) * ncols + c0 + cc : 0;
      cp_async16(ct + kk * CC + cc, C + at, ok);
      cp_async16(st + kk * CC + cc, S + at, ok);
    }
    return;
  }
  const int n = narrow ? 4 * KT : KT * CC;
  for (int i = tid; i < n; i += NT) {
    const int kk = narrow ? i % KT : i / CC, cc = narrow ? i / KT : i % CC;
    const bool ok = k0 + kk < flen && cc < cw;
    const size_t at = ok ? (size_t)(k0 + kk) * ncols + c0 + cc : 0;
    cp_async4(ct + i, C + at, ok);
    cp_async4(st + i, S + at, ok);
  }
}

template <int OPL>
__global__ void __launch_bounds__(NT, 1) frames_frontend_kernel(
    const float* __restrict__ frames, const float* __restrict__ C,
    const float* __restrict__ S, const float* __restrict__ W,
    const float* __restrict__ A, const float* __restrict__ dct,
    float* __restrict__ ceps, float* __restrict__ r, double* scratch, int n,
    int flen, int ncols, int nmel, int nac, int nceps, float power_floor,
    bool vf, bool vo) {
  constexpr int FPW = FT / 8;   // frames per warp (and per lane, stage 1)
  constexpr int FPL = FT / 32;  // frames per lane, stage 2
  constexpr int NOP = 8 * OPL;  // padded mel | autocorrelation outputs
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);  // [2][SF]
  float* ys = stages + 2 * SF;                       // [FT][YS]
  float* wa = ys + FT * YS;                          // [CC][NOP] (W | A | 0)

  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, n - f0);
  const int nout = nmel + nac;
  // output chunks of NOP; past the first, the sums live in `scratch`
  const int noc = (nout + NOP - 1) / NOP;
  const int nopt = noc * NOP;  // scratch row stride
  double* rows = scratch + (size_t)f0 * nopt;  // the block's rows, noc > 1
  const int nk = (flen + KT - 1) / KT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int fw = warp * FPW;              // stage 1: frames fw .. fw+FPW-1
  const int f2 = fw + (lane / 8) * FPL;   // stage 2: frames f2 .. f2+FPL-1
  const int og = lane % 8;                // stage 2: outputs og + 8*jj
  const float* fr = frames + (size_t)f0 * flen;

  double acc[FPL][OPL];  // the sums over the column chunks so far
#pragma unroll
  for (int i = 0; i < FPL; ++i)
#pragma unroll
    for (int j = 0; j < OPL; ++j) acc[i][j] = 0.0;

  for (int c0 = 0; c0 < ncols; c0 += CC) {
    const int cw = min(CC, ncols - c0);
    // a narrow chunk (the one-bin tail of fft/2 + 1 bins) splits the
    // samples over the lanes instead of the columns
    const bool narrow = cw <= 4;
    float xr[FPW][4], xi[FPW][4];
#pragma unroll
    for (int i = 0; i < FPW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) xr[i][q] = xi[i][q] = 0.f;
    // two stage buffers: the copies of slice s + 1 fly while slice s runs
    stage_slice(stages, fr, C, S, nf, flen, ncols, 0, c0, cw, narrow, vf,
                vo, tid);
    cp_async_commit();
    for (int s = 0; s < nk; ++s) {
      if (s + 1 < nk) {
        stage_slice(stages + ((s + 1) & 1) * SF, fr, C, S, nf, flen, ncols,
                    (s + 1) * KT, c0, cw, narrow, vf, vo, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ftile = stages + (s & 1) * SF;
      const float* ctile = ftile + FT * KT;
      const float* stile = ctile + KT * CC;
      if (!narrow) {
        // samples past flen are staged as zeros: always KT of them
#pragma unroll
        for (int kk = 0; kk < KT; kk += 4) {
          float4 bc[4], bs[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            bc[q] = *reinterpret_cast<const float4*>(ctile + (kk + q) * CC +
                                                     lane * 4);
            bs[q] = *reinterpret_cast<const float4*>(stile + (kk + q) * CC +
                                                     lane * 4);
          }
#pragma unroll
          for (int i = 0; i < FPW; ++i) {
            const float4 a =
                *reinterpret_cast<const float4*>(ftile + (fw + i) * KT + kk);
            fma4(xr[i], a.x, bc[0]);
            fma4(xr[i], a.y, bc[1]);
            fma4(xr[i], a.z, bc[2]);
            fma4(xr[i], a.w, bc[3]);
            fma4(xi[i], a.x, bs[0]);
            fma4(xi[i], a.y, bs[1]);
            fma4(xi[i], a.z, bs[2]);
            fma4(xi[i], a.w, bs[3]);
          }
        }
      } else {  // lane: sample `lane` of the slice, all 4 columns
        float cv[4], sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cv[q] = ctile[q * KT + lane];
          sv[q] = stile[q * KT + lane];
        }
#pragma unroll
        for (int i = 0; i < FPW; ++i) {
          const float a = ftile[(fw + i) * KT + lane];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            xr[i][q] = fmaf(a, cv[q], xr[i][q]);
            xi[i][q] = fmaf(a, sv[q], xi[i][q]);
          }
        }
      }
      __syncthreads();  // slice s is read: its buffer takes slice s + 2
    }
    if (narrow) {  // sum the lanes' partial products
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int i = 0; i < FPW; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            xr[i][q] += __shfl_xor_sync(0xffffffffu, xr[i][q], off);
            xi[i][q] += __shfl_xor_sync(0xffffffffu, xi[i][q], off);
          }
    }
    if (!narrow || lane == 0) {
      const int col = narrow ? 0 : lane * 4;
#pragma unroll
      for (int i = 0; i < FPW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ys[(fw + i) * YS + col + q] =
              fmaxf(xr[i][q] * xr[i][q] + xi[i][q] * xi[i][q], power_floor);
        }
    }
    const bool last = c0 + CC >= ncols;
    for (int oc = 0; oc < noc; ++oc) {
      const int o0 = oc * NOP;
      if (oc > 0) __syncthreads();  // every lane is done with wa
      // stage 2 reads the cw columns of ys; wa's rows past cw are zero
      for (int i = tid; i < CC * NOP; i += NT) {
        const int cc = i / NOP, j = o0 + i % NOP;
        float v = 0.f;
        if (cc < cw && j < nout)
          v = j < nmel ? W[(size_t)(c0 + cc) * nmel + j]
                       : A[(size_t)(c0 + cc) * nac + (j - nmel)];
        wa[i] = v;
      }
      __syncthreads();
      if (noc > 1) {  // this chunk's sums so far (a lane's own entries)
#pragma unroll
        for (int i = 0; i < FPL; ++i)
#pragma unroll
          for (int j = 0; j < OPL; ++j)
            acc[i][j] =
                c0 == 0 ? 0.0 : rows[(f2 + i) * nopt + o0 + og + 8 * j];
      }
      float part[FPL][OPL];  // this chunk's sums, in order over its bins
#pragma unroll
      for (int i = 0; i < FPL; ++i)
#pragma unroll
        for (int j = 0; j < OPL; ++j) part[i][j] = 0.f;
      for (int cc = 0; cc < cw; ++cc) {
        float y[FPL], w[OPL];
#pragma unroll
        for (int i = 0; i < FPL; ++i) y[i] = ys[(f2 + i) * YS + cc];
#pragma unroll
        for (int j = 0; j < OPL; ++j) w[j] = wa[cc * NOP + og + 8 * j];
#pragma unroll
        for (int i = 0; i < FPL; ++i)
#pragma unroll
          for (int j = 0; j < OPL; ++j)
            part[i][j] = fmaf(y[i], w[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < FPL; ++i)
#pragma unroll
        for (int j = 0; j < OPL; ++j) acc[i][j] += part[i][j];
      if (noc > 1) {  // the last column chunk leaves the log-mel rows
#pragma unroll
        for (int i = 0; i < FPL; ++i)
#pragma unroll
          for (int j = 0; j < OPL; ++j) {
            const int o = o0 + og + 8 * j;
            rows[(f2 + i) * nopt + o] =
                last && o < nmel ? logf(fmaxf((float)acc[i][j], power_floor))
                                 : acc[i][j];
          }
      }
    }
  }
  __syncthreads();  // every lane is done with ys: reuse it for the sums

  if (noc > 1) {  // the scratch rows hold log-mel | autocorrelation
    for (int i = tid; i < nf * nceps; i += NT) {
      const int f = i / nceps, c = i % nceps;
      const double* lm = rows + (size_t)f * nopt;
      float s = 0.f;
      for (int m = 0; m < nmel; ++m)
        s = fmaf((float)lm[m], dct[m * nceps + c], s);
      ceps[(size_t)(f0 + f) * nceps + c] = s;
    }
    for (int i = tid; i < nf * nac; i += NT) {
      const int f = i / nac, j = i % nac;
      r[(size_t)(f0 + f) * nac + j] =
          (float)rows[(size_t)f * nopt + nmel + j];
    }
    return;
  }

  float* sums = ys;  // [FT][NOP]: log-mel | autocorrelation
#pragma unroll
  for (int i = 0; i < FPL; ++i)
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int o = og + 8 * j;
      sums[(f2 + i) * NOP + o] = o < nmel
          ? logf(fmaxf((float)acc[i][j], power_floor)) : (float)acc[i][j];
    }
  __syncthreads();

  for (int i = tid; i < nf * nceps; i += NT) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + f * NOP;
    float s = 0.f;
    for (int m = 0; m < nmel; ++m) s = fmaf(lm[m], dct[m * nceps + c], s);
    ceps[(size_t)(f0 + f) * nceps + c] = s;
  }
  for (int i = tid; i < nf * nac; i += NT) {
    const int f = i / nac, j = i % nac;
    r[(size_t)(f0 + f) * nac + j] = sums[f * NOP + nmel + j];
  }
}

// OPL for nout outputs: 9 (<= 72), 16 (<= 128) or 24 (more: output
// chunks of 192).
int pick_opl(int nout) { return nout <= 72 ? 9 : nout <= 128 ? 16 : 24; }

static_assert(4 * smem_floats(24) <= MAX_SMEM, "the widest block fits");

template <int OPL>
cudaError_t launch(cudaStream_t st, const float* frames, const float* C,
                   const float* S, const float* W, const float* A,
                   const float* dct, float* ceps, float* r, double* scratch,
                   int n, int flen, int ncols, int nmel, int nac, int nceps,
                   float power_floor) {
  const auto aligned = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vf = flen % 4 == 0 && aligned(frames);
  const bool vo = ncols % 4 == 0 && aligned(C) && aligned(S);
  const int smem = 4 * smem_floats(OPL);
  cudaError_t err = cudaFuncSetAttribute(
      frames_frontend_kernel<OPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  frames_frontend_kernel<OPL><<<(n + FT - 1) / FT, NT, smem, st>>>(
      frames, C, S, W, A, dct, ceps, r, scratch, n, flen, ncols, nmel, nac,
      nceps, power_floor, vf, vo);
  return cudaGetLastError();
}

}  // namespace

// Floats of the global scratch a call of n frames with nout = nmel + nac
// outputs needs: 0 up to 192 outputs, else a row of doubles (two floats
// each) of every output chunk for each frame of every block.
extern "C" long long srt_frames_scratch_floats(int n, int nout) {
  if (nout <= 8 * 24) return 0;
  const long long chunks = (nout + 8 * 24 - 1) / (8 * 24);
  return 2LL * ((n + FT - 1) / FT) * FT * chunks * (8 * 24);
}

// C and S [flen, ncols], W [ncols, nmel], A [ncols, nac], dct [nmel,
// nceps]; writes ceps [n, nceps] and r [n, nac], using scratch
// [srt_frames_scratch_floats(n, nmel + nac)] (unread when that is 0).
extern "C" int srt_frames_frontend(
    const void* frames, const void* C, const void* S, const void* W,
    const void* A, const void* dct, void* ceps, void* r, void* scratch,
    int n, int flen, int ncols, int nmel, int nac, int nceps,
    float power_floor, void* stream) {
  if (n < 1 || (srt_frames_scratch_floats(n, nmel + nac) && !scratch))
    return (int)cudaErrorInvalidValue;
  const int opl = pick_opl(nmel + nac);
  const auto go = [&](auto oc) {
    return (int)launch<decltype(oc)::value>(
        (cudaStream_t)stream, (const float*)frames, (const float*)C,
        (const float*)S, (const float*)W, (const float*)A, (const float*)dct,
        (float*)ceps, (float*)r, (double*)scratch, n, flen, ncols, nmel, nac,
        nceps, power_floor);
  };
  return opl == 9    ? go(std::integral_constant<int, 9>{})
         : opl == 16 ? go(std::integral_constant<int, 16>{})
                     : go(std::integral_constant<int, 24>{});
}
