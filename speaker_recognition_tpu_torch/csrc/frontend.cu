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
// Built without --use_fast_math: isfinite() must survive and logf must be
// the accurate one (an all-zero frame gives r = 0 -> 0/0 -> LPC 0).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CC = 128;       // packed DFT columns per chunk
constexpr int YS = CC + 1;    // padded row stride of the squared tile
constexpr int KT = 32;        // D rows per staged tile
constexpr int NT = 256;       // threads per block: 8 warps
constexpr int MAX_ORDER = 32;
constexpr int MAX_SMEM = 232448;

// samples a tile of ft frames spans, rounded up to keep dtile 16-byte aligned
__host__ __device__ constexpr int seg_len(int ft, int flen, int fshift) {
  return ((ft - 1) * fshift + flen + 3) / 4 * 4;
}

__host__ __device__ constexpr int smem_floats(int ft, int opl, int flen,
                                              int fshift) {
  return seg_len(ft, flen, fshift) + KT * CC + ft * YS + CC * 8 * opl;
}

__device__ __forceinline__ void fma4(float (&x)[4], float a, float4 b) {
  x[0] = fmaf(a, b.x, x[0]);
  x[1] = fmaf(a, b.y, x[1]);
  x[2] = fmaf(a, b.z, x[2]);
  x[3] = fmaf(a, b.w, x[3]);
}

template <int FT, int OPL>
__global__ void __launch_bounds__(NT, 1) packed_frontend_kernel(
    const float* __restrict__ signals, const int* __restrict__ n_valid,
    const float* __restrict__ D, const float* __restrict__ W,
    const float* __restrict__ A, const float* __restrict__ dct,
    float* __restrict__ feat, int Lp, int T, int flen, int fshift, int ncols,
    int nmel, int nac, int nceps, float power_floor) {
  constexpr int FPW = FT / 8;   // frames per warp (and per lane, stage 1)
  constexpr int FPL = FT / 32;  // frames per lane, stage 2
  constexpr int NOP = 8 * OPL;  // padded mel | autocorrelation outputs
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, T - f0);
  const int nout = nmel + nac;
  const int order = nac > 0 ? nac - 1 : 0;
  const int nfeat = nceps + order;
  const int tid = threadIdx.x;
  const int nvalid = n_valid[b];
  float* out = feat + ((size_t)b * T + f0) * nfeat;

  if (f0 >= nvalid) {  // block-uniform: the whole tile is padding
    for (int i = tid; i < nf * nfeat; i += NT) out[i] = 0.f;
    return;
  }

  const int sl = seg_len(FT, flen, fshift);
  float* seg = smem;                  // [sl]
  float* dtile = seg + sl;            // [KT][CC]
  float* ys = dtile + KT * CC;        // [FT][YS]
  float* wa = ys + FT * YS;           // [CC][NOP]  (W | A | 0) chunk

  const float* sig = signals + (size_t)b * Lp + (size_t)f0 * fshift;
  const int avail = Lp - f0 * fshift;
  for (int i = tid; i < sl; i += NT) seg[i] = i < avail ? sig[i] : 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const int fw = warp * FPW;              // stage 1: frames fw .. fw+FPW-1
  const int f2 = fw + (lane / 8) * FPL;   // stage 2: frames f2 .. f2+FPL-1
  const int og = lane % 8;                // stage 2: outputs og + 8*jj
  // 16-byte frame loads need every frame and k tile 4-aligned in seg
  const bool vec4 = fshift % 4 == 0 && flen % 4 == 0;
  float acc[FPL][OPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i)
#pragma unroll
    for (int j = 0; j < OPL; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < ncols; c0 += CC) {
    const int cw = min(CC, ncols - c0);
    float x[FPW][4];
#pragma unroll
    for (int i = 0; i < FPW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) x[i][q] = 0.f;
    for (int k0 = 0; k0 < flen; k0 += KT) {
      const int kw = min(KT, flen - k0);
      __syncthreads();  // previous readers of dtile / ys / wa are done
      for (int i = tid; i < KT * CC; i += NT) {
        const int kk = i / CC, cc = i % CC;
        dtile[i] = (kk < kw && cc < cw)
                       ? D[(size_t)(k0 + kk) * ncols + c0 + cc] : 0.f;
      }
      __syncthreads();
      const float* s = seg + fw * fshift + k0;
      if (vec4) {  // block-uniform: 4 samples of a frame per load
        for (int kk = 0; kk < kw; kk += 4) {
          float4 bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(
                dtile + (kk + q) * CC + lane * 4);
#pragma unroll
          for (int i = 0; i < FPW; ++i) {
            const float4 a =
                *reinterpret_cast<const float4*>(s + i * fshift + kk);
            fma4(x[i], a.x, bv[0]);
            fma4(x[i], a.y, bv[1]);
            fma4(x[i], a.z, bv[2]);
            fma4(x[i], a.w, bv[3]);
          }
        }
      } else {
        for (int kk = 0; kk < kw; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(dtile + kk * CC + lane * 4);
#pragma unroll
          for (int i = 0; i < FPW; ++i) fma4(x[i], s[i * fshift + kk], bv);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FPW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ys[(fw + i) * YS + lane * 4 + q] = x[i][q] * x[i][q];
    for (int i = tid; i < CC * NOP; i += NT) {
      const int cc = i / NOP, j = i % NOP;
      float v = 0.f;
      if (cc < cw && j < nout)
        v = j < nmel ? W[(size_t)(c0 + cc) * nmel + j]
                     : A[(size_t)(c0 + cc) * nac + (j - nmel)];
      wa[i] = v;
    }
    __syncthreads();
    for (int cc = 0; cc < cw; ++cc) {
      float y[FPL], w[OPL];
#pragma unroll
      for (int i = 0; i < FPL; ++i) y[i] = ys[(f2 + i) * YS + cc];
#pragma unroll
      for (int j = 0; j < OPL; ++j) w[j] = wa[cc * NOP + og + 8 * j];
#pragma unroll
      for (int i = 0; i < FPL; ++i)
#pragma unroll
        for (int j = 0; j < OPL; ++j) acc[i][j] = fmaf(y[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();  // every lane is done with ys: reuse it for the sums

  float* sums = ys;  // [FT][NOP]: log-mel | autocorrelation
#pragma unroll
  for (int i = 0; i < FPL; ++i)
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int o = og + 8 * j;
      sums[(f2 + i) * NOP + o] =
          o < nmel ? logf(fmaxf(acc[i][j], power_floor)) : acc[i][j];
    }
  __syncthreads();

  for (int i = tid; i < nf * nceps; i += NT) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + f * NOP;
    float s = 0.f;
    for (int m = 0; m < nmel; ++m) s = fmaf(lm[m], dct[m * nceps + c], s);
    out[f * nfeat + c] = f0 + f < nvalid ? s : 0.f;
  }

  if (order == 0) return;
  for (int f = tid; f < nf; f += NT) {
    float* o = out + f * nfeat + nceps;
    if (f0 + f >= nvalid) {
      for (int j = 0; j < order; ++j) o[j] = 0.f;
      continue;
    }
    // Levinson-Durbin in the order of ops/levinson.levinson_unrolled
    const float* r = sums + f * NOP + nmel;
    float a[MAX_ORDER], prev[MAX_ORDER];
    float e = r[0];
    for (int i = 1; i <= order; ++i) {
      float s = r[i];
      for (int j = 1; j < i; ++j) s += a[j - 1] * r[i - j];
      const float k = -s / e;
      for (int j = 0; j < i - 1; ++j) prev[j] = a[j];
      for (int j = 1; j < i; ++j) a[j - 1] = prev[j - 1] + k * prev[i - j - 1];
      a[i - 1] = k;
      e = e * (1.f - k * k);
    }
    for (int j = 0; j < order; ++j) o[j] = isfinite(a[j]) ? a[j] : 0.f;
  }
}

// Masked per-utterance CMVN of feat[b, :n_valid[b], :nceps], in place:
// two-pass mean and population variance, identity at <= 1 valid frame
// (src/feature/MFCC.py:74-77). 32 columns x 16 frame groups per block; the
// partial sums are combined in a fixed order, so the result is
// deterministic.
constexpr int CG = 16;

__global__ void __launch_bounds__(32 * CG) cmvn_kernel(
    float* __restrict__ feat, const int* __restrict__ n_valid, int T,
    int nfeat, int nceps) {
  __shared__ float red[CG][32];
  __shared__ float stat[2][32];
  const int b = blockIdx.x, c = threadIdx.x, g = threadIdx.y;
  const int nv = n_valid[b];
  if (nv <= 1) return;  // block-uniform
  float* x = feat + (size_t)b * T * nfeat;
  const bool col = c < nceps;

  float s = 0.f;
  if (col)
    for (int t = g; t < nv; t += CG) s += x[(size_t)t * nfeat + c];
  red[g][c] = s;
  __syncthreads();
  if (g == 0) {
    float tot = 0.f;
    for (int k = 0; k < CG; ++k) tot += red[k][c];
    stat[0][c] = tot / (float)nv;
  }
  __syncthreads();
  const float mu = stat[0][c];
  s = 0.f;
  if (col)
    for (int t = g; t < nv; t += CG) {
      const float d = x[(size_t)t * nfeat + c] - mu;
      s += d * d;
    }
  red[g][c] = s;
  __syncthreads();
  if (g == 0) {
    float tot = 0.f;
    for (int k = 0; k < CG; ++k) tot += red[k][c];
    stat[1][c] = sqrtf(tot / (float)nv);
  }
  __syncthreads();
  const float sd = stat[1][c];
  if (col)
    for (int t = g; t < nv; t += CG) {
      float* v = x + (size_t)t * nfeat + c;
      *v = (*v - mu) / sd;
    }
}

// The instantiation for a geometry: (FT, OPL) = (128, 9) where it fits,
// else (64, 9), else (64, 16); 0 when none fits.
int pick(int flen, int fshift, int nout, int* ft, int* opl) {
  const int o = nout <= 72 ? 9 : nout <= 128 ? 16 : 0;
  if (o == 0) return 0;
  // 128-frame tiles issue fewer shared-memory loads per FMA in the DFT
  // stage; 64-frame tiles fit longer frames and 16 outputs per lane
  if (o == 9 && 4 * smem_floats(128, o, flen, fshift) <= MAX_SMEM)
    *ft = 128;
  else if (4 * smem_floats(64, o, flen, fshift) <= MAX_SMEM)
    *ft = 64;
  else
    return 0;
  *opl = o;
  return 1;
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
