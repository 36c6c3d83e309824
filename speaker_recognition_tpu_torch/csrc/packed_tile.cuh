// The packed frontend's per-tile stages: tile_features and cmvn_utterance,
// shared by csrc/frontend.cu (the signal-level frontend, on the FFT tile)
// and csrc/predict_fused.cuh (the fused predict monolith); the dense
// tile_sums serves the routes that round the DFT operand D to bf16: the
// monolith's bf16 route and K1's and K4's mm_bf16 (csrc/frontend_bf16.cu).
// For a tile of FT consecutive frames of one utterance:
//   tile_sums      stage the tile's overlapping samples, walk the packed
//                  DFT columns in chunks of CC, fold each chunk's Y = X^2
//                  into register accumulators of the mel and
//                  autocorrelation products; leaves log(max(mel, floor))
//                  and the raw autocorrelation per frame in shared memory;
//   tile_features  cepstra (log-mel . dct) and LPC (Levinson, non-finite
//                  -> 0) or the raw autocorrelation per frame, zeros at
//                  frames past n_valid;
// and, per utterance, cmvn_utterance: masked two-pass mean and population
// deviation of the cepstra, in place.
//
// The design notes (why this tiling, what bounds it) are in
// csrc/frontend.cu. The block is NT = 256 threads. Built without
// --use_fast_math: isfinite() must survive and logf must be the accurate
// one (an all-zero frame gives r = 0 -> 0/0 -> LPC 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CC = 128;       // packed DFT columns per chunk
constexpr int YS = CC + 1;    // padded row stride of the squared tile
constexpr int KT = 32;        // D rows per staged tile
constexpr int NT = 256;       // threads per block: 8 warps
constexpr int MAX_SMEM = 232448;

// samples a tile of ft frames spans, rounded up to keep dtile 16-byte aligned
__host__ __device__ constexpr int seg_len(int ft, int flen, int fshift) {
  return ((ft - 1) * fshift + flen + 3) / 4 * 4;
}

// floats of shared memory: the tile's samples (none when they are read
// from device memory, gseg), a D tile, the squared tile, the W | A chunk
__host__ __device__ constexpr int smem_floats(int ft, int opl, int flen,
                                              int fshift, bool gseg = false) {
  return (gseg ? 0 : seg_len(ft, flen, fshift)) + KT * CC + ft * YS +
         CC * 8 * opl;
}

// columns of a feature row: cepstra, then the LPC (order = nac - 1) or,
// without fuse_lpc, the nac raw autocorrelation lags
__host__ __device__ constexpr int feature_width(int nceps, int nac,
                                                int fuse_lpc) {
  return nceps + (fuse_lpc ? (nac > 0 ? nac - 1 : 0) : nac);
}

// Output chunks of 8 * OPL the tile projects onto one after the other: 1
// up to 128 outputs, then chunks of 128 (OPL 16).
inline int dense_chunks(int nout) { return nout <= 128 ? 1 : (nout + 127) / 128; }

// The tile for a geometry: (FT, OPL) = (128, 9) where it fits, else
// (64, 9) up to 72 outputs and (64, 16) past them, else (32, 16) for frames
// too long for 64, and past that (32, 16) with the samples read from
// device memory (*gseg = 1). OPL 16 takes any number of outputs, in
// dense_chunks(nout) chunks of 128.
inline void pick(int flen, int fshift, int nout, int* ft, int* opl,
                 int* gseg) {
  *opl = nout <= 72 ? 9 : 16;
  *gseg = 0;
  // 128-frame tiles issue fewer shared-memory loads per FMA in the DFT
  // stage; 64-frame tiles fit longer frames and 16 outputs per lane
  if (*opl == 9 && 4 * smem_floats(128, 9, flen, fshift) <= MAX_SMEM) {
    *ft = 128;
  } else if (4 * smem_floats(64, *opl, flen, fshift) <= MAX_SMEM) {
    *ft = 64;
  } else {
    *ft = 32;
    *opl = 16;
    *gseg = 4 * smem_floats(32, 16, flen, fshift) > MAX_SMEM;
  }
}

__device__ __forceinline__ void fma4(float (&x)[4], float a, float4 b) {
  x[0] = fmaf(a, b.x, x[0]);
  x[1] = fmaf(a, b.y, x[1]);
  x[2] = fmaf(a, b.z, x[2]);
  x[3] = fmaf(a, b.w, x[3]);
}

// A DFT operand as staged: itself, or rounded to bf16 (nearest even) and
// widened back, so that the f32 products are those of bf16 operands.
template <bool BF16>
__device__ __forceinline__ float staged(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// sig: the tile's first sample; avail: samples from there to the end of
// the padded signal. Returns sums [FT][8*OPL] in shared memory: columns
// < nmel hold log(max(mel, power_floor)), the next nac the raw
// autocorrelation Y . A. Ends on a barrier. With GSEG the samples are read
// from device memory where they are used instead of staged. Past 128
// outputs (OPL 16, nchunk > 1) W | A are walked in chunks of 128 outputs
// inside each column chunk, each output's sum carried between column
// chunks in the tile's rows of wsums [nf][wstride] in device memory, where
// the sums stay (and nullptr returns); each output's FMAs run over the
// columns in the same order whatever the count, so at most 128 outputs
// keep their bits inside a larger call.
template <int FT, int OPL, bool BF16, bool GSEG = false>
__device__ __forceinline__ float* tile_sums(
    const float* __restrict__ sig, int avail, const float* __restrict__ D,
    const float* __restrict__ W, const float* __restrict__ A, float* smem,
    int flen, int fshift, int ncols, int nmel, int nac, float power_floor,
    int nchunk = 1, float* __restrict__ wsums = nullptr, int wstride = 0,
    int nf = FT) {
  constexpr int FPW = FT / 8;   // frames per warp (and per lane, stage 1)
  constexpr int FPL = FT / 32;  // frames per lane, stage 2
  constexpr int NOP = 8 * OPL;  // padded mel | autocorrelation outputs
  const int nout = nmel + nac;
  const int tid = threadIdx.x;

  const int sl = GSEG ? 0 : seg_len(FT, flen, fshift);
  float* seg = smem;                  // [sl]
  float* dtile = seg + sl;            // [KT][CC]
  float* ys = dtile + KT * CC;        // [FT][YS]
  float* wa = ys + FT * YS;           // [CC][NOP]  (W | A | 0) chunk

  if (!GSEG)
    for (int i = tid; i < sl; i += NT)
      seg[i] = i < avail ? staged<BF16>(sig[i]) : 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const int fw = warp * FPW;              // stage 1: frames fw .. fw+FPW-1
  const int f2 = fw + (lane / 8) * FPL;   // stage 2: frames f2 .. f2+FPL-1
  const int og = lane % 8;                // stage 2: outputs og + 8*jj
  // 16-byte frame loads need every frame and k tile 4-aligned in seg
  const bool vec4 = !GSEG && fshift % 4 == 0 && flen % 4 == 0;
  const int nch = OPL == 16 ? nchunk : 1;
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
                       ? staged<BF16>(D[(size_t)(k0 + kk) * ncols + c0 + cc])
                       : 0.f;
      }
      __syncthreads();
      if (GSEG) {  // each sample from device memory, as staged would be
        const int s0 = fw * fshift + k0;
        for (int kk = 0; kk < kw; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(dtile + kk * CC + lane * 4);
#pragma unroll
          for (int i = 0; i < FPW; ++i) {
            const int si = s0 + i * fshift + kk;
            fma4(x[i], si < avail ? staged<BF16>(sig[si]) : 0.f, bv);
          }
        }
        continue;
      }
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
    const bool last = c0 + CC >= ncols;
    for (int oc = 0; oc < nch; ++oc) {
      const int o0 = NOP * oc;
      if (nch > 1) __syncthreads();  // the previous chunk's readers of wa
      for (int i = tid; i < CC * NOP; i += NT) {
        const int cc = i / NOP, j = o0 + i % NOP;
        float v = 0.f;
        if (cc < cw && j < nout)
          v = j < nmel ? W[(size_t)(c0 + cc) * nmel + j]
                       : A[(size_t)(c0 + cc) * nac + (j - nmel)];
        wa[i] = v;
      }
      __syncthreads();
      if (nch > 1) {  // OPL 16 only: this chunk's sums so far
#pragma unroll
        for (int i = 0; i < FPL; ++i)
#pragma unroll
          for (int j = 0; j < OPL; ++j)
            acc[i][j] = c0 > 0 && f2 + i < nf
                            ? wsums[(size_t)(f2 + i) * wstride + o0 + og +
                                    8 * j]
                            : 0.f;
      }
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
            acc[i][j] = fmaf(y[i], w[j], acc[i][j]);
      }
      if (nch > 1) {
#pragma unroll
        for (int i = 0; i < FPL; ++i) {
          if (f2 + i >= nf) continue;
#pragma unroll
          for (int j = 0; j < OPL; ++j) {
            const int o = o0 + og + 8 * j;
            wsums[(size_t)(f2 + i) * wstride + o] =
                last && o < nmel ? logf(fmaxf(acc[i][j], power_floor))
                                 : acc[i][j];
          }
        }
      }
    }
  }
  __syncthreads();  // every lane is done with ys: reuse it for the sums
  if (nch > 1) return nullptr;  // the sums are in wsums

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
  return sums;
}

// Levinson-Durbin of order `order` on the autocorrelation r in the order
// of ops/levinson.levinson_unrolled, its coefficients in a[0 .. order-1]
// updated in place a symmetric pair at a time (each new value is the one
// the two-array form computes).
__device__ __forceinline__ void levinson_in_place(const float* r, float* a,
                                                  int order) {
  float e = r[0];
  for (int i = 1; i <= order; ++i) {
    float s = r[i];
    for (int j = 1; j < i; ++j) s += a[j - 1] * r[i - j];
    const float k = -s / e;
    // a[j-1] += k a[i-j-1] for j = 1 .. i-1, from the old values
    for (int j = 1, l = i - 1; j <= l; ++j, --l) {
      const float lo = a[j - 1], hi = a[l - 1];
      a[j - 1] = lo + k * hi;
      if (j < l) a[l - 1] = hi + k * lo;
    }
    a[i - 1] = k;
    e = e * (1.f - k * k);
  }
}

// The features of the tile's nf frames from tile_sums' sums (rows of
// `stride` floats: 8 * OPL in shared memory, or rows in device memory past
// 512 outputs and on the FFT of N >= 32768), into out [nf][nfeat]:
// cepstra, then with fuse_lpc the LPC (nfeat = nceps + order, order = nac
// - 1, or 0 without LPC) by Levinson-Durbin with non-finite coefficients
// zeroed, and without it the raw autocorrelation as it stands in sums
// (nfeat = nceps + nac), which the LPC cepstra take. Frames at or past
// nvalid (counted from the tile's first frame) get zeros. NTH threads run
// it; the recursion takes any order, one thread a frame, its coefficients
// in a local array below 8 * OPL and in the frame's output row past it.
template <int OPL, int NTH = NT>
__device__ __forceinline__ void tile_features(
    const float* sums, float* __restrict__ out, int nf, int nvalid,
    const float* __restrict__ dct, int nmel, int nac, int nceps,
    bool fuse_lpc, int stride = 8 * OPL) {
  constexpr int NOP = 8 * OPL;
  const int order = nac > 0 ? nac - 1 : 0;
  const int nfeat = nceps + (fuse_lpc ? order : nac);
  const int tid = threadIdx.x;

  for (int i = tid; i < nf * nceps; i += NTH) {
    const int f = i / nceps, c = i % nceps;
    const float* lm = sums + (size_t)f * stride;
    float s = 0.f;
    for (int m = 0; m < nmel; ++m) s = fmaf(lm[m], dct[m * nceps + c], s);
    out[f * nfeat + c] = f < nvalid ? s : 0.f;
  }

  if (!fuse_lpc) {
    for (int i = tid; i < nf * nac; i += NTH) {
      const int f = i / nac, j = i % nac;
      out[f * nfeat + nceps + j] =
          f < nvalid ? sums[(size_t)f * stride + nmel + j] : 0.f;
    }
    return;
  }
  if (order == 0) return;
  for (int f = tid; f < nf; f += NTH) {
    float* o = out + f * nfeat + nceps;
    if (f >= nvalid) {
      for (int j = 0; j < order; ++j) o[j] = 0.f;
      continue;
    }
    const float* r = sums + (size_t)f * stride + nmel;
    if (order < NOP) {
      float a[NOP];
      levinson_in_place(r, a, order);
      for (int j = 0; j < order; ++j) o[j] = isfinite(a[j]) ? a[j] : 0.f;
    } else {
      levinson_in_place(r, o, order);
      for (int j = 0; j < order; ++j) o[j] = isfinite(o[j]) ? o[j] : 0.f;
    }
  }
}

// Masked per-utterance CMVN of x[:nv, :nceps] (row stride nfeat), in
// place: two-pass mean and population variance, the identity at <= 1
// valid frame (src/feature/MFCC.py:74-77). Threads are 32 columns (c) x CG
// frame groups (g), walking the columns 32 at a time; red [CG][32] and
// stat [2][32] are shared scratch. The partial sums combine in a fixed
// order, so the result is deterministic.
template <int CG>
__device__ __forceinline__ void cmvn_utterance(
    float* __restrict__ x, int nv, int nfeat, int nceps, int c, int g,
    float (*red)[32], float (*stat)[32]) {
  if (nv <= 1) return;  // block-uniform
  for (int c0 = 0; c0 < nceps; c0 += 32) {
    const int cc = c0 + c;
    const bool col = cc < nceps;
    float s = 0.f;
    if (col)
      for (int t = g; t < nv; t += CG) s += x[(size_t)t * nfeat + cc];
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
        const float d = x[(size_t)t * nfeat + cc] - mu;
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
        float* v = x + (size_t)t * nfeat + cc;
        *v = (*v - mu) / sd;
      }
    __syncthreads();  // red and stat are free for the next columns
  }
}

}  // namespace
