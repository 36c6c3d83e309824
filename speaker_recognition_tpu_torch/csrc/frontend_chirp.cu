// Full-spectrum MFCC frontend on a chirp-z (Bluestein) FFT, for Hopper
// (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run
// (mfcc_from_frames) at an fft_size N that is not a power of two (1500 at
// 8 kHz, 1411 = the frame at 44.1 kHz, a Whisper-style 400), where the FFT
// tile of csrc/frontend_fft.cu does not serve:
//     power = max(|DFT_N(wp)|^2, floor)     (bins 0..N/2, per bin)
//     ceps  = log(max(power . mel, floor)) . dct,   r = power . acorr
// for windowed, pre-emphasized frames wp [n, flen]; samples t >= N fold
// onto t mod N, which is what the TPU kernel's C and S compute there. It
// writes pre-CMVN cepstra [n, nceps] and the RAW autocorrelation [n, nac]
// (nac = 0 for an MFCC-only config), as csrc/frontend_fft.cu does.
//
// The DFT of N points as a circular convolution of M points (M a power of
// two): with c_j = exp(-pi i j^2 / N), L = min(flen, N) folded samples and
// nb = N/2 + 1 bins,
//     X_k = c_k sum_n (x_n c_n) conj(c_{k-n}),   k < nb, n < L,
// a linear convolution of L and L + nb - 1 terms, so any M >= L + nb - 1
// holds it (M = chirp_m: at least 1024, at most 8192). Per frame, one
// warp:
//   1. a_n = x_n c_n, zero past L, in the gather of the M-point FFT;
//   2. the complex FFT of M points (M / 32 values a lane: rounds of 32 in
//      registers, the stages across a lane's rounds in its block of the
//      warp's shared buffer, the last five in column passes of 32 slots:
//      the tile's register_stages and column stages, as in its
//      big_fft_frames);
//   3. in the column passes, times Bh = FFT_M(b) / M, b_m = conj(c_m) for m
//      in (-L, nb) wrapped mod M, and conjugated, in place;
//   4. the same FFT of that (the inverse as conj(FFT(conj(.))) / M: the
//      1 / M is in Bh);
//   5. in its column passes, |y_k|^2 for k < nb: the power, since
//      |X_k| = |c_k y_k| = |y_k| (no multiply by c_k), floored per bin,
//      into the block's power rows ys [FT][nb];
//   6. the FFT tile's projection (rfft::project_bins: the packed [mel |
//      acorr | 0] operator in chunks, all-zero 4-column groups skipped,
//      each output over the bins in order; an active group walks a
//      chunk's bins, which suits 200 narrow mel filters), log, DCT
//      (rfft::frame_outputs).
// The tables c [L] and Bh [M] come from the wrapper (ops/gpu_frontend.
// chirp_tables: float64 on the host, j^2 mod 2N in integers so that every
// angle is exact, then f32), built once per (N, flen); the FFT's twiddles
// from sincospif of exact angles. No --use_fast_math. Every sum runs in a
// fixed order and there are no atomics, so two calls give the same bits.
//
// What bounds it on this card: the least work is FLOPs (a real FFT of N
// points, two per nonzero of the operators, the DCT) or the frames' bytes;
// the route does two complex FFTs of M points a frame (about 2 x 5 M log2
// M FLOPs, 100 kFLOP at M = 1024) and the projection, bound like the tile
// by instruction issue and shared-memory latency at one block an SM; the
// projection onto 216 outputs takes most of its time
// (speaker_recognition_tpu_torch/tools/fft_ablation.py --route chirp). What
// the design does about it: no operator larger than the tables streams
// (the dense template, csrc/frontend_frames.cu, read C and S [flen][nb]
// through every block: 2 flen nb FMAs a frame and matrix), the spectrum
// never leaves shared memory or registers, and the pointwise product and
// the power happen in the column passes' registers.
//
// Geometry by M (warps, frames a tile, buffers a warp): 1024 (8, 32, 1),
// 2048 (4, 16, 1), 4096 (2, 4, 2), 8192 (1, 2, 2); the projection's chunk
// is 32 bins (16 at 512 outputs) up to M = 2048 where shared memory holds
// it beside the power rows (wide_chunks: 1500 at 8 kHz, 1000 at 48 kHz),
// else 16 (8). Up to 2048 the inverse
// FFT's rounds refill the slots they gathered (a round's slots are the same
// set before and after), so one buffer serves; from 4096 on a lane's
// rounds would overwrite slots other rounds still gather, and the inverse
// writes a second buffer. Past M = 8192 the cluster FFT of csrc/
// frontend_chirp_cluster.cu serves, past its reach the dense template (its
// own counter).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "rfft_big.cuh"
#include "rfft_cluster.cuh"
#include "rfft_tile.cuh"

namespace {
namespace chirp {

constexpr int MAX_SMEM = 232448;

__host__ __device__ constexpr int warps(int m) {
  return m >= 8192 ? 1 : m >= 4096 ? 2 : m >= 2048 ? 4 : 8;
}
__host__ __device__ constexpr int ft(int m) {
  return m >= 8192 ? 2 : m >= 4096 ? 4 : m >= 2048 ? 16 : 32;
}
__host__ __device__ constexpr int nbuf(int m) { return m >= 4096 ? 2 : 1; }
// float2 slots of a buffer: M and one pad after each lane's block
__host__ __device__ constexpr int slots(int m) { return m + 32; }
// staged column twiddles up to M = 2048 (all spans), else only the spans
// of the stages across a lane's rounds; W_32^k first
__host__ __device__ constexpr bool staged(int m) { return m <= 2048; }
__host__ __device__ constexpr int twiddles(int m) {
  return 16 + (staged(m) ? m : m / 32) - 32;
}
// bins per staged operator chunk: ck(opl) at any nb, twice that (half the
// walk's chunks, each behind two barriers) up to M = 2048 where shared
// memory holds it
__host__ __device__ constexpr int ck(int opl) { return opl > 32 ? 8 : 16; }

// M for an N-point DFT of frames of flen samples where this kernel takes it
// (srt_cluster::chirp_m up to 8192; csrc/frontend_chirp_cluster.cu past
// it), else 0.
inline int chirp_m(int n, int flen) {
  const int m = srt_cluster::chirp_m(n, flen);
  return m <= srt_cluster::CHIRP_TILE_M ? m : 0;
}

// floats of a row of the power rows: nb, odd (a column read by a warp's
// frames falls in distinct banks), and at least NOP (the rows then take the
// sums)
__host__ __device__ inline int ys_stride(int nb, int opl) {
  const int s = nb | 1;
  return s > rfft::nop(opl) ? s : rfft::nop(opl);
}

// floats of shared memory with chunks of ckb bins: operator chunk, buffers
// (float2), twiddles (float2), power rows
__host__ __device__ inline int smem_floats(int m, int opl, int nb, int ckb) {
  return ckb * rfft::nop(opl) + 2 * warps(m) * nbuf(m) * slots(m) +
         2 * twiddles(m) + ft(m) * ys_stride(nb, opl);
}

// whether the walk takes chunks of 2 ck(opl) bins
inline bool wide_chunks(int m, int opl, int nb) {
  return m <= 2048 && 4 * smem_floats(m, opl, nb, 2 * ck(opl)) <= MAX_SMEM;
}

// rows of the packed operator an output chunk: bins 0..N/2, zero rows to a
// multiple of 2 ck(opl), which either chunk divides
__host__ __device__ inline int op_rows(int nb, int opl) {
  return (nb + 2 * ck(opl) - 1) / (2 * ck(opl)) * (2 * ck(opl));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Five column stages over the values r[b] of slots CB b + c (b < 32), the
// twiddles W_{2m}^j from the staged table ctw (span m at ctw[m - 32 + j]):
// rfft::column_stages with every span's table staged.
template <int CB>
__device__ __forceinline__ void column_stages_staged(float2 (&r)[32], int c,
                                                     const float2* ctw) {
#pragma unroll
  for (int s2 = 0; s2 < 5; ++s2) {
    const int mb = 1 << s2, m = CB << s2;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (b & mb) continue;
      const float2 w = ctw[m - 32 + CB * (b & (mb - 1)) + c];
      const float2 u = r[b], v = cmul(w, r[b + mb]);
      r[b] = make_float2(u.x + v.x, u.y + v.y);
      r[b + mb] = make_float2(u.x - v.x, u.y - v.y);
    }
  }
}

template <int M>
__device__ __forceinline__ void column_stages(float2 (&r)[32], int c,
                                              const float2* ctw) {
  if constexpr (staged(M))
    column_stages_staged<M / 32>(r, c, ctw);
  else
    rfft::column_stages_computed<M / 32>(r, c);
}

// The a_n of the tile's frames: frame f < nf of wp rows [.][flen], folded
// onto n < L (the samples n + N, n + 2N, ... added in that order), times
// c_n; zero past L and for frames past nf.
struct ChirpFrames {
  const float* fr;
  const float2* cz;  // [L]
  int flen, n, L, nf;
  __device__ __forceinline__ float2 operator()(int f, int j) const {
    if (f >= nf || j >= L) return make_float2(0.f, 0.f);
    const float* x = fr + (size_t)f * flen;
    float s = x[j];
    for (int t = j + n; t < flen; t += n) s += x[t];
    const float2 c = __ldg(cz + j);
    return make_float2(s * c.x, s * c.y);
  }
};

// Round rd of a lane's values of an M-point FFT's input: v[q] = in(lane +
// 32 (R q + rd)), q < 32, R = M / 1024 rounds.
template <int M, class In>
__device__ __forceinline__ void gather(const In& in, int rd, int lane,
                                       float2 (&v)[32]) {
  constexpr int R = M / 1024;
#pragma unroll
  for (int q = 0; q < 32; ++q) v[q] = in(lane + 32 * (R * q + rd));
}

// The rounds and the stages across them of an M-point FFT (M = 32 PL, PL =
// 2^P values a lane, R = PL / 32 rounds of 32): round rd's values, given by
// next(rd, v) (which may gather the round after), go to the slots brev(j)
// = base + 32 brev(rd) + brev5(q) of the lane's block of dst (base =
// brev5(lane) PL) after five stages in registers; then the stages of spans
// 32 .. PL / 2 on the lane's own block. tws holds W_32^k (k < 16), then
// W_{2m}^j for m = 32, 64, ... Ends on a __syncwarp: the column passes
// cross the lanes' blocks.
template <int M, class Next>
__device__ __forceinline__ void rounds(const Next& next, float2* dst,
                                       const float2* tws, int lane) {
  constexpr int PL = M / 32, P = rfft::log2i(PL);
  constexpr int R = PL / 32, PR = rfft::log2i(R);
  const float2* mtw = tws + 16;
  const int base = rfft::brev_bits(lane, 5) << P;
#pragma unroll 1
  for (int rd = 0; rd < R; ++rd) {
    float2 r[32];
    next(rd, r);
    rfft::register_stages<5, 4>(r, tws);  // stages 0 .. 4
    const int off =
        base + (PR ? 32 * (int)(__brev((unsigned)rd) >> (32 - PR)) : 0);
#pragma unroll
    for (int t = 0; t < 32; ++t) dst[rfft::slot<P>(off + t)] = r[t];
  }
  // stages 5 .. P - 1 (spans 32 .. PL/2): within the lane's own block
#pragma unroll 1
  for (int s = 5; s < P; ++s) {
    const int m = 1 << s;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float2 w = mtw[m - 32 + j];
      for (int g = 0; g < PL / (2 * m); ++g)
        rfft::butterfly<P>(dst, base + 2 * m * g + j,
                           base + 2 * m * g + j + m, w);
    }
  }
  __syncwarp();  // every block is done before the columns cross them
}

// A column pass of an M-point FFT in buf (stages P .. P + 4 over the slots
// PL b + c): r[b] holds bin PL b + c afterwards.
template <int M>
__device__ __forceinline__ void column_pass(const float2* buf, int c,
                                            const float2* ctw,
                                            float2 (&r)[32]) {
  constexpr int PL = M / 32, P = rfft::log2i(PL);
#pragma unroll
  for (int b = 0; b < 32; ++b) r[b] = buf[rfft::slot<P>(PL * b + c)];
  column_stages<M>(r, c, ctw);
}

// The power rows ys [FT][ystride] of the tile's frames (steps 1-5 above),
// one frame per warp at a time.
template <int M>
__device__ __forceinline__ void chirp_power(const ChirpFrames& in,
                                            const float2* __restrict__ bh,
                                            float2* buf, float2* dst,
                                            float* ys, int ystride, int nb,
                                            const float2* tws,
                                            float power_floor) {
  constexpr int FT = ft(M), WARPS = warps(M);
  constexpr int PL = M / 32, P = rfft::log2i(PL), R = PL / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* ctw = tws + 16;
  float2 nxt[32];
  gather<M>([&](int j) { return in(warp, j); }, 0, lane, nxt);
  __syncthreads();  // the twiddles are staged
  for (int f = warp; f < FT; f += WARPS) {
    // 1-2. the forward FFT of a; the next round's loads fly during this
    // one's stages, the next frame's during the inverse
    rounds<M>(
        [&](int rd, float2 (&r)[32]) {
#pragma unroll
          for (int q = 0; q < 32; ++q) r[rfft::brev_bits(q, 5)] = nxt[q];
          if (rd + 1 < R)
            gather<M>([&](int j) { return in(f, j); }, rd + 1, lane, nxt);
        },
        buf, tws, lane);
    // 3. times Bh, conjugated, in natural order in place
#pragma unroll 1
    for (int u = 0; u < R; ++u) {
      const int c = 32 * u + lane;
      float2 r[32];
      column_pass<M>(buf, c, ctw, r);
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const float2 y = cmul(r[b], __ldg(bh + PL * b + c));
        buf[rfft::slot<P>(PL * b + c)] = make_float2(y.x, -y.y);
      }
    }
    __syncwarp();
    if (f + WARPS < FT)
      gather<M>([&](int j) { return in(f + WARPS, j); }, 0, lane, nxt);
    // 4. the inverse: the same FFT of buf into dst (buf itself up to M =
    // 2048: every lane has gathered a round's slots before any refills
    // them)
    rounds<M>(
        [&](int rd, float2 (&r)[32]) {
#pragma unroll
          for (int q = 0; q < 32; ++q)
            r[rfft::brev_bits(q, 5)] =
                buf[rfft::slot<P>(lane + 32 * (R * q + rd))];
          if (nbuf(M) == 1) __syncwarp();
        },
        dst, tws, lane);
    // 5. the power of bins k < nb
#pragma unroll 1
    for (int u = 0; u < R; ++u) {
      const int c = 32 * u + lane;
      float2 r[32];
      column_pass<M>(dst, c, ctw, r);
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const int k = PL * b + c;
        if (k < nb)
          ys[f * ystride + k] =
              fmaxf(r[b].x * r[b].x + r[b].y * r[b].y, power_floor);
      }
    }
    __syncwarp();  // every lane has read dst before the next frame fills it
  }
}

// Block i: frames FT i .. FT i + nf - 1. Past 512 outputs (OPL 64, nchunk
// > 1) the sums go to rows of wsums [n][wstride] and the epilogue reads
// them there, as on the tile.
template <int M, int OPL, int CK>
__global__ void __launch_bounds__(32 * warps(M)) chirp_frames_kernel(
    const float* __restrict__ frames, const float2* __restrict__ cz,
    const float2* __restrict__ bh, const float4* __restrict__ op,
    const float* __restrict__ dct, float* __restrict__ ceps,
    float* __restrict__ r, int n, int flen, int nfft, int nmel, int nac,
    int nceps, float power_floor, int nchunk, float* __restrict__ wsums) {
  constexpr int FT = ft(M), WARPS = warps(M), NTH = 32 * WARPS;
  constexpr int NOP = rfft::nop(OPL), NG = NOP / 4, LPF = 32 / FT;
  constexpr int GPW = rfft::proj_gpw(FT, WARPS, OPL);
  extern __shared__ float4 smem4[];
  const int nb = nfft / 2 + 1, ystride = ys_stride(nb, OPL);
  float* opc = reinterpret_cast<float*>(smem4);  // [CK][NOP]
  float2* bufs = reinterpret_cast<float2*>(opc + CK * NOP);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float2* buf = bufs + warp * nbuf(M) * slots(M);
  float2* dst = buf + (nbuf(M) - 1) * slots(M);
  float2* tws = bufs + WARPS * nbuf(M) * slots(M);
  float* ys = reinterpret_cast<float*>(tws + twiddles(M));
  const int f0 = blockIdx.x * FT, nf = min(FT, n - f0);

  for (int i = tid; i < twiddles(M); i += NTH) {
    float s, c;
    if (i < 16) {
      sincospif((float)i / 16.f, &s, &c);  // W_32^i
    } else {
      const int m = 1 << (31 - __clz(i - 16 + 32));  // the table of span m
      sincospif((float)(i - 16 + 32 - m) / (float)m, &s, &c);  // W_{2m}^j
    }
    tws[i] = make_float2(c, -s);
  }
  const ChirpFrames in{frames + (size_t)f0 * flen, cz, flen, nfft,
                       flen < nfft ? flen : nfft, nf};
  chirp_power<M>(in, bh, buf, dst, ys, ystride, nb, tws, power_floor);

  const int wstride = NOP * nchunk;
  float* wrows = wsums + (size_t)f0 * wstride;
  float acc[GPW][4];
  rfft::project_bins<FT, WARPS, OPL, CK, true>(
      op, op_rows(nb, OPL), nb, nchunk, opc, ys, ystride,
      [](int k0) { return k0; },
      [&](int c, int fl, int gh) {
        if (nchunk > 1 && fl < nf) {  // this chunk's sums leave
#pragma unroll
          for (int i = 0; i < GPW; ++i) {
            const int g = warp + WARPS * (gh + LPF * i);
            if (g >= NG) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int o = NOP * c + 4 * g + q;
              wrows[(size_t)fl * wstride + o] =
                  o < nmel ? logf(fmaxf(acc[i][q], power_floor)) : acc[i][q];
            }
          }
        }
      },
      acc);
  __syncthreads();  // every lane is done with ys: it takes the sums
  if (nchunk > 1) {
    rfft::frame_outputs<NOP, NTH>(wrows, dct, ceps, r, f0, nf, nmel, nac,
                                  nceps, wstride);
    return;
  }
  const int fl = lane % FT, gh = lane / FT;
  float* sums = ys;  // [FT][NOP]: log-mel | autocorrelation
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int g = warp + WARPS * (gh + LPF * i);
    if (g >= NG) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = 4 * g + q;
      sums[fl * NOP + o] =
          o < nmel ? logf(fmaxf(acc[i][q], power_floor)) : acc[i][q];
    }
  }
  __syncthreads();
  rfft::frame_outputs<NOP, NTH>(sums, dct, ceps, r, f0, nf, nmel, nac,
                                nceps);
}

template <class F>
cudaError_t with_m(int m, F&& f) {
  switch (m) {
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 2048: return f(std::integral_constant<int, 2048>{});
    case 4096: return f(std::integral_constant<int, 4096>{});
    case 8192: return f(std::integral_constant<int, 8192>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace chirp
}  // namespace

// The packed operator the chirp-z route takes: the layout of
// srt_fft_operator_shape (csrc/frontend_fft.cu), rows 0..nfft/2 padded to
// the operator chunk of this kernel (M <= 8192) or of the four-step
// route's fused pass, which projects past it (csrc/
// frontend_chirp_cluster.cu); -1 where the route does not take (nfft,
// flen).
extern "C" int srt_chirp_operator_shape(int nfft, int flen, int nout,
                                        int* rows, int* cols, int* chunks) {
  const int m = srt_cluster::chirp_m(nfft, flen);
  if (m == 0 || nout < 1) return -1;
  const int opl = rfft::opl_of(nout), nb = nfft / 2 + 1;
  *chunks = rfft::out_chunks(nout);
  *rows = (m <= srt_cluster::CHIRP_TILE_M ? chirp::op_rows(nb, opl)
                                          : rfft_big::op_rows(nb, opl)) *
          *chunks;
  *cols = rfft::nop(opl);
  return 0;
}

// frames [n, flen] windowed and pre-emphasized; cz [min(flen, nfft)] and
// bh [M = chirp_m(nfft, flen)] the chirp and the convolution's kernel
// (float2; ops/gpu_frontend.chirp_tables); op the packed [mel | acorr]
// operator of srt_chirp_operator_shape; dct [nmel, nceps]; wsums the
// srt_fft_wide_floats(n, nmel + nac) floats past 512 outputs; writes ceps
// [n, nceps] and r [n, nac].
extern "C" int srt_chirp_frames_frontend(
    const void* frames, const void* cz, const void* bh, const void* op,
    const void* dct, void* ceps, void* r, void* wsums, int n, int flen,
    int nfft, int nmel, int nac, int nceps, float power_floor,
    void* stream) {
  const int m = chirp::chirp_m(nfft, flen), nout = nmel + nac;
  if (n < 1 || m == 0 || nout < 1) return (int)cudaErrorInvalidValue;
  const int opl = rfft::opl_of(nout), nb = nfft / 2 + 1;
  const bool wide = chirp::wide_chunks(m, opl, nb);
  const int smem = 4 * chirp::smem_floats(
      m, opl, nb, (wide ? 2 : 1) * chirp::ck(opl));
  if (smem > chirp::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int nchunk = rfft::out_chunks(nout);
  const auto go = [&](auto kernel, int ft) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(n + ft - 1) / ft, 32 * chirp::warps(m), smem,
             (cudaStream_t)stream>>>(
        (const float*)frames, (const float2*)cz, (const float2*)bh,
        (const float4*)op, (const float*)dct, (float*)ceps, (float*)r, n,
        flen, nfft, nmel, nac, nceps, power_floor, nchunk, (float*)wsums);
    return cudaGetLastError();
  };
  return (int)chirp::with_m(m, [&](auto mc) {
    return rfft::with_opl(opl, [&](auto oc) {
      constexpr int M = decltype(mc)::value, OPL = decltype(oc)::value;
      constexpr int CK = chirp::ck(OPL);
      if constexpr (M <= 2048) {
        if (wide)
          return go(chirp::chirp_frames_kernel<M, OPL, 2 * CK>, chirp::ft(M));
      }
      return go(chirp::chirp_frames_kernel<M, OPL, CK>, chirp::ft(M));
    });
  });
}
