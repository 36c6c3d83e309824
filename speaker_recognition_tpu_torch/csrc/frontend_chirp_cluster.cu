// K5's chirp-z route past M = 8192, for Hopper (sm_90a), plain C
// interface: on the cluster FFT (csrc/rfft_cluster.cuh) up to M = 131072,
// on the device-memory passes of csrc/rfft_passes.cuh past it.
//
// Replaces speaker_recognition_tpu/ops/pallas_frontend.py:_run
// (mfcc_from_frames) at an fft_size N that is not a power of two whose
// chirp-z convolution takes M = 16384 .. 2^23 points (chirp_m: fft_size
// 16000 at 8 kHz on the cluster, 261634 at 8 kHz on the passes, any
// non-power-of-two fft_size up to about 2 M - 2 flen), where the tile
// kernel of csrc/frontend_chirp.cu (M <= 8192) does not reach: the same
// function (power = max(|DFT_N(x)|^2, floor) per bin 0..N/2, then ceps =
// log(max(power . mel, floor)) . dct and r = power . acorr) from the same
// tables (ops/gpu_frontend.chirp_tables: c [L] and Bh [M], Bh in the
// route's order, chirp_cluster_bh). Past M = 2^23 the dense template of
// csrc/frontend_frames.cu serves (its own counter). ops/gpu_frontend counts
// this route in FULL_CHIRP_LAUNCHES, as the tile kernel, and the passes in
// BIG_PASSES_LAUNCHES as well.
//
// On the cluster (M <= 131072), per frame, a cluster of C = M / 16384
// blocks, everything in place in each block's 16384 slots (one buffer):
//   1. a_n = x_n c_n (n < L = min(flen, N), the samples past N folded onto
//      n), zero past L: at C = 1 the first pass loads them (pruned at L);
//      else unit n1 takes the C-point DFT of a[n1 + P n2], times W_M^(n1
//      m2), into slot n1 of rank m2 (decimation in frequency across the
//      cluster);
//   2. each rank's P-point FFT: A[C m1 + m2] at slot m1 of rank m2;
//   3. times Bh, conjugated, in place (Bh in the same decimated order:
//      Bh[C m1 + m2] at [m2][m1]);
//   4. each rank's P-point FFT again (the inverse as conj(FFT(conj(.))) /
//      M: the 1 / M is in Bh); slot k1 of rank c holds U_c[k1];
//   5. unit k1 reads slot k1 of every rank, times W_M^(c k1), a C-point
//      DFT: y[k1 + P k2], and the power |y_k|^2 (|X_k| = |c_k y_k| = |y_k|)
//      of the bins k < N/2 + 1, floored, into the frame's power row in
//      device memory (whole sectors).
// On the passes (M = M1 M2 >= 262144), per group of frames, over a matrix
// [M1][M2] a frame in device memory (csrc/rfft_passes.cuh):
//   1. the column pass over a_j (j = M2 n1 + d, the loader multiplies by
//      c): the M1-point FFTs, times W_M^(d k1), into [k1][d]; a short
//      frame's (L <= M2: fft_size 261634 at 8 kHz) columns hold one value
//      each, and the row pass loads them straight from the frame instead;
//   2. the row pass: each row's M2-point FFT leaves A[k1 + M1 k2] at
//      [k1][k2]; times Bh[k1 + M1 k2] (Bh as [M1][M2]), conjugated, which
//      is w[a + M1 b] at [a][b]; the second forward transform's M2-point
//      FFTs over b, times W_M^(a d), in place;
//   3. the column pass over a: y[d + M2 c], and the power of the bins
//      below N/2 + 1, floored, into the frame's power row.
// Either way the four-step route's fused projection pass follows
// (csrc/rfft_big.cuh, rfft::project_bins, 8 frames a block, split over the
// bins where the frames are few) and its epilogue (log, DCT). The stages
// are two forward FFTs of M points: the second is the inverse as
// conj(FFT(conj(.))), with 1 / M in Bh. Every sum runs in a fixed order
// and there are no atomics, so two calls give the same bits.
//
// What bounds it on this card: the least work is FLOPs (a real FFT of N
// points, two per nonzero of the operators) or the frames' bytes; the route
// does two complex FFTs of M points a frame in shared memory (the passes
// and their barriers set its pace, as on the four-step route), on the
// passes with three trips of a frame's M float2 through device memory
// (L2-resident in groups), and moves a power row of N/2 + 1 floats. What
// it replaces, the dense template, reads C and S [flen][N/2 + 1] for every
// block of 64 frames: 2 flen (N/2 + 1) FMAs a frame and matrix (51 ms at
// fft_size 261634 on 622 frames, PERF.md).

#include <cuda_runtime.h>

#include "rfft_big.cuh"
#include "rfft_cluster.cuh"
#include "rfft_passes.cuh"

namespace {

using srt_cluster::NTH;
using srt_cluster::P;

// Cluster i takes frame f0 + i of frames [.][flen] (steps 1-5 above) and
// writes its power row i of pw [.][pstride]. bh: [C][P] float2, decimated.
template <int C>
__global__ void __launch_bounds__(NTH, 1) chirp_cluster_kernel(
    const float* __restrict__ frames, const float2* __restrict__ cz,
    const float2* __restrict__ bh, float* __restrict__ pw, int pstride,
    int f0, int flen, int nfft, int lgm, float power_floor) {
  extern __shared__ float2 cl_smem[];
  float2* v = cl_smem;
  const int fl = blockIdx.x / C, rank = cfft::rank<C>();
  const int tid = threadIdx.x;
  const cfft::Twiddles tw =
      cfft::twiddles(cl_smem + srt_cluster::SLOTS, lgm);
  const int L = min(flen, nfft), nb = nfft / 2 + 1;
  const float* x = frames + (size_t)(f0 + fl) * flen;
  const auto a = [&](int j) {  // j < L
    float s = x[j];
    for (int t = j + nfft; t < flen; t += nfft) s += x[t];
    const float2 c = __ldg(cz + j);
    return make_float2(s * c.x, s * c.y);
  };
  float2* rv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) rv[c] = cfft::rank_slots<C>(v, c);
  // 1.-2. the forward FFT
  if constexpr (C == 1) {
    cfft::first_pass(v, L, a);  // its barrier publishes the twiddles
    cfft::later_passes(v, tw, C);
  } else {
    cfft::cluster_sync<C>();  // the twiddles; every rank has started
    for (int n1 = rank * NTH + tid; n1 < P; n1 += C * NTH) {
      float2 t[C];
#pragma unroll
      for (int n2 = 0; n2 < C; ++n2)
        t[n2] = n1 + P * n2 < L ? a(n1 + P * n2) : make_float2(0.f, 0.f);
      cfft::dft<C>(t);
      const int s = cfft::slot(n1);
#pragma unroll
      for (int m2 = 0; m2 < C; ++m2)
        rv[m2][s] = m2 == 0 ? t[0] : cfft::cmul(t[m2], tw(n1 * m2));
    }
    cfft::cluster_sync<C>();
    cfft::block_fft(v, tw, C);
  }
  // 3. times Bh, conjugated
  const float2* bhr = bh + (size_t)rank * P;
  for (int m1 = tid; m1 < P; m1 += NTH) {
    const int s = cfft::slot(m1);
    const float2 y = cfft::cmul(v[s], __ldg(bhr + m1));
    v[s] = make_float2(y.x, -y.y);
  }
  __syncthreads();
  // 4. the inverse
  cfft::block_fft(v, tw, C);
  cfft::cluster_sync<C>();
  // 5. across the cluster, and the power
  float* row = pw + (size_t)fl * pstride;
  for (int k1 = rank * NTH + tid; k1 < P; k1 += C * NTH) {
    const int s = cfft::slot(k1);
    float2 t[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      t[c] = c == 0 ? rv[0][s] : cfft::cmul(rv[c][s], tw(c * k1));
    cfft::dft<C>(t);
#pragma unroll
    for (int k2 = 0; k2 < C; ++k2) {
      const int k = k1 + P * k2;
      if (k < nb)
        row[k] = fmaxf(t[k2].x * t[k2].x + t[k2].y * t[k2].y, power_floor);
    }
  }
  cfft::cluster_sync<C>();  // no rank leaves while others read its slots
}

// The passes' part of the route for frames f0 .. f0 + nfc - 1 (steps 1-3
// above) at M = 2^lgm, a group of frames at a time through the matrices z,
// into power rows pw [nfc][pstride]. bhp: Bh as [M1][M2]. Where L <= M2 (a
// short frame) the row pass loads a = x c straight from the frames and
// the first column pass does not run.
cudaError_t chirp_passes(const float* frames, const float2* cz,
                         const float2* bhp, float2* z, float* pw, int pstride,
                         int f0, int nfc, int flen, int nfft, int lgm,
                         float power_floor, cudaStream_t st) {
  const int group = passes::group_frames(lgm), lg2 = passes::lg_t2(lgm);
  const int L = min(flen, nfft);
  const bool direct = L <= 1 << lg2;
  for (int g0 = 0; g0 < nfc; g0 += group) {
    const int ng = min(group, nfc - g0);
    const passes::ChirpIn in{frames, cz, f0 + g0, flen, nfft, L};
    cudaError_t err =
        direct ? cudaSuccess
               : passes::columns(in, passes::TwiddledOut{z, lgm}, ng, lgm,
                                 st);
    if (err != cudaSuccess) return err;
    err = passes::with_lg(lg2, [&](auto c) {
      constexpr int LG2 = decltype(c)::value;
      return passes::launch(passes::chirp_rows_kernel<LG2>,
                            (1 << (lgm - LG2)) / (P >> LG2), ng, lgm, st, in,
                            z, bhp, lgm, direct ? 1 : 0);
    });
    if (err != cudaSuccess) return err;
    err = passes::columns(
        passes::MatrixIn{z, lgm},
        passes::ChirpPowerOut{pw + (size_t)g0 * pstride, pstride, lgm,
                              nfft / 2 + 1, power_floor},
        ng, lgm, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// floats of the passes' matrices for a chunk of nfc frames at M = 2^lgm
// (none on the cluster)
inline long long chirp_matrix_floats(int lgm, int nfc) {
  if ((1 << lgm) <= srt_cluster::CHIRP_CLUSTER_M) return 0;
  const int g = passes::group_frames(lgm);
  return (long long)(nfc < g ? nfc : g) << (lgm + 1);
}

}  // namespace

// Floats of scratch the chirp-z route past M = 8192 takes for chunks of
// `chunk` frames with nout outputs: the passes' matrices (past M =
// 131072), power rows, sums rows and the split's partials; -1 where it
// does not take (nfft, flen) (M past 2^23, or at most 8192: the tile
// kernel's).
extern "C" long long srt_chirp_scratch_floats(int nfft, int flen, int nout,
                                              int chunk) {
  const int m = srt_cluster::chirp_m(nfft, flen), nb = nfft / 2 + 1;
  if (m <= srt_cluster::CHIRP_TILE_M || chunk < 1 || nout < 1) return -1;
  return chirp_matrix_floats(srt_cluster::ilog2(m), chunk) +
         (long long)chunk * (rfft_big::power_stride(nb) + nout) +
         rfft_big::partial_floats(chunk, nb, nout);
}

// frames [n, flen] windowed and pre-emphasized; cz [min(flen, nfft)] and
// bh [M = chirp_m(nfft, flen)] float2 in the route's order (the cluster's
// decimated [M / 16384][16384], Bh[C m1 + m2] at [m2][m1], up to M =
// 131072; [M1][M2], Bh[k1 + M1 k2] at [k1][k2], past it); op the packed
// [mel | acorr] operator of srt_chirp_operator_shape; dct [nmel, nceps];
// scratch of srt_chirp_scratch_floats(nfft, flen, nmel + nac, chunk) for
// chunks of `chunk` frames; writes ceps [n, nceps] and r [n, nac].
extern "C" int srt_chirp_cluster_frontend(
    const void* frames, const void* cz, const void* bh, const void* op,
    const void* dct, void* ceps, void* r, void* scratch, int n, int flen,
    int nfft, int nmel, int nac, int nceps, float power_floor, int chunk,
    void* stream) {
  const int m = srt_cluster::chirp_m(nfft, flen), nout = nmel + nac;
  if (n < 1 || m <= srt_cluster::CHIRP_TILE_M || nout < 1 || chunk < 1 ||
      chunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int lgm = srt_cluster::ilog2(m), nb = nfft / 2 + 1;
  const int ps = rfft_big::power_stride(nb);
  for (int f0 = 0; f0 < n; f0 += chunk) {
    const int nfc = min(chunk, n - f0);
    float2* z = (float2*)scratch;
    float* pw = (float*)scratch + chirp_matrix_floats(lgm, nfc);
    float* sums = pw + (size_t)nfc * ps;
    cudaError_t err;
    if (m <= srt_cluster::CHIRP_CLUSTER_M) {
      err = cfft::with_ranks(m / P, [&](auto rc) {
        constexpr int C = decltype(rc)::value;
        return cfft::launch<C>(chirp_cluster_kernel<C>, nfc,
                               srt_cluster::smem_bytes(lgm), st,
                               (const float*)frames, (const float2*)cz,
                               (const float2*)bh, pw, ps, f0, flen, nfft,
                               lgm, power_floor);
      });
    } else {
      err = chirp_passes((const float*)frames, (const float2*)cz,
                         (const float2*)bh, z, pw, ps, f0, nfc, flen, nfft,
                         lgm, power_floor, st);
    }
    if (err != cudaSuccess) return (int)err;
    err = srt_cluster::project_rows(nfc, pw, ps, nb, (const float4*)op, sums,
                                    sums + (size_t)nfc * nout, nmel, nac,
                                    power_floor, st);
    if (err != cudaSuccess) return (int)err;
    rfft_big::outputs_kernel<<<(nfc + 7) / 8, 128, 0, st>>>(
        sums, (const float*)dct, (float*)ceps, (float*)r, f0, nfc, nmel, nac,
        nceps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
