// The four-step FFT over device memory past the cluster's reach, for
// Hopper (sm_90a): K5's real input at N = 524288 .. 2^24 points (and K1,
// K4, the monolith K6 there; csrc/rfft_cluster.cu) and K5's chirp-z route
// at M = 262144 .. 2^23 (csrc/frontend_chirp_cluster.cu). A transform of T
// = 2^lgt complex points (T = N/2, or M) is a matrix [T1][T2] in a frame's
// scratch, T1 = 2^(lgt - lgt/2) >= T2 = 2^(lgt/2), both 512 .. 4096:
//   * a column pass (column_kernel): a block takes G = 16384 / T1 adjacent
//     columns d of one frame (G >= 4), so its loads of value (n1, d) and
//     its stores of [k1][d] move G adjacent float2 (whole 32-byte
//     sectors); it takes each column's T1-point FFT over n1 and hands value
//     k1 of column d to the caller's store (times W_T^(d k1) into [k1][d],
//     or a power bin);
//   * a row pass: a block takes G = 16384 / T2 rows (whole, contiguous)
//     and each one's T2-point FFT; K5's real input pairs rows k1 and T1 -
//     k1 in one block, so Z[k] and Z[H - k] meet there and the frame leaves
//     as its power row (power_rows_kernel); the chirp multiplies by Bh,
//     conjugates, and takes the second transform's row FFT and twiddles in
//     the same block (chirp_rows_kernel).
// The sub-FFTs are the cluster code's (csrc/rfft_cluster.cuh): Stockham
// passes of radix 8 in place (8, 8, 8, then 8, 4 or 2 for what is left of
// 2^9 .. 2^12 points), each thread's butterflies in registers between two
// barriers, the radix-8 DFT with constant twiddles, and the other twiddles
// from the block's two-level table of W_T (cfft::twiddles: sincospif of
// exact angles, no sincospif per butterfly, no fast intrinsic). A block
// holds 16384 values of G transforms (128 KB, one float2 of padding after
// every 16 and a few after each transform, so that the strided accesses of
// both the passes and the column loads fall in distinct banks) and the
// table (up to 48 KB): one 512-thread block an SM.
//
// A column whose values past row 0 all lie beyond the frame's samples (a
// short frame in a long transform: 256 samples in 262144 points) needs no
// FFT: its transform is value 0 in every row, and a block of such columns
// skips its passes. Where that holds for every column (the frame's values
// all in the first T2), the column pass does not run at all: the row pass
// loads each value times its twiddle straight from the frame. Frames go through the passes in groups whose matrices
// (PASSES_L2_BYTES) stay in the 50 MB L2 between the two passes; the power
// rows of a whole chunk of frames wait in device memory for the fused
// projection pass (csrc/rfft_big.cuh), which keeps its parallelism.
// Every sum runs in a fixed order with no atomics, so two calls give the
// same bits. tests/test_torch_passes_fft.py models every index of this data
// flow in float64 numpy and holds it to numpy.fft.
//
// What bounds it on this card: the frames' bytes and the FFT's FLOPs are
// far below what it moves; each pass reads and writes a frame's T float2
// once (the column pass of a short frame writes only), and the block's
// passes over its 128 KB of shared memory (loads, stores, barriers) set
// its pace between them, as on the cluster route.

#pragma once

#include <cuda_runtime.h>

#include "rfft_cluster.cuh"

namespace {
namespace passes {

using srt_cluster::NTH;
using srt_cluster::P;
constexpr int LGP = srt_cluster::LGP;

// the transforms the passes take: T = 2^lgt points, lgt in [MIN_LGT,
// MAX_LGT], as [T1][T2]
constexpr int MIN_LGT = 18, MAX_LGT = 23;
__host__ __device__ constexpr int lg_t1(int lgt) { return lgt - lgt / 2; }
__host__ __device__ constexpr int lg_t2(int lgt) { return lgt / 2; }

// frames a group of the passes: as many matrices of T float2 as
// PASSES_L2_BYTES hold (at least one)
constexpr long long PASSES_L2_BYTES = 32ll << 20;
inline int group_frames(int lgt) {
  const long long g = PASSES_L2_BYTES >> (lgt + 3);
  return g < 1 ? 1 : (int)g;
}

// A block's slots: P values of G = P / L transforms of L = 2^LG points,
// one float2 of padding after every 16 values and PAD after each transform
// (PAD = 16 / G in a column pass, 32 / G in a row pass, at least 1: the
// stride between transforms then spreads a half-warp's accesses over the
// banks where its threads walk the transforms, as in the column loads and
// the power rows' units).
__host__ __device__ constexpr int pad_col(int lg) {
  return (1 << lg) >> 10 > 1 ? (1 << lg) >> 10 : 1;
}
__host__ __device__ constexpr int pad_row(int lg) {
  return (1 << lg) >> 9 > 1 ? (1 << lg) >> 9 : 1;
}
constexpr int SLOTS = P + P / 16 + 32;

template <int LG, int PAD>
__device__ __forceinline__ int slot(int i) {
  return i + (i >> 4) + (i >> LG) * PAD;
}

// bytes of a block's shared memory: the slots and the table of W_T
__host__ __device__ constexpr int smem_bytes(int lgt) {
  return 8 * (SLOTS + srt_cluster::tw_count(lgt));
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// threadIdx.x, opaque to the compiler: a kernel that runs two FFTs takes a
// fresh one for each, so that the second does not keep the first's
// slot addresses and twiddles (all functions of threadIdx.x) live in
// registers across the pointwise product, which spilled ~1 KB a thread
__device__ __forceinline__ int opaque_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// A Stockham pass of radix R over the block's G = P / 2^LG transforms of
// 2^LG values, in place, after NS points of each sub-transform are done
// (cfft::pass, for many transforms): thread t's butterfly j = t + NTH i of transform
// g = j / S (S = 2^LG / R) loads values jj + S r (jj = j mod S) into
// registers before the barrier, multiplies them by W_{NS R}^(k r) = W_T^(k
// r T / (NS R)), k = jj mod NS (= j mod NS, since NS divides S: one lookup
// a thread where NS divides NTH), and stores their DFT at (jj - k) R + k +
// q NS of its transform. Ends on a barrier.
template <int LG, int PAD, int R, int NS>
__device__ __forceinline__ void pass(float2* v, const cfft::Twiddles& tw,
                                     int lgt, int t) {
  constexpr int L = 1 << LG, S = L / R, B = P / R / NTH;
  constexpr int LGNR = ilog2(NS * R);
  float2 x[B][R];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int j = t + NTH * i;
    const int base = (j / S) * L + (j & (S - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) x[i][r] = v[slot<LG, PAD>(base + S * r)];
  }
  __syncthreads();
  float2 w[R];
  const auto twiddles_of = [&](int k) {
    const int e = k << (lgt - LGNR);  // the exponent at r = 1
#pragma unroll
    for (int r = 1; r < R; ++r) w[r] = tw(e * r);
  };
  if constexpr (NS > 1 && NTH % NS == 0) twiddles_of(t % NS);
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int j = t + NTH * i, k = j & (NS - 1);
    const int jj = j & (S - 1);
    if constexpr (NS > 1) {
      if constexpr (NTH % NS != 0) twiddles_of(k);
#pragma unroll
      for (int r = 1; r < R; ++r) x[i][r] = cfft::cmul(x[i][r], w[r]);
    }
    cfft::dft<R>(x[i]);
    const int base = (j / S) * L + (jj - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) v[slot<LG, PAD>(base + q * NS)] = x[i][q];
  }
  __syncthreads();
}

// The 2^LG-point FFTs of the block's G transforms, in place, natural order
// in and out, by thread t (threadIdx.x): radix 8 at NS = 1, 8, 64, then 8,
// 4 or 2 at 512. Starts with its loads (the caller's barrier publishes the
// values), ends on a barrier.
template <int LG, int PAD>
__device__ __forceinline__ void ffts(float2* v, const cfft::Twiddles& tw,
                                     int lgt, int t = threadIdx.x) {
  static_assert(LG >= 9 && LG <= 12, "a sub-FFT of 512 .. 4096 points");
  pass<LG, PAD, 8, 1>(v, tw, lgt, t);
  pass<LG, PAD, 8, 8>(v, tw, lgt, t);
  pass<LG, PAD, 8, 64>(v, tw, lgt, t);
  if constexpr (LG == 12) pass<LG, PAD, 8, 512>(v, tw, lgt, t);
  if constexpr (LG == 11) pass<LG, PAD, 4, 512>(v, tw, lgt, t);
  if constexpr (LG == 10) pass<LG, PAD, 2, 512>(v, tw, lgt, t);
}

// The column pass. Block (x, frame fl of the group) takes the G = P / T1
// columns d0 .. d0 + G - 1 (d0 = G x) of the frame's [T1][T2] matrix:
// value (n1, d) = in.load(fl, T2 n1 + d) for the rows n1 < E that may be
// nonzero (E = ceil((in.count() - d0) / T2): the values past in.count()
// are zero), the T1-point FFT over n1 of each column, then out.store(fl,
// k1, d, value, tw) for every k1. Consecutive threads take consecutive
// columns.
template <int LG1, class In, class Out>
__global__ void __launch_bounds__(NTH, 1) column_kernel(const In in,
                                                        const Out out,
                                                        int lgt) {
  extern __shared__ float2 pass_smem[];
  float2* v = pass_smem;
  constexpr int T1 = 1 << LG1, G = P >> LG1, LGG = LGP - LG1;
  constexpr int PAD = pad_col(LG1);
  const int fl = blockIdx.y;
  if (!in.live(fl)) return;  // block-uniform
  const int T2 = 1 << (lgt - LG1), d0 = G * blockIdx.x;
  const cfft::Twiddles tw = cfft::twiddles(v + SLOTS, lgt);
  const int J = in.count(), e = J > d0 ? (J - d0 + T2 - 1) / T2 : 0;
  const int E = e < T1 ? e : T1;
  for (int i = threadIdx.x; i < (E > 1 ? P : G); i += NTH) {
    const int g = i & (G - 1), n1 = i >> LGG;
    v[slot<LG1, PAD>(g * T1 + n1)] =
        n1 < E ? in.load(fl, T2 * n1 + d0 + g) : make_float2(0.f, 0.f);
  }
  __syncthreads();  // the values and the table
  if (E > 1) ffts<LG1, PAD>(v, tw, lgt);
  for (int i = threadIdx.x; i < P; i += NTH) {
    const int g = i & (G - 1), k1 = i >> LGG;
    // at most row 0 nonzero: every row of its transform is value 0
    out.store(fl, k1, d0 + g, v[slot<LG1, PAD>(g * T1 + (E > 1 ? k1 : 0))],
              tw);
  }
}

// The column pass's inputs and outputs.

// K5's real input (and K1's, K4's, K6's): z[j] = x[2j] + i x[2j+1] of frame
// f0 + fl from the frame loader; zero past the frame's ceil(min(flen, N) /
// 2) values
struct RealIn {
  srt_cluster::FrameSource src;
  int f0;
  __device__ __forceinline__ bool live(int fl) const {
    return src.live(f0 + fl);
  }
  __host__ __device__ int count() const { return (src.extent() + 1) / 2; }
  __device__ __forceinline__ float2 load(int fl, int j) const {
    return make_float2(src.sample(f0 + fl, 2 * j),
                       src.sample(f0 + fl, 2 * j + 1));
  }
};

// the chirp's a_j = x_j c_j (j < L = min(flen, N), the samples past N
// folded onto j) of frames [.][flen] from frame f0 + fl; zero past L
struct ChirpIn {
  const float* x;
  const float2* cz;
  int f0, flen, nfft, L;
  __device__ __forceinline__ bool live(int) const { return true; }
  __host__ __device__ int count() const { return L; }
  __device__ __forceinline__ float2 load(int fl, int j) const {
    if (j >= L) return make_float2(0.f, 0.f);
    const float* r = x + (size_t)(f0 + fl) * flen;
    float s = r[j];
    for (int t = j + nfft; t < flen; t += nfft) s += r[t];
    const float2 c = __ldg(cz + j);
    return make_float2(s * c.x, s * c.y);
  }
};

// value j of the group's matrices z [.][T] (every row)
struct MatrixIn {
  const float2* z;
  int lgt;
  __device__ __forceinline__ bool live(int) const { return true; }
  __host__ __device__ int count() const { return 1 << lgt; }
  __device__ __forceinline__ float2 load(int fl, int j) const {
    return z[((size_t)fl << lgt) + j];
  }
};

// value k1 of column d, times W_T^(d k1), at [k1][d] of the frame's matrix
struct TwiddledOut {
  float2* z;
  int lgt;
  __device__ __forceinline__ void store(int fl, int k1, int d, float2 x,
                                        const cfft::Twiddles& tw) const {
    const int lg2 = lg_t2(lgt);
    z[((size_t)fl << lgt) + ((size_t)k1 << lg2) + d] =
        cfft::cmul(x, tw(d * k1));
  }
};

// the chirp's y[d + T2 c] (value c of column d) as the power max(|y|^2,
// floor) of bin d + T2 c < nb, into the frame's power row
struct ChirpPowerOut {
  float* pw;
  int pstride, lgt, nb;
  float power_floor;
  __device__ __forceinline__ void store(int fl, int c, int d, float2 y,
                                        const cfft::Twiddles&) const {
    const int k = d + (c << lg_t2(lgt));
    if (k < nb)
      pw[(size_t)fl * pstride + k] =
          fmaxf(y.x * y.x + y.y * y.y, power_floor);
  }
};

// Loads rows row_of(gi) (gi < G = P / T2) of the frame's matrix [T1][T2]
// into the block's transforms, consecutive threads on consecutive values:
// from z, or, where the frame's values all lie in the first T2 (in.count()
// <= T2: a short frame, whose column pass would only broadcast row 0),
// straight from the frame as the column pass would have stored them, value
// n of row k1 = in.load(fl, n) W_T^(n k1) (the same arithmetic, so the same
// bits; no column pass runs). Ends on a barrier (which also publishes the
// table, as one before the direct loads does).
template <int LG2, int PAD, class In, class RowOf>
__device__ __forceinline__ void load_rows(float2* v, const In& in, int fl,
                                          const float2* z, bool direct,
                                          const cfft::Twiddles& tw,
                                          const RowOf& row_of) {
  constexpr int T2 = 1 << LG2;
  if (direct) {
    __syncthreads();  // the table
    const int J = in.count();
    for (int i = threadIdx.x; i < P; i += NTH) {
      const int k1 = row_of(i >> LG2), n = i & (T2 - 1);
      v[slot<LG2, PAD>(i)] = n < J ? cfft::cmul(in.load(fl, n), tw(n * k1))
                                   : make_float2(0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < P; i += NTH)
      v[slot<LG2, PAD>(i)] =
          z[((size_t)row_of(i >> LG2) << LG2) + (i & (T2 - 1))];
  }
  __syncthreads();
}

// K5's rows (the real input, T = H = N/2). Block (x, frame fl) takes the U
// = G/2 units u = U x + gi (gi < U) of rows u and T1 - u (row T1/2 in the
// place of row T1 - 0 in block 0): their T2-point FFTs leave Z[k1 + T1 k2]
// at k2 of row k1, so Z[k] and Z[H - k] (H - k = T1 - u + T1 (T2 - 1 - k2)
// for k = u + T1 k2) are both in the block, and it writes the power
// |X[k]|^2 of the N-point real input (the post-step of the cluster route)
// of bins u + T1 k2 and T1 - u + T1 k2 (row 0: bins T1 k2 and H; row
// T1/2: bins T1/2 + T1 k2) into the frame's power row, floored per bin
// when asked. Consecutive threads take consecutive units: bins in runs of
// U floats.
template <int LG2>
__global__ void __launch_bounds__(NTH, 1) power_rows_kernel(
    const RealIn in, const float2* __restrict__ z, float* __restrict__ pw,
    int pstride, int lgt, float power_floor, int per_bin_floor, int direct) {
  extern __shared__ float2 pass_smem[];
  float2* v = pass_smem;
  constexpr int T2 = 1 << LG2, G = P >> LG2, U = G / 2, LGU = ilog2(U);
  constexpr int PAD = pad_row(LG2);
  const int fl = blockIdx.y;
  if (!in.live(fl)) return;  // block-uniform
  const int T1 = 1 << (lgt - LG2), H = 1 << lgt, u0 = U * blockIdx.x;
  const cfft::Twiddles tw = cfft::twiddles(v + SLOTS, lgt);
  load_rows<LG2, PAD>(v, in, fl, z + ((size_t)fl << lgt), direct, tw,
                      [&](int gi) {
                        const int u = u0 + (gi & (U - 1));
                        return gi < U ? u : u == 0 ? T1 / 2 : T1 - u;
                      });
  ffts<LG2, PAD>(v, tw, lgt);
  float* row = pw + (size_t)fl * pstride;
  const auto store = [&](int k, float p) {
    row[k] = per_bin_floor ? fmaxf(p, power_floor) : p;
  };
  // |X[k]|^2 from Z[k] = a and Z[H - k] = b
  const auto post = [&](int k, float2 a, float2 b) {
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    float s, cs;
    sincospif((float)k / (float)H, &s, &cs);  // W_N^k
    const float2 wo = cfft::cmul(make_float2(cs, -s), o);
    const float xr = e.x + wo.x, xi = e.y + wo.y;
    store(k, xr * xr + xi * xi);
  };
  for (int i = threadIdx.x; i < U * T2; i += NTH) {
    const int gi = i & (U - 1), k2 = i >> LGU, u = u0 + gi;
    const auto lo = [&](int k) { return v[slot<LG2, PAD>(gi * T2 + k)]; };
    const auto hi = [&](int k) {
      return v[slot<LG2, PAD>((gi + U) * T2 + k)];
    };
    if (u == 0) {  // rows 0 and T1/2, each its own partner
      if (k2 == 0) {
        const float2 a = lo(0);
        const float e0 = a.x + a.y, eh = a.x - a.y;
        store(0, e0 * e0);
        store(H, eh * eh);
      } else {
        post(T1 * k2, lo(k2), lo(T2 - k2));
      }
      post(T1 / 2 + T1 * k2, hi(k2), hi(T2 - 1 - k2));
    } else {
      post(u + T1 * k2, lo(k2), hi(T2 - 1 - k2));
      post(T1 - u + T1 * k2, hi(k2), lo(T2 - 1 - k2));
    }
  }
}

// The chirp's rows (T = M). Block (x, frame fl) takes the G = P / T2 rows
// r0 .. r0 + G - 1 (r0 = G x) of the frame's matrix after the first column
// pass (or straight from the frame: load_rows): their T2-point FFTs leave
// A[k1 + T1 k2] at k2 of row k1; times Bh[k1 + T1 k2] (bhp [T1][T2]: Bh in
// this order), conjugated, which is w[a + T1 b] at b of row a; the second
// transform's T2-point FFTs over b, times W_M^(a d), stored at [a][d] for
// the last column pass. The two FFTs are one loop's two turns, each on a
// fresh opaque_tid().
template <int LG2>
__global__ void __launch_bounds__(NTH, 1) chirp_rows_kernel(
    const ChirpIn in, float2* __restrict__ z, const float2* __restrict__ bhp,
    int lgt, int direct) {
  extern __shared__ float2 pass_smem[];
  float2* v = pass_smem;
  constexpr int T2 = 1 << LG2, G = P >> LG2;
  constexpr int PAD = pad_row(LG2);
  const int r0 = G * blockIdx.x, fl = blockIdx.y;
  float2* zf = z + ((size_t)fl << lgt);
  float2* m = zf + ((size_t)r0 << LG2);  // the block's rows, contiguous
  const float2* b = bhp + ((size_t)r0 << LG2);
  const cfft::Twiddles tw = cfft::twiddles(v + SLOTS, lgt);
  load_rows<LG2, PAD>(v, in, fl, zf, direct, tw,
                      [&](int gi) { return r0 + gi; });
#pragma unroll 1
  for (int turn = 0;; ++turn) {
    ffts<LG2, PAD>(v, tw, lgt, opaque_tid());
    if (turn == 1) break;
    for (int i = threadIdx.x; i < P; i += NTH) {
      const int s = slot<LG2, PAD>(i);
      const float2 y = cfft::cmul(v[s], __ldg(b + i));
      v[s] = make_float2(y.x, -y.y);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < P; i += NTH)
    m[i] = cfft::cmul(v[slot<LG2, PAD>(i)],
                      tw((r0 + (i >> LG2)) * (i & (T2 - 1))));
}

// f(std::integral_constant<int, LG>{}) for the sub-FFT sizes 2^9 .. 2^12
template <class F>
cudaError_t with_lg(int lg, F&& f) {
  switch (lg) {
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
  }
  return cudaErrorInvalidValue;
}

// kernel on a grid (blocks, frames) of NTH threads and the passes' shared
// memory at lgt, on st
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int blocks, int frames, int lgt,
                   cudaStream_t st, Args... args) {
  const int smem = smem_bytes(lgt);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, frames), NTH, smem, st>>>(args...);
  return cudaGetLastError();
}

// The column pass over a group of `frames` matrices of T = 2^lgt points.
template <class In, class Out>
cudaError_t columns(const In& in, const Out& out, int frames, int lgt,
                    cudaStream_t st) {
  return with_lg(lg_t1(lgt), [&](auto c) {
    constexpr int LG1 = decltype(c)::value;
    return launch(column_kernel<LG1, In, Out>,
                  (1 << lg_t2(lgt)) / (P >> LG1), frames, lgt, st, in, out,
                  lgt);
  });
}

}  // namespace passes
}  // namespace
