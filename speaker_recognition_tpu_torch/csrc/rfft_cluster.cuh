// A frame's spectrum on chip: the cluster FFT that the four-step route's
// frontends (K1, K4, K5 and the monolith K6 at N = 32768 .. 262144 points,
// csrc/rfft_big.cuh) and K5's chirp-z route at M = 16384 .. 131072 (csrc/
// frontend_chirp_cluster.cu) run on. Past this reach the column and row
// passes of csrc/rfft_passes.cuh over a scratch in device memory serve,
// on the same Stockham passes and twiddle table.
//
// One block holds P = 16384 complex values (128 KB, with one float2 of
// padding after every 16: slot(i)) and a two-level twiddle table; a
// thread-block cluster of C = 1, 2, 4 or 8 such blocks holds an M = C P
// point FFT (M = H = N/2 on the four-step route, the convolution's M on the
// chirp). Inside a block: Stockham passes of radix 8, 8, 8, 8, 4 in place,
// 512 threads, each thread's butterflies loaded into registers before a
// barrier and stored after it, a radix-8 DFT in registers with constant
// twiddles: five passes, ten barriers, where a radix-2 FFT takes fourteen
// stages. Across the cluster the transpose between the two steps is an
// exchange in distributed shared memory (cluster.map_shared_rank):
//   * decimation in time across the cluster (the four-step route's
//     spectrum, the chirp's inverse): rank c holds the P values c, C + c,
//     2C + c, ... and takes their P-point FFT Y_c; after the cluster's
//     barrier a unit k1 reads slot k1 of every rank, multiplies value c by
//     W_M^(c k1) and takes a C-point DFT: X[k1 + P k2], k2 < C;
//   * decimation in frequency across the cluster (the chirp's forward
//     FFT): a unit n1 takes the C-point DFT of the values n1 + P n2,
//     multiplies output m2 by W_M^(n1 m2) and stores it at slot n1 of rank
//     m2, whose P-point FFT then leaves A[C m1 + m2] at slot m1.
// Nothing of a frame goes to device memory between its samples and its
// power: the four-step route stores the power row |X[k]|^2 (the real-input
// post-step from Z[k] and Z[H - k], both in one unit's two columns u and P
// - u) and the chirp its |y_k|^2, once, in whole sectors; the fused
// projection pass of csrc/rfft_big.cuh (8 frames a block, which amortizes
// the operator; 8 frames' spectra would not fit on chip) reads them.
//
// The first pass is pruned: a frame of flen samples (after the fold) has
// ceil(min(flen, N) / 2) nonzero z values, so rank c's first pass loads
// only its E_c = ceil((J - c) / C) of them; a butterfly whose inputs all
// lie past E_c stores zeros and one with only its first input stores that
// value R times (no DFT). At 48 kHz (1,200 samples in 32,768 points) 600 of
// 16,384 values are loaded and 1,448 of 2,048 butterflies store zeros.
//
// Twiddles: W_M^m = hi[m >> b] lo[m & (2^b - 1)], b = ceil(lg M / 2), both
// tables built once per block from sincospif of exact angles (2 m / M is
// exact in f32); no sincospif per butterfly and no fast intrinsic. The
// post-step's W_N^k is one sincospif per bin, as on the device-memory
// route. Every sum runs in a fixed order with no atomics, so two calls give
// the same bits. tests/test_torch_cluster_fft.py models every index of this
// data flow in float64 numpy and holds it to numpy.fft.
//
// What bounds it on this card: the frames' bytes and the FFT's FLOPs are
// far below what the route moves; the block's five passes over 128 KB of
// shared memory (loads, stores and twiddle lookups) and their barriers set
// its pace, at one 512-thread block an SM (145 KB of shared memory a block).
// What the design does about it: a frame crosses device memory once as
// samples and once as a power row (64 KB at N = 32768; the device-memory
// passes moved ~0.9 MB a frame, with strided stores), the exchange across
// the cluster reads each value once, and the padding keeps the passes'
// strided stores in distinct banks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace srt_cluster {

constexpr int P = 16384;     // complex values a block
constexpr int LGP = 14;
constexpr int NTH = 512;     // threads a block
constexpr int MAX_RANKS = 8;  // the portable cluster size
constexpr int SLOTS = P + P / 16;
// the four-step route's reach: H = N/2 = C P
constexpr int MIN_N = 2 * P, MAX_N = 2 * P * MAX_RANKS;
// the chirp-z route: M from 1024; the tile kernel (csrc/frontend_chirp.cu)
// up to 8192, the cluster from 16384 to 131072, the device-memory passes
// of csrc/rfft_passes.cuh from 262144 to 2^23
constexpr int CHIRP_MIN_M = 1024, CHIRP_TILE_M = 8192;
constexpr int CHIRP_CLUSTER_M = P * MAX_RANKS;
constexpr int CHIRP_MAX_M = 1 << 23;

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// whether the cluster route takes an N-point four-step FFT
inline bool takes(int n) {
  return n >= MIN_N && n <= MAX_N && (n & (n - 1)) == 0;
}

// M of the chirp-z route for an N-point DFT of frames of flen samples: the
// least power of two, at least CHIRP_MIN_M, that holds the linear
// convolution of L = min(flen, N) and L + N/2 terms; 0 where the route
// does not take it (N a power of two, N < 2, or M past CHIRP_MAX_M; the
// dense template of csrc/frontend_frames.cu serves past it).
// ops/gpu_frontend.chirp_size is the same in Python.
inline int chirp_m(int n, int flen) {
  if (n < 2 || flen < 1 || (n & (n - 1)) == 0) return 0;
  const int l = flen < n ? flen : n;
  const long long need = (long long)l + n / 2;  // L + nb - 1
  long long m = CHIRP_MIN_M;
  while (m < need && m <= CHIRP_MAX_M) m *= 2;
  return m <= CHIRP_MAX_M ? (int)m : 0;
}

// float2 of the two-level twiddle table of W_M: lo [2^b], hi [M / 2^b]
__host__ __device__ constexpr int tw_count(int lgm) {
  return (1 << ((lgm + 1) / 2)) + (1 << (lgm - (lgm + 1) / 2));
}

// bytes of a block's shared memory for an M-point FFT: the slots and the
// table
__host__ __device__ constexpr int smem_bytes(int lgm) {
  return 8 * (SLOTS + tw_count(lgm));
}

// The frames of the four-step route's frontends, as the cluster route
// reads them: K5's rows (folded past N), K4's raw rows (windowed and
// pre-emphasized per sample, as the tile's WindowedRows) or the signal
// frontend's strided windows (K1, K6: as rfft::SignalFrames; frames at or
// past n_valid are not computed).
struct FrameSource {
  enum Kind : int { ROWS = 0, WINDOWED = 1, SIGNAL = 2 };
  int kind;
  const float* x;    // frames [.][flen] (ROWS, WINDOWED), signals [B][Lp]
  const float* win;  // [flen] (WINDOWED, SIGNAL)
  const int* nv;     // n_valid [B] (SIGNAL)
  int flen, n;       // n: the FFT's points (ROWS folds the samples past it)
  int Lp, T, fshift;  // SIGNAL
  float a;
  int preemph_first;

  __device__ __forceinline__ bool live(int g) const {
    return kind != SIGNAL || g % T < nv[g / T];
  }
  // samples of a frame that may be nonzero (after the fold): min(flen, n)
  __host__ __device__ int extent() const { return flen < n ? flen : n; }
  // frame g's loader: p -> sample p < n (the device-memory passes')
  __device__ __forceinline__ auto frame(int g) const {
    return [s = *this, g](int p) { return s.sample(g, p); };
  }
  // sample p < n of frame g
  __device__ __forceinline__ float sample(int g, int p) const {
    if (kind == ROWS) {
      const float* r = x + (size_t)g * flen;
      float s = p < flen ? r[p] : 0.f;
      for (int t = p + n; t < flen; t += n) s += r[t];
      return s;
    }
    const float* s;
    int avail = flen;
    if (kind == WINDOWED) {
      s = x + (size_t)g * flen;
    } else {
      const int b = g / T, t = g % T;
      s = x + (size_t)b * Lp + (size_t)t * fshift;
      avail = Lp - t * fshift;
    }
    const bool in = p < flen, prev = in && p > 0;
    const float xv = in && p < avail ? s[p] : 0.f;
    const float xm = prev && p - 1 < avail ? s[p - 1] : 0.f;
    const float w = in ? win[p] : 0.f;
    const float wm = prev ? win[p - 1] : 0.f;
    const float first = w * (p > 0 ? xv - a * xm : (1.f - a) * xv);
    const float later = w * xv - a * (wm * xm);
    return preemph_first ? first : later;
  }
};

// The four-step route's spectral stage for frames f0 .. f0 + nfc - 1 of
// src at an n-point FFT (csrc/rfft_cluster.cu): their power rows from the
// cluster where takes(n), past it from the column and row passes of
// csrc/rfft_passes.cuh; then the fused projection pass, whose sums rows
// [nfc][nmel + nac] land at rfft_big::sums_rows(scratch, n, nfc). scratch
// holds rfft_big::scratch_floats(n, nmel + nac, nfc) floats, op is the
// packed operator of srt_big_operator_shape.
cudaError_t spectra(FrameSource src, int f0, int nfc, int n, float* scratch,
                    const float4* op, int nmel, int nac, float power_floor,
                    bool per_bin_floor, cudaStream_t st);

// The fused projection pass on power rows pw [nfc][pstride] of bins
// 0..nbins - 1 (every frame computed; the chirp-z route past M = 8192):
// sums rows [nfc][nmel + nac] of log-mel | raw autocorrelation, with the
// split's partial rows (rfft_big::partial_floats(nfc, nbins, nmel + nac)
// floats) where it splits.
cudaError_t project_rows(int nfc, const float* pw, int pstride, int nbins,
                         const float4* op, float* sums, float* partial,
                         int nmel, int nac, float power_floor,
                         cudaStream_t st);

}  // namespace srt_cluster

namespace {
namespace cfft {

namespace cg = cooperative_groups;
using srt_cluster::NTH;
using srt_cluster::P;

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// W_M^m from the block's two-level table
struct Twiddles {
  const float2* lo;  // [2^lgb]: W_M^i
  const float2* hi;  // [M >> lgb]: W_M^(i 2^lgb)
  int lgb;
  __device__ __forceinline__ float2 operator()(int m) const {
    return cmul(hi[m >> lgb], lo[m & ((1 << lgb) - 1)]);
  }
};

// Builds the table of W_M (M = 2^lgm) in tab [tw_count(lgm)] and returns its
// reader; the caller's barrier publishes it.
__device__ __forceinline__ Twiddles twiddles(float2* tab, int lgm) {
  const int lgb = (lgm + 1) / 2, nlo = 1 << lgb;
  const int n = srt_cluster::tw_count(lgm);
  const float m = (float)(1 << lgm);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int e = i < nlo ? i : (i - nlo) << lgb;
    float s, c;
    sincospif((float)(2 * e) / m, &s, &c);
    tab[i] = make_float2(c, -s);
  }
  return Twiddles{tab, tab + nlo, lgb};
}

// d times W_L^r for the radix-2 network of an L-point DFT in registers
// (L <= 8, r < L/2): constants, no table.
template <int L>
__device__ __forceinline__ float2 wconst(int r, float2 d) {
  constexpr float SQ = 0.70710678118654752f;  // 1/sqrt(2)
  if (L == 8 && r == 1) return make_float2(SQ * (d.x + d.y), SQ * (d.y - d.x));
  if ((L == 8 && r == 2) || (L == 4 && r == 1)) return make_float2(d.y, -d.x);
  if (L == 8 && r == 3)
    return make_float2(SQ * (d.y - d.x), -SQ * (d.x + d.y));
  return d;
}

// One radix-2 stage of decimation in frequency over the registers x, span
// SPAN, then the next.
template <int R, int SPAN>
__device__ __forceinline__ void dif_stages(float2 (&x)[R]) {
#pragma unroll
  for (int g = 0; g < R; g += 2 * SPAN) {
#pragma unroll
    for (int r = 0; r < SPAN; ++r) {
      const float2 a = x[g + r], b = x[g + r + SPAN];
      x[g + r] = cadd(a, b);
      x[g + r + SPAN] = wconst<2 * SPAN>(r, csub(a, b));
    }
  }
  if constexpr (SPAN > 1) dif_stages<R, SPAN / 2>(x);
}

// The R-point DFT of x in registers, in place, natural order in and out:
// radix-2 decimation in frequency, then the outputs put back from their
// bit-reversed places by constant swaps (R = 1 is the identity; no
// register is indexed at run time, so x stays in registers).
template <int R>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  static_assert(R == 1 || R == 2 || R == 4 || R == 8, "radix");
  if constexpr (R > 1) dif_stages<R, R / 2>(x);
  const auto swap = [&](int a, int b) {
    const float2 t = x[a];
    x[a] = x[b];
    x[b] = t;
  };
  if constexpr (R == 4) swap(1, 2);
  if constexpr (R == 8) {
    swap(1, 4);
    swap(3, 6);
  }
}

// A Stockham pass of radix R over the block's slots v, in place, after
// NS points of each sub-transform are done: thread t takes butterflies j =
// t + NTH i; every input j + r P/R is loaded into registers before the
// barrier, multiplied by W_{NS R}^((j mod NS) r) = W_M^(C (j mod NS) r P /
// (NS R)) (an M = C P point table), and after the DFT stored at
// (j / NS) NS R + j mod NS + q NS. Where NS divides NTH a thread's
// butterflies share j mod NS, so it looks their twiddles up once. Ends on a
// barrier.
template <int R, int NS>
__device__ __forceinline__ void pass(float2* v, const Twiddles& tw, int C) {
  constexpr int S = P / R, B = S / NTH;
  float2 x[B][R];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int j = threadIdx.x + NTH * i;
#pragma unroll
    for (int r = 0; r < R; ++r) x[i][r] = v[slot(j + S * r)];
  }
  __syncthreads();
  float2 w[R];
  const auto twiddles_of = [&](int k) {
    const int e = C * k * (P / (NS * R));  // the exponent at r = 1
#pragma unroll
    for (int r = 1; r < R; ++r) w[r] = tw(e * r);
  };
  if constexpr (NS > 1 && NTH % NS == 0) twiddles_of(threadIdx.x % NS);
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int j = threadIdx.x + NTH * i, k = j & (NS - 1);
    if constexpr (NS > 1) {
      if constexpr (NTH % NS != 0) twiddles_of(k);
#pragma unroll
      for (int r = 1; r < R; ++r) x[i][r] = cmul(x[i][r], w[r]);
    }
    dft<R>(x[i]);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) v[slot(base + q * NS)] = x[i][q];
  }
  __syncthreads();
}

// The first pass (radix 8, Ns = 1) from load(p), p < E: inputs at or past
// E are not loaded; a butterfly with no input below E stores zeros, one
// with only its first stores that value 8 times. Ends on a barrier.
template <class Load>
__device__ __forceinline__ void first_pass(float2* v, int E,
                                           const Load& load) {
  constexpr int R = 8, S = P / R, B = S / NTH;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int j = threadIdx.x + NTH * i;
    float2 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = j + S * r < E ? load(j + S * r) : make_float2(0.f, 0.f);
    if (j + S < E) dft<R>(x);
#pragma unroll
    for (int q = 0; q < R; ++q) v[slot(j * R + q)] = j + S < E ? x[q] : x[0];
  }
  __syncthreads();
}

// The passes after the first: radix 8 at Ns = 8, 64, 512, radix 4 at 4096.
__device__ __forceinline__ void later_passes(float2* v, const Twiddles& tw,
                                             int C) {
  pass<8, 8>(v, tw, C);
  pass<8, 64>(v, tw, C);
  pass<8, 512>(v, tw, C);
  pass<4, 4096>(v, tw, C);
}

// The block's P-point FFT of the values in its slots, in place.
__device__ __forceinline__ void block_fft(float2* v, const Twiddles& tw,
                                         int C) {
  pass<8, 1>(v, tw, C);
  later_passes(v, tw, C);
}

// the barrier of a cluster of C blocks (a block's own where C = 1)
template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

template <int C>
__device__ __forceinline__ int rank() {
  if constexpr (C == 1)
    return 0;
  else
    return (int)cg::this_cluster().block_rank();
}

// Value c of a unit: slot s of rank c's buffer v (this block's own where
// C = 1).
template <int C>
__device__ __forceinline__ float2* rank_slots(float2* v, int c) {
  if constexpr (C == 1)
    return v;
  else
    return cg::this_cluster().map_shared_rank(v, c);
}

// A grid of nclusters clusters of C blocks, NTH threads and `smem` bytes
// each, on `st`.
template <int C, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int nclusters, int smem, cudaStream_t st,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * nclusters);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class F>
cudaError_t with_ranks(int c, F&& f) {
  switch (c) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace cfft
}  // namespace
