// Speaker-bank GMM scoring for Hopper (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_gmm.py:_run_batch_lse together
// with the epilogue of its wrapper batch_bank_avg_loglik: for utterance b and
// speaker s,
//     logp[t, k] = sum_j op[j, s*K+k] * [x_t^2 | x_t]_j + cw[s*K+k]
//     lse[t]     = logsumexp_k logp[t, k], floored: lse > -745 ? lse
//                                                         : log(1e-15)
//     out[b, s]  = sum_t mask[b,t] * lse[t] / max(sum_t mask[b,t], 1)
// with op [2d, S*K] and cw [S*K] the joint-density operator of
// models/gmm.bank_operators.
//
// What bounds it on this card: the product. Per valid frame it does 2*d*S*K
// multiply-adds and S*K exponentials on d floats of features: at the
// reference's bank (80 x 32, d = 38) and 512 x 5 s at 8 kHz, 62 GFLOP on
// 24 MB. On the FP32 CUDA cores (the previous design: a lane's frames in
// registers, the component rows broadcast from shared memory) that took
// 2.28 ms on an H100, and no CUDA-core kernel goes below ~1 ms there. The
// tensor cores take it only in three TF32 terms (csrc/tf32_mma.cuh):
// a*x^2 + b*x + c cancels terms of O(100-1000) to a log-density of O(10),
// one TF32 term carries 11 bits of each operand (~1e-3 on the averages,
// the benchmark's limit), and three terms leave ~2^-22 a product. The
// least time is then the three passes at the TF32 peak (0.38 ms at that
// shape). mma.sync reaches ~70% of that peak a pass on an H100; with the
// logsumexp's exponentials (S*K a frame), the bank's fragments read a
// k-step and the frames' split, the route takes ~1.06 ms there.
//
// What bounds its accuracy: the tensor cores' adder, which cuts every term
// it adds toward zero at the ulp of the largest (csrc/tf32_mma.cuh). A sum
// carried in the accumulator loses up to an ulp of itself a product, all
// one way, and the sum [x^2 | x] . [a | b] runs to O(20-70) before it
// cancels: from cw (O(50-200)) that read 1.1e-4 (d = 38) to 1.05e-3 (d =
// 128) from float64 on an H100. So the product runs in parts, each into
// an accumulator from zero, added in f32 to nearest, cw last. A part per
// k-step would hold the FP32 route's accuracy (1.2-4.1e-5 on Gaussian
// features) but reads each accumulator back through the FP32 pipe: 1.8 ms
// at the cells' shape. The parts are the whole depth up to 2d = 80 (3.1e-5
// there, torch's own f32 product 3.7e-5), halves to 2d = 160 and
// CHUNK_PART k-steps beyond (up to 7.4e-5 at d = 128): within 1e-4 of
// float64 at every depth the route takes, 10x inside the benchmark's
// limit and under a tenth of one TF32 term's distance (measured on an
// H100 on Gaussian features, d = 13-128, two seeds).
//
// What the design does about it (the tensor route, 2d <= 8 * MAX_KS):
//   - mma.sync m16n8k8 TF32: the 16 rows of A are frames, the 8 columns of
//     B components, the depth [x^2 | x | 0] against [a | b | 0] padded with
//     exact zeros to an instance's k-steps of 8 (k_steps: 5, 10, 20, then
//     pairs); each k-step adds lo.hi, hi.lo, hi.hi in that order into its
//     part's accumulator.
//   - Up to 2d = 160 a warp holds its frames in registers as split A
//     fragments for the whole depth: two m16 tiles (32 frames, 16 NKS
//     registers) up to TWO_TILE_KS k-steps, so that every B fragment pair
//     feeds two tiles (six MMAs a 16-byte load), one tile (16 frames)
//     beyond. The frames arrive by coalesced asynchronous copies into the
//     warp's rows of shared memory; x^2 is formed in f32 from x, then both
//     are split in registers, once. Deeper (to 2d = 256, the depths the
//     CUDA-core kernel held in registers before) the depth goes in chunks
//     of KC k-steps, each chunk's fragments split again from shared memory
//     (rows padded apart: no bank conflict) for every group of components:
//     one m16 tile, 64 A registers.
//   - The bank arrives split and fragment-ordered (GmmBank.tf32_operator,
//     packed once per bank): per n8 tile of a speaker's components and
//     k-step, 32 lanes x (hi(b0), hi(b1), lo(b0), lo(b1)), then the 8
//     components' cw; a speaker's K is padded to a multiple of 8 by rows of
//     zero terms with cw = PAD_CW (models/gmm), which add exactly 0 to its
//     logsumexp. Every warp reads it in the same order, one 16-byte load a
//     lane and k-step, through L1 (the SM's warps share its lines) from
//     L2: no staging. Staged through shared memory in chunks (two buffers,
//     cp.async, two barriers a chunk) it measured slower.
//   - Registers set the frames an SM: up to 255 a thread, two blocks of 4
//     warps (256 frames) an SM; each block reads its group's whole bank,
//     ~2 TB from L1 and L2 a 512 x 5 s batch against the 80 x 32 bank.
//     Warp tiles of consecutive frames of the flattened batch; a block's
//     tiles with no valid frame write zeros and its other tiles share its
//     warps, each warp a share of the speakers, so that padding frees the
//     block: with 8 warps a block and no sharing, the reference's t3 + t5
//     lengths (20% of the tiles padding) took 98% of the time of 5 s alone.
//   - The logsumexp is fused behind the product: after each group of up to
//     4 n8 tiles (32 components) the quad's 4 lanes, which hold a frame's 8
//     components of each tile, take their maximum by two butterfly steps,
//     add their exponentials against it by two more, and fold them into the
//     frame's running (max, sum), rescaled where the maximum grew: one
//     exponential a value, and K has no cap. At a speaker's end the quads'
//     leaders add their valid frames' floored logsumexps in a fixed
//     shuffle tree into partial [B][warp tile][S].
// Past 2d = 256 the wide route takes any d on the CUDA cores: one frame a
// lane and one warp a block, frame and component rows
// (GmmBank.component_operator, the layout of csrc/gmm_lse.cuh) read from
// device memory. On both routes a second kernel
// adds the warp tiles in order and divides by the valid-frame count; the
// grid is the flattened warp tiles (no cap on the batch) by speaker groups
// (the whole bank unless the batch is too small to fill the card, then
// the speakers split over grid.z). No atomics: two calls give the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gmm_batch.cuh"
#include "gmm_lse.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;               // warps a block, tensor route
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int REG_KS = 20;             // fragments split once: 2d <= 160
constexpr int MAX_KS = 32;             // deepest tensor route: 2d <= 256
constexpr int KC = 8;                  // k-steps a chunk past REG_KS
constexpr int TWO_TILE_KS = 10;        // two m16 tiles a warp: 2d <= 80
constexpr int SHORT_KS = 5;            // the shortest depth: 2d <= 40
constexpr int CHUNK_PART = 2;          // k-steps a part past REG_KS
constexpr int NT = 4;                  // n8 tiles a group of the product
constexpr int TENSOR_BLOCKS_PER_SM = 2;  // at <= 255 registers a thread
constexpr int WIDE_WARPS_PER_SM = 24;  // the wide route's warps an SM

// k-steps of 8 the depth 2d takes, padded with zero terms to a depth an
// instance of the tensor route takes whole: SHORT_KS, TWO_TILE_KS, REG_KS,
// then whole parts of CHUNK_PART
__host__ __device__ constexpr int k_steps(int d) {
  const int ks = (2 * d + 7) / 8;
  return ks <= SHORT_KS       ? SHORT_KS
         : ks <= TWO_TILE_KS  ? TWO_TILE_KS
         : ks <= REG_KS       ? REG_KS
                              : (ks + CHUNK_PART - 1) / CHUNK_PART * CHUNK_PART;
}
// floats of an n8 tile of GmmBank.tf32_operator: NKS k-steps of 32 lanes x
// 4 floats, then the 8 components' cw
__host__ __device__ constexpr int tile_floats(int nks) {
  return 128 * nks + 8;
}
// floats a frame takes staged in shared memory: d where its fragments are
// split once; past REG_KS, where every group of components splits them
// again, d rounded up to 8, plus 4, so that the 8 frames a fragment reads
// start 4 banks apart (no conflict)
__host__ __device__ constexpr int staged_floats(int d) {
  return k_steps(d) > REG_KS ? (d + 7) / 8 * 8 + 4 : d;
}
__host__ __device__ constexpr int m_tiles(int nks) {
  return nks <= TWO_TILE_KS ? 2 : 1;
}
inline bool tensor_route(int d) { return k_steps(d) <= MAX_KS; }

// What a launch of either route reads and writes. K: a speaker's rows of
// comp (components on the wide route, padded to a multiple of 8 on the
// tensor route); tiles: B * NW warp tiles.
struct ScoreArgs {
  const float* feats;
  const unsigned char* mask;
  const float* comp;
  float* partial;
  float* count;
  long long tiles;
  int T, d, S, K, sg, NW;
};

// The tensor route: MT m16 tiles (16 MT frames) a warp. CHUNKED false:
// NKS k-steps (k_steps(d)), the frames' fragments split once into
// registers. CHUNKED true: k_steps(d), up to MAX_KS, taken NKS at a time
// (the last chunk in part), each chunk's fragments split again from the
// staged frames for every group of components. A part's loop over its
// k-steps has its count at compile time: no branch inside a part.
template <int NKS, int MT, bool CHUNKED>
struct Tf32Tile {
  static constexpr int WF = 16 * MT, BLOCK_WARPS = WARPS, MIN_BLOCKS = 1;
  // k-steps a part of the product (each part's sum a fresh accumulator):
  // NKS up to TWO_TILE_KS, halves of REG_KS, CHUNK_PART in chunks
  static constexpr int PART = CHUNKED              ? CHUNK_PART
                              : NKS <= TWO_TILE_KS ? NKS
                                                   : NKS / 2;
  using Frags = uint32_t[MT][NKS][4];

  // [x^2 | x | 0] at depths 8 (ks0 + ks) + t + 4 (i >> 1) of frames
  // mt * 16 + g + 8 (i & 1) (fx: the warp's staged frames, ld floats
  // apart), split into A fragments; x^2 formed in f32, zeros for the
  // frames not valid
  __device__ __forceinline__ static void split_frames(const float* fx, int ld,
                                                      int d, int ks0,
                                                      const bool (&ok)[MT][2],
                                                      Frags& ah, Frags& al) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * 16 + g + 8 * (i & 1);
          const int k = 8 * (ks0 + ks) + t + 4 * (i >> 1);
          float v = 0.f;
          if (ok[mt][i & 1]) {
            if (k < d) {
              const float xv = fx[r * ld + k];
              v = xv * xv;
            } else if (k < 2 * d) {
              v = fx[r * ld + k - d];
            }
          }
          split(v, ah[mt][ks][i], al[mt][ks][i]);
        }
  }

  // k-steps ks0 .. ks0 + PART - 1 of N n8 tiles of the operator from blk
  // (P floats each, read through L1) against A fragments q0 .. q0 + PART -
  // 1 of ah, al, written to f: per k-step lo.hi, hi.lo, hi.hi, the tiles
  // interleaved, f zero before the first (csrc/tf32_mma.cuh: the tensor
  // cores' adder truncates to the largest term it adds, so f carries one
  // part's sum, not the whole)
  template <int N>
  __device__ __forceinline__ static void part(const float* blk, int P,
                                              int ks0, int q0,
                                              const Frags& ah,
                                              const Frags& al,
                                              float (&f)[MT][N][4]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int ks = 0; ks < PART; ++ks) {
      uint32_t bh[N][2], bl[N][2];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(blk + j * P) +
                               (ks0 + ks) * 32 + lane);
        bh[j][0] = __float_as_uint(v.x);
        bh[j][1] = __float_as_uint(v.y);
        bl[j][0] = __float_as_uint(v.z);
        bl[j][1] = __float_as_uint(v.w);
      }
      const int q = q0 + ks;
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (ks == 0)
            mma_tf32_zero(f[mt][j], al[mt][q], bh[j][0], bh[j][1]);
          else
            mma_tf32(f[mt][j], al[mt][q], bh[j][0], bh[j][1]);
        }
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_tf32(f[mt][j], ah[mt][q], bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_tf32(f[mt][j], ah[mt][q], bh[j][0], bh[j][1]);
    }
  }

  // c += f, in f32 to nearest
  template <int N>
  __device__ __forceinline__ static void add(float (&c)[MT][N][4],
                                             const float (&f)[MT][N][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mt][j][i] += f[mt][j][i];
  }

  // N n8 tiles of the operator from blk (P floats each: nks k-steps of 32
  // lanes x 4, then 8 cw) against the warp's frames, folded into the
  // frames' logsumexps (m, sum: the same in the 4 lanes of a quad). The
  // parts' sums are added in order, then cw. Lane 4 g + t's entries 2 h,
  // 2 h + 1 of accumulator c[mt][j] are frame mt * 16 + g + 8 h at the
  // tile's components 2 t, 2 t + 1: the quad's maximum by two butterfly
  // steps, each lane's exponentials against it, their sum by two more, and
  // the running sum rescaled where the maximum grew (exp(-inf) = 0 for a
  // speaker's first group).
  template <int N>
  __device__ __forceinline__ static void group(
      const float* blk, int P, int nks, const float* fx, int ld, int d,
      const bool (&ok)[MT][2], const Frags& ah, const Frags& al,
      float (&m)[MT][2], float (&sum)[MT][2]) {
    const int lane = threadIdx.x % 32, t = lane % 4;
    float c[MT][N][4];
    if constexpr (CHUNKED) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[mt][j][i] = 0.f;
      for (int ks0 = 0; ks0 < nks; ks0 += NKS) {
        Frags ch, cl;
        split_frames(fx, ld, d, ks0, ok, ch, cl);
#pragma unroll
        for (int q0 = 0; q0 < NKS; q0 += PART) {
          if (ks0 + q0 >= nks) break;  // the depth's last chunk, in part
          float f[MT][N][4];
          part<N>(blk, P, ks0 + q0, q0, ch, cl, f);
          add<N>(c, f);
        }
      }
    } else {
      part<N>(blk, P, 0, 0, ah, al, c);
#pragma unroll
      for (int q0 = PART; q0 < NKS; q0 += PART) {
        float f[MT][N][4];
        part<N>(blk, P, q0, q0, ah, al, f);
        add<N>(c, f);
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 cw = __ldg(
          reinterpret_cast<const float2*>(blk + j * P + 128 * nks + 2 * t));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        c[mt][j][0] += cw.x;
        c[mt][j][1] += cw.y;
        c[mt][j][2] += cw.x;
        c[mt][j][3] += cw.y;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(c[mt][0][2 * h], c[mt][0][2 * h + 1]);
#pragma unroll
        for (int j = 1; j < N; ++j)
          mx = fmaxf(mx, fmaxf(c[mt][j][2 * h], c[mt][j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        mx = fmaxf(mx, m[mt][h]);
        // v - mx is exactly 0 at the maximum: no exponential overflows
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j)
          e += exp2_approx(LOG2E * (c[mt][j][2 * h] - mx)) +
               exp2_approx(LOG2E * (c[mt][j][2 * h + 1] - mx));
        // (e0 + e1) + (e2 + e3) in every lane of the quad: the same bits
        e += __shfl_xor_sync(FULL_MASK, e, 1);
        e += __shfl_xor_sync(FULL_MASK, e, 2);
        sum[mt][h] = sum[mt][h] * exp2_approx(LOG2E * (m[mt][h] - mx)) + e;
        m[mt][h] = mx;
      }
  }

  __device__ __forceinline__ static void score(const ScoreArgs& a) {
    extern __shared__ __align__(16) float sm[];
    __shared__ int live[WARPS];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int s0 = blockIdx.z * a.sg, ns = min(a.sg, a.S - s0);
    const int nt8 = a.K / 8;  // n8 tiles a speaker
    const int nks = k_steps(a.d);
    const int P = tile_floats(nks), ld = staged_floats(a.d);

    // The block's warp tiles that hold a valid frame share its warps: a
    // tile with none writes its zeros (by its own warp) and takes no
    // product, and warp w takes the (w mod n)-th of the n live tiles and
    // the (w / n)-th share of the group's speakers, so that padding frees
    // the block sooner (each (tile, speaker) sum is the same on any warp)
    {
      const long long tile = (long long)blockIdx.x * WARPS + warp;
      const long long b = tile / a.NW;
      const int t0 = (int)(tile % a.NW) * WF;
      const int nf = tile < a.tiles ? min(WF, a.T - t0) : 0;
      const bool any = __any_sync(
          FULL_MASK, lane < nf && a.mask[(size_t)b * a.T + t0 + lane]);
      if (!any && tile < a.tiles) {
        float* mine = a.partial + (size_t)tile * a.S + s0;
        for (int i = lane; i < ns; i += 32) mine[i] = 0.f;
        if (blockIdx.z == 0 && lane == 0) a.count[tile] = 0.f;
      }
      if (lane == 0) live[warp] = any;
    }
    __syncthreads();
    int n = 0;  // live tiles
    for (int i = 0; i < WARPS; ++i) n += live[i];
    if (n == 0) return;
    int mine_at = 0;  // the block's warp tile of the (warp mod n)-th
    for (int i = 0, k = 0; i < WARPS; ++i)
      if (live[i] && k++ == warp % n) mine_at = i;
    const int share = warp / n, shares = (WARPS - 1 - warp % n) / n + 1;
    const int sa = ns * share / shares, sb = ns * (share + 1) / shares;
    const long long tile = (long long)blockIdx.x * WARPS + mine_at;
    const long long b = tile / a.NW;
    const int t0 = (int)(tile % a.NW) * WF;
    const int nf = min(WF, a.T - t0);
    const unsigned char* mk = a.mask + (size_t)b * a.T + t0;
    const bool ok_lane = lane < nf && mk[lane];
    bool ok[MT][2];  // frames g + 8 h of each m16 tile valid
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        ok[mt][h] = r < nf && mk[r];
      }
    // the warp's frames [nf][d] staged in its rows of shared memory (ld
    // floats apart) by coalesced 4-byte asynchronous copies; on the
    // register route split into A fragments for every k-step, once
    float* fx = sm + (size_t)warp * WF * ld;
    const float* x = a.feats + ((size_t)b * a.T + t0) * a.d;
    if constexpr (CHUNKED) {
      for (int e = lane, r = 0, k = lane; e < nf * a.d; e += 32, k += 32) {
        while (k >= a.d) k -= a.d, ++r;  // e = r d + k
        __pipeline_memcpy_async(fx + r * ld + k, x + e, 4);
      }
    } else {
      for (int e = lane; e < nf * a.d; e += 32)
        __pipeline_memcpy_async(fx + e, x + e, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    Frags ah, al;
    if constexpr (!CHUNKED) split_frames(fx, ld, a.d, 0, ok, ah, al);

    // the warp's share of the group's speakers, each in groups of NT n8
    // tiles (single tiles past the last full group)
    const float* blk = a.comp + (size_t)(s0 + sa) * nt8 * P;
    float* mine = a.partial + (size_t)tile * a.S + s0;
    for (int s = sa; s < sb; ++s) {
      float m[MT][2], sum[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // field by field (csrc/gmm_mma.cuh)
          m[mt][h] = -INFINITY;
          sum[mt][h] = 0.f;
        }
      int j = 0;
      for (; j + NT <= nt8; j += NT, blk += NT * P)
        group<NT>(blk, P, nks, fx, ld, a.d, ok, ah, al, m, sum);
      for (; j < nt8; ++j, blk += P)
        group<1>(blk, P, nks, fx, ld, a.d, ok, ah, al, m, sum);
      float v = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float lse = m[mt][h] + __logf(sum[mt][h]);
          if (t == 0 && ok[mt][h])
            v += lse > UNDERFLOW_LOG ? lse : LOG_MIN_PROB;
        }
      // the 8 quads' leaders (t = 0) in a fixed tree
#pragma unroll
      for (int o = 16; o >= 4; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
      if (lane == 0) mine[s] = v;
    }
    const int valid = __popc(__ballot_sync(FULL_MASK, ok_lane));
    if (blockIdx.z == 0 && share == 0 && lane == 0)
      a.count[tile] = (float)valid;
  }
};

// The wide route, any d: one frame a lane (WideFrames of csrc/gmm_lse.cuh),
// the component rows read where they lie.
struct WideRoute {
  // one warp a block, so that a small batch's warps spread evenly over
  // the SMs, whose L1 carries the frames' scattered loads; at most 64
  // registers, so that 32 warps an SM stay resident (measured faster than
  // more registers and fewer warps on an H100)
  static constexpr int WF = 32, BLOCK_WARPS = 1, MIN_BLOCKS = 32;

  __device__ __forceinline__ static void score(const ScoreArgs& a) {
    const int lane = threadIdx.x;
    const long long tile = blockIdx.x;
    if (tile >= a.tiles) return;  // no barrier on this route
    const long long b = tile / a.NW;
    const int t = (int)(tile % a.NW) * WF + lane;
    const int s0 = blockIdx.z * a.sg, ns = min(a.sg, a.S - s0);
    const int P = row_floats(a.d);
    const RowStream st{a.comp + (size_t)s0 * a.K * P, nullptr, ns * a.K, P,
                       ns * a.K};
    const bool ok = t < a.T && a.mask[(size_t)b * a.T + t];
    WideFrames fr;
    fr.load(0, ok ? a.feats + ((size_t)b * a.T + t) * a.d : nullptr, a.d);
    const bool active = __any_sync(FULL_MASK, ok);
    float* mine = a.partial + (size_t)tile * a.S + s0;
    walk_components(st, a.K, active, fr, [&](int s, OnlineLse (&lse)[1]) {
      float v = ok ? lse[0].floored() : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
      if (lane == 0) mine[s] = v;
    });
    if (!active)
      for (int i = lane; i < ns; i += 32) mine[i] = 0.f;
    if (blockIdx.z == 0) {
      const int n = __popc(__ballot_sync(FULL_MASK, ok));
      if (lane == 0) a.count[tile] = (float)n;
    }
  }
};

// Route: Tf32Tile<NKS, MT, CHUNKED> or WideRoute. Grid (blocks of
// Route::BLOCK_WARPS warp tiles, 1, speaker groups of sg speakers).
template <class Route>
__global__ void __launch_bounds__(32 * Route::BLOCK_WARPS, Route::MIN_BLOCKS)
    bank_score_kernel(const ScoreArgs a) {
  Route::score(a);
}

struct Plan {
  long long tiles;
  int NW, blocks, sg, groups, smem;
};

// How a [B, T] batch against S speakers is cut: warp tiles of wf frames
// an utterance, bw of them a block; speakers a group (the whole bank once
// per_sm blocks an SM fill the card); smem: the warps' staged frames of d
// features on the tensor route, none on the wide one.
cudaError_t make_plan(int B, int T, int d, int S, bool tensor, Plan* p) {
  const int wf = tensor ? 16 * m_tiles(k_steps(d)) : WideRoute::WF;
  const int bw = tensor ? WARPS : WideRoute::BLOCK_WARPS;
  const int per_sm = tensor ? TENSOR_BLOCKS_PER_SM : WIDE_WARPS_PER_SM;
  int nsm = 0;
  const cudaError_t err = sm_count(&nsm);
  if (err != cudaSuccess) return err;
  p->NW = std::max(1, (T + wf - 1) / wf);
  p->tiles = (long long)B * p->NW;
  const long long blocks = (p->tiles + bw - 1) / bw;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  p->blocks = (int)blocks;
  const long long want = (long long)per_sm * nsm;
  const int groups = (int)std::min<long long>(
      S, std::max<long long>(1, (want + blocks - 1) / blocks));
  p->sg = std::max((S + groups - 1) / groups, (S + 65534) / 65535);
  p->groups = (S + p->sg - 1) / p->sg;
  p->smem = tensor ? WARPS * wf * staged_floats(d) * 4 : 0;  // <= 34 KB
  return cudaSuccess;
}

template <class Route>
cudaError_t launch(const Plan& p, const ScoreArgs& a, cudaStream_t st) {
  bank_score_kernel<Route>
      <<<dim3(p.blocks, 1, p.groups), 32 * Route::BLOCK_WARPS, p.smem, st>>>(
          a);
  return cudaGetLastError();
}

// The launches of one call on the current device: the scoring kernel on
// the route of d, then the means.
cudaError_t launch_all(const void* feats, const void* mask, const void* comp,
                       void* scratch, void* out, int B, int T, int d, int S,
                       int K, cudaStream_t st) {
  const int nks = k_steps(d);
  const bool tensor = tensor_route(d);
  Plan p;
  cudaError_t err = make_plan(B, T, d, S, tensor, &p);
  if (err != cudaSuccess) return err;
  float* partial = (float*)scratch;
  const ScoreArgs a{(const float*)feats, (const unsigned char*)mask,
                    (const float*)comp, partial,
                    partial + (size_t)p.tiles * S, p.tiles, T, d, S,
                    tensor ? (K + 7) / 8 * 8 : K, p.sg, p.NW};
  if (!tensor) {
    err = launch<WideRoute>(p, a, st);
  } else if (nks == SHORT_KS) {
    err = launch<Tf32Tile<SHORT_KS, 2, false>>(p, a, st);
  } else if (nks == TWO_TILE_KS) {
    err = launch<Tf32Tile<TWO_TILE_KS, 2, false>>(p, a, st);
  } else if (nks == REG_KS) {
    err = launch<Tf32Tile<REG_KS, 1, false>>(p, a, st);
  } else {
    err = launch<Tf32Tile<KC, 1, true>>(p, a, st);
  }
  if (err != cudaSuccess) return err;
  const long long BS = (long long)B * S;
  bank_mean_kernel<<<(unsigned)((BS + RT - 1) / RT), RT, 0, st>>>(
      partial, a.count, (float*)out, BS, S, p.NW);
  return cudaGetLastError();
}

}  // namespace

// Floats an n8 tile takes in GmmBank.tf32_operator at feature dimension d
// (tile_floats: 32 lanes x 4 a k-step, then 8 cw), or -1 where d is past
// the tensor route (2d > 8 * MAX_KS) or below 1: the wide route's rows are
// then GmmBank.component_operator's (srt_component_row).
extern "C" int srt_bank_tensor_row(int d) {
  return d >= 1 && tensor_route(d) ? tile_floats(k_steps(d)) : -1;
}

// Frames a warp tile takes at feature dimension d. The device scratch a
// call takes is the warp tiles' partial sums [B][NW][S] and valid-frame
// counts [B][NW], NW = max(1, ceil(T / this)): B * NW * (S + 1) floats,
// which the caller computes from this once per bank.
extern "C" int srt_bank_warp_frames(int d) {
  return d >= 1 && tensor_route(d) ? 16 * m_tiles(k_steps(d)) : WideRoute::WF;
}

// feats [B, T, d], mask [B, T] (bytes), comp the bank as the route of d
// reads it: GmmBank.tf32_operator [S, ceil(K / 8), srt_bank_tensor_row(d)]
// where that is positive, else GmmBank.component_operator [S, K,
// srt_component_row(d)]; scratch B * NW * (S + 1) floats
// (srt_bank_warp_frames); writes out [B, S] on device `device` (made current
// for the launch), stream `stream`. Any B.
extern "C" int srt_bank_avg_loglik(const void* feats, const void* mask,
                                   const void* comp, void* scratch, void* out,
                                   int B, int T, int d, int S, int K,
                                   int device, void* stream) {
  if (B < 1 || d < 1 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = launch_all(feats, mask, comp, scratch, out, B, T, d, S, K,
                   (cudaStream_t)stream);
  if (cur != device) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
