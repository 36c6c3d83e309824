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
// models/gmm.bank_operators, read here component by component from
// GmmBank.component_operator (the row layout of csrc/gmm_lse.cuh).
//
// What bounds it on this card: operations. Per valid frame it does 2*d*S*K
// FMAs and S*K exponentials on d floats of features (2.28 GFLOP on 18 MB at
// the bench batch), all on FP32 CUDA cores: a*x^2 + b*x + c cancels terms of
// O(100-1000) to a log-density of O(10), which TF32 operands would not
// carry. Every other instruction takes an FMA's slot in the scheduler, so
// the inner loop must hold little else. The first version (one block per
// (speaker, utterance), the frame and scalar parameters both read from
// shared memory: three 4-byte loads per two FMAs on one dependent chain)
// ran at ~8 TFLOP/s and staged every utterance S times.
//
// What the design does about it: a lane keeps two frames in registers (one
// past a padded d of 64) and every lane walks the same component row, so a
// 16-byte broadcast load of parameters feeds eight FMAs in eight
// independent chains (RegFrames of csrc/gmm_lse.cuh, shared with the serial
// kernel), and the online logsumexp costs one special-function exponential
// and no branch a component. One frame a lane, and a register cap that
// fits a fourth block on an SM, both measured slower on an H100. A warp
// takes 64
// (or 32) consecutive frames of one utterance and a block the warps of a
// tile, sized by the launch so that an utterance's frames split evenly
// over its blocks (311 frames: one block of five warps). The block walks
// all the speakers of its group over those frames, so features are read
// from device memory once; the group is the whole bank unless the batch is
// too small to fill the card, and then the speakers split over grid.z. The
// rows stream through shared memory by asynchronous 16-byte copies, all in
// one buffer up to 48 KB and in 32 KB chunks in two buffers beyond, with
// the online logsumexp carried across chunks: no cap on K. A warp whose
// frames are all masked skips the arithmetic. Past a padded d of 128
// WideFrames takes over (frame and rows left in device memory): any d. At
// each speaker's last row the warp adds its frames' floored logsumexps in a
// fixed shuffle tree into partial [B][warp tile][S]; a second kernel adds
// the tiles in order and divides by the valid-frame count. No atomics: two
// calls give the same bits. A batch past the grid's 65535 utterances goes
// in several launches of the scoring kernel, one mean kernel after them.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

#include "gmm_batch.cuh"
#include "gmm_lse.cuh"

namespace {

constexpr int MAX_WARPS = 8;          // warps per block, at most
constexpr int ONE_BUFFER = 49152;     // rows staged whole up to this size
constexpr int BLOCKS_PER_SM = 4;      // blocks the launch aims to have

// frames a lane holds at padded feature dimension dp
inline int frames_per_lane(int dp) { return dp <= 64 ? 2 : 1; }

// Frames: RegFrames<DP, FPL> or WideFrames. Grid (tile, utterance, speaker
// group of sg speakers); NW warp tiles an utterance; ch rows per chunk.
template <class Frames>
__global__ void __launch_bounds__(32 * MAX_WARPS) bank_score_kernel(
    const float* __restrict__ feats, const unsigned char* __restrict__ mask,
    const float* __restrict__ comp, float* __restrict__ partial,
    float* __restrict__ count, int T, int d, int S, int K, int sg, int ch,
    int NW) {
  constexpr int FPL = Frames::FPL;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wt = blockIdx.x * (blockDim.x / 32) + warp;  // the warp's tile
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * sg, ns = min(sg, S - s0);
  const int P = row_floats(d);

  const RowStream st{comp + (size_t)s0 * K * P, sm, ns * K, P, ch};
  if (Frames::STAGED) st.fetch(0);

  Frames fr;
  bool ok[FPL];
  bool any = false;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int t = (wt * FPL + i) * 32 + lane;
    ok[i] = wt < NW && t < T && mask[(size_t)b * T + t];
    fr.load(i, ok[i] ? feats + ((size_t)b * T + t) * d : nullptr, d);
    any = any || ok[i];
  }
  const bool active = __any_sync(0xffffffffu, any);
  float* mine = partial + ((size_t)b * NW + wt) * S + s0;

  walk_components(st, K, active, fr, [&](int s, OnlineLse (&lse)[FPL]) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < FPL; ++i)
      if (ok[i]) v += lse[i].floored();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) mine[s] = v;
  });

  if (wt >= NW) return;
  if (!active)
    for (int s = lane; s < ns; s += 32) mine[s] = 0.f;
  if (blockIdx.z == 0) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < FPL; ++i)
      n += __popc(__ballot_sync(0xffffffffu, ok[i]));
    if (lane == 0) count[(size_t)b * NW + wt] = (float)n;
  }
}

struct Plan {
  int NW, warps, tiles, sg, groups;
};

// Warp tiles of an utterance of T frames at feature dimension d.
inline int warp_tiles(int T, int d) {
  const int per_warp = 32 * frames_per_lane(padded_dim(d));
  return std::max(1, (T + per_warp - 1) / per_warp);
}

// How a [B, T] batch against S speakers is cut: warp tiles an utterance,
// warps a block (an utterance's tiles split evenly over its blocks), and
// speakers a group (the whole bank once the grid fills the card).
cudaError_t make_plan(int B, int T, int d, int S, Plan* p) {
  int nsm = 0;
  const cudaError_t err = sm_count(&nsm);
  if (err != cudaSuccess) return err;
  p->NW = warp_tiles(T, d);
  p->tiles = (p->NW + MAX_WARPS - 1) / MAX_WARPS;
  p->warps = (p->NW + p->tiles - 1) / p->tiles;
  const long long blocks = (long long)p->tiles * B;
  const long long want = (long long)BLOCKS_PER_SM * nsm;
  const int groups = (int)std::min<long long>(
      S, std::max<long long>(1, (want + blocks - 1) / blocks));
  p->sg = std::max((S + groups - 1) / groups, (S + 65534) / 65535);
  p->groups = (S + p->sg - 1) / p->sg;
  return cudaSuccess;
}

// Once per device and instantiation: the most dynamic shared memory a
// launch of it may ask for (two chunk buffers, or one buffer of rows).
template <class Frames>
cudaError_t prepare(int dev) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  if (!Frames::STAGED) return cudaSuccess;  // no dynamic shared memory
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        bank_score_kernel<Frames>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        std::max(ONE_BUFFER, 2 * CHUNK_BYTES));
  });
  return err[dev];
}

// utterances a launch takes: the grid's y dimension
constexpr int MAX_GRID_Y = 65535;

// One launch per MAX_GRID_Y utterances of the B in the call; the plan is
// the whole call's, and a block's work depends on its utterance, tile and
// speaker group alone, so the bits do not depend on the split.
template <class Frames>
cudaError_t launch(const Plan& p, int B, int smem, cudaStream_t st,
                   const float* feats, const unsigned char* mask,
                   const float* comp, float* partial, float* count, int T,
                   int d, int S, int K, int ch, int dev) {
  cudaError_t err = prepare<Frames>(dev);
  if (err != cudaSuccess) return err;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const dim3 grid(p.tiles, std::min(MAX_GRID_Y, B - b0), p.groups);
    bank_score_kernel<Frames><<<grid, 32 * p.warps, smem, st>>>(
        feats + (size_t)b0 * T * d, mask + (size_t)b0 * T, comp,
        partial + (size_t)b0 * p.NW * S, count + (size_t)b0 * p.NW, T, d, S,
        K, p.sg, ch, p.NW);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The launches of one call on the current device: the scoring kernel on
// the route of d, then the means.
cudaError_t launch_all(const void* feats, const void* mask, const void* comp,
                       void* scratch, void* out, int B, int T, int d, int S,
                       int K, int dev, cudaStream_t st) {
  Plan p;
  cudaError_t err = make_plan(B, T, d, S, &p);
  if (err != cudaSuccess) return err;
  const float* xf = (const float*)feats;
  const unsigned char* mk = (const unsigned char*)mask;
  const float* cp = (const float*)comp;
  float* partial = (float*)scratch;
  float* count = partial + (size_t)B * p.NW * S;
  const int dp = padded_dim(d);
  if (dp > MAX_REG_DP) {
    err = launch<WideFrames>(p, B, 0, st, xf, mk, cp, partial, count, T, d,
                             S, K, p.sg * K, dev);
  } else {
    int smem;
    const int ch = plan_chunks(p.sg * K, row_floats(d), ONE_BUFFER, &smem);
    switch (dp) {
#define SRT_SCORE_CASE(DP, FPL)                                            \
  case DP:                                                                 \
    err = launch<RegFrames<DP, FPL>>(p, B, smem, st, xf, mk, cp, partial,    \
                                     count, T, d, S, K, ch, dev);          \
    break;
      SRT_SCORE_CASE(4, 2) SRT_SCORE_CASE(8, 2) SRT_SCORE_CASE(12, 2)
      SRT_SCORE_CASE(16, 2) SRT_SCORE_CASE(20, 2) SRT_SCORE_CASE(24, 2)
      SRT_SCORE_CASE(28, 2) SRT_SCORE_CASE(32, 2) SRT_SCORE_CASE(36, 2)
      SRT_SCORE_CASE(40, 2) SRT_SCORE_CASE(44, 2) SRT_SCORE_CASE(48, 2)
      SRT_SCORE_CASE(52, 2) SRT_SCORE_CASE(56, 2) SRT_SCORE_CASE(60, 2)
      SRT_SCORE_CASE(64, 2) SRT_SCORE_CASE(68, 1) SRT_SCORE_CASE(72, 1)
      SRT_SCORE_CASE(76, 1) SRT_SCORE_CASE(80, 1) SRT_SCORE_CASE(84, 1)
      SRT_SCORE_CASE(88, 1) SRT_SCORE_CASE(92, 1) SRT_SCORE_CASE(96, 1)
      SRT_SCORE_CASE(100, 1) SRT_SCORE_CASE(104, 1) SRT_SCORE_CASE(108, 1)
      SRT_SCORE_CASE(112, 1) SRT_SCORE_CASE(116, 1) SRT_SCORE_CASE(120, 1)
      SRT_SCORE_CASE(124, 1) SRT_SCORE_CASE(128, 1)
#undef SRT_SCORE_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return err;
  const long long BS = (long long)B * S;
  bank_mean_kernel<<<(unsigned)((BS + RT - 1) / RT), RT, 0, st>>>(
      partial, count, (float*)out, BS, S, p.NW);
  return cudaGetLastError();
}

}  // namespace

// Frames a warp tile takes at feature dimension d. The device scratch a
// call takes is the warp tiles' partial sums [B][NW][S] and valid-frame
// counts [B][NW], NW = max(1, ceil(T / this)): B * NW * (S + 1) floats,
// which the caller computes from this once per bank.
extern "C" int srt_bank_warp_frames(int d) {
  return 32 * frames_per_lane(padded_dim(d));
}

// feats [B, T, d], mask [B, T] (bytes), comp the component rows
// [S, K, srt_component_row(d)], scratch B * NW * (S + 1) floats
// (srt_bank_warp_frames); writes out [B, S] on device `device` (made current
// for the launch), stream `stream`. Any B: one launch per 65535 utterances.
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
  err = launch_all(feats, mask, comp, scratch, out, B, T, d, S, K, device,
                   (cudaStream_t)stream);
  if (cur != device) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
