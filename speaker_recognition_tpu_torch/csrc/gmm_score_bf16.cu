// Speaker-bank GMM scoring with bf16 operands on the tensor cores, for
// Hopper (sm_90a), plain C interface: K2's precision="bf16".
//
// Replaces speaker_recognition_tpu/ops/pallas_gmm.py:_run_batch_lse with
// bf16 operands (batch_bank_avg_loglik(precision="bf16"), :211, the cast
// at :244-247) together with its wrapper's epilogue: for utterance b and
// speaker s,
//     logp[t, k] = [bf16(bf16(x)^2) | bf16(x)] . [bf16(a_k) | bf16(b_k)]
//                  + cw_k                       (f32 accumulation)
//     lse[t]     = logsumexp_k logp[t, k], floored: > -745 ? lse : log(1e-15)
//     out[b, s]  = sum_t mask[b,t] * lse[t] / max(sum_t mask[b,t], 1)
// with the bank as GmmBank.mma_operator rows (csrc/gmm_mma.cuh).
//
// What bounds it on this card: at the bench batch (512 x 5 s at 8 kHz, a
// 4 x 32 bank, d = 28) 2.3 GFLOP of products on the bf16 tensor cores
// (2.3 us at 989 TFLOP/s), 20 M exponentials of the logsumexp on the
// special-function units and 18 MB of f32 features read once (5.4 us at
// 3.35 TB/s): the bytes, then the exponentials, not the products. So the
// frames are read once and the tensor cores take the dot products that
// held the f32 kernel (csrc/gmm_score.cu) at 2.4x its FP32 bound.
//
// What the design does: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// through inline PTX (csrc/gmm_mma.cuh, which says how a lane's accumulator
// feeds its online logsumexp). A warp owns 32 consecutive frames of one
// utterance, staged once as bf16 [x^2 | x] rows in shared memory, and a
// block the warps of a tile; the block walks all the speakers of its group
// (the whole bank unless the batch is too small to fill the card, then
// grid.z splits the speakers), the component rows streaming through shared
// memory. Past a depth of 512 (d > 256) the wide route builds the
// fragments from the f32 frames in device memory: any d. At each speaker's
// last tile the warp adds its valid frames' floored logsumexps (one lane a
// quad) in a fixed shuffle tree into partial [B][warp tile][S]; a second
// kernel adds the tiles in order and divides by the valid-frame count. No
// atomics: two calls give the same bits. Past the grid's 65535 utterances
// the scoring kernel launches once per 65535, the mean kernel once.
// Simple and right first: wgmma, TMA and a persistent grid are for a later
// change.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

#include "gmm_batch.cuh"
#include "gmm_mma.cuh"

namespace {

constexpr int MAX_WARPS = 8;        // warps per block, at most
constexpr int ONE_BUFFER = 49152;   // rows staged whole up to this size
constexpr int BLOCKS_PER_SM = 4;    // blocks the launch aims to have
constexpr int MAX_GRID_Y = 65535;   // utterances a launch takes

// Frames: SmemFrames (STAGED) or GlobalFrames<true>. Grid (tile, utterance,
// speaker group of sg speakers); NW warp tiles an utterance; ch rows a
// staged chunk; the warps' frame rows follow `rows_smem` bytes of rows.
template <class Frames, bool STAGED>
__global__ void __launch_bounds__(32 * MAX_WARPS) bank_score_bf16_kernel(
    const float* __restrict__ feats, const unsigned char* __restrict__ mask,
    const uint32_t* __restrict__ comp, float* __restrict__ partial,
    float* __restrict__ count, int T, int d, int S, int kp, int sg, int ch,
    int NW, int rows_smem) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wt = blockIdx.x * (blockDim.x / 32) + warp;  // the warp's tile
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * sg, ns = min(sg, S - s0);
  const int RW = mma_row_words(d), nks = mma_depth(d) / 16;

  const RowStream st{reinterpret_cast<const float*>(comp) +
                         (size_t)s0 * kp * RW,
                     sm, ns * kp, RW, ch};
  if (STAGED) st.fetch(0);

  const int t0 = wt * WF;
  const int nf = wt < NW ? max(0, min(WF, T - t0)) : 0;
  const float* x = feats + ((size_t)b * T + t0) * d;
  const unsigned char* mk = mask + (size_t)b * T + t0;
  const bool ok_lane = lane < nf && mk[lane];
  const bool active = __any_sync(FULL_MASK, ok_lane);
  bool ok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = mt * 16 + lane / 4 + 8 * h;
      ok[mt][h] = lane % 4 == 0 && i < nf && mk[i];
    }

  Frames fr;
  if constexpr (STAGED) {
    uint32_t* at = reinterpret_cast<uint32_t*>(
                       reinterpret_cast<char*>(sm) + rows_smem) +
                   (size_t)warp * WF * RW;
    if (active) stage_frames<true>(at, RW, x, nf, d);
    fr = Frames{at, RW};
  } else {
    fr = Frames{x, nf, d};
  }
  float* mine = partial + ((size_t)b * NW + wt) * S + s0;

  walk_mma<STAGED>(st, kp, nks, active, fr,
                   [&](int s, OnlineLse (&lse)[MT][2]) {
    float v = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[mt][h]) v += lse[mt][h].floored();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    if (lane == 0) mine[s] = v;
  });

  if (wt >= NW) return;
  if (!active)
    for (int s = lane; s < ns; s += 32) mine[s] = 0.f;
  if (blockIdx.z == 0) {
    const int n = __popc(__ballot_sync(FULL_MASK, ok_lane));
    if (lane == 0) count[(size_t)b * NW + wt] = (float)n;
  }
}

struct Plan {
  int NW, warps, tiles, sg, groups, ch, rows_smem;
  bool staged;
};

// How a [B, T] batch against S speakers of kp rows is cut: warp tiles an
// utterance; warps a block, as many as the shared memory left beside the
// rows' buffers holds (an utterance's tiles split evenly over its blocks);
// speakers a group (the whole bank once the grid fills the card).
cudaError_t make_plan(int B, int T, int d, int S, int kp, Plan* p) {
  int nsm = 0;
  const cudaError_t err = sm_count(&nsm);
  if (err != cudaSuccess) return err;
  const int RW = mma_row_words(d);
  p->staged = mma_depth(d) <= MAX_STAGED_DK;
  int most = MAX_WARPS;
  if (p->staged) {
    int chunked;
    mma_chunk(1 << 30, RW, 0, &chunked);  // the two chunk buffers' bytes
    const int rows_most = std::max(ONE_BUFFER, chunked);
    most = std::min(MAX_WARPS, (BLOCK_SMEM - rows_most) / (WF * RW * 4));
  }
  p->NW = std::max(1, (T + WF - 1) / WF);
  p->tiles = (p->NW + most - 1) / most;
  p->warps = (p->NW + p->tiles - 1) / p->tiles;
  const long long blocks = (long long)p->tiles * B;
  const long long want = (long long)BLOCKS_PER_SM * nsm;
  const int groups = (int)std::min<long long>(
      S, std::max<long long>(1, (want + blocks - 1) / blocks));
  p->sg = std::max((S + groups - 1) / groups, (S + 65534) / 65535);
  p->groups = (S + p->sg - 1) / p->sg;
  p->rows_smem = 0;
  p->ch = p->sg * kp;
  if (p->staged) p->ch = mma_chunk(p->sg * kp, RW, ONE_BUFFER, &p->rows_smem);
  return cudaSuccess;
}

// Once per device and instantiation: the most dynamic shared memory a
// launch of it may ask for.
template <class Frames, bool STAGED>
cudaError_t prepare(int dev) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  if (!STAGED) return cudaSuccess;  // no dynamic shared memory
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        bank_score_bf16_kernel<Frames, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  });
  return err[dev];
}

// One launch per MAX_GRID_Y utterances of the B in the call (a block's work
// depends on its utterance, tile and speaker group alone).
template <class Frames, bool STAGED>
cudaError_t launch(const Plan& p, int B, cudaStream_t st, const float* feats,
                   const unsigned char* mask, const uint32_t* comp,
                   float* partial, float* count, int T, int d, int S, int kp,
                   int dev) {
  cudaError_t err = prepare<Frames, STAGED>(dev);
  if (err != cudaSuccess) return err;
  const int smem =
      STAGED ? p.rows_smem + p.warps * WF * mma_row_words(d) * 4 : 0;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const dim3 grid(p.tiles, std::min(MAX_GRID_Y, B - b0), p.groups);
    bank_score_bf16_kernel<Frames, STAGED><<<grid, 32 * p.warps, smem, st>>>(
        feats + (size_t)b0 * T * d, mask + (size_t)b0 * T, comp,
        partial + (size_t)b0 * p.NW * S, count + (size_t)b0 * p.NW, T, d, S,
        kp, p.sg, p.ch, p.NW, p.rows_smem);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_all(const void* feats, const void* mask, const void* comp,
                       void* scratch, void* out, int B, int T, int d, int S,
                       int K, int dev, cudaStream_t st) {
  Plan p;
  const int kp = mma_components(K);
  cudaError_t err = make_plan(B, T, d, S, kp, &p);
  if (err != cudaSuccess) return err;
  const float* xf = (const float*)feats;
  const unsigned char* mk = (const unsigned char*)mask;
  const uint32_t* cp = (const uint32_t*)comp;
  float* partial = (float*)scratch;
  float* count = partial + (size_t)B * p.NW * S;
  err = p.staged
            ? launch<SmemFrames, true>(p, B, st, xf, mk, cp, partial, count,
                                       T, d, S, kp, dev)
            : launch<GlobalFrames<true>, false>(p, B, st, xf, mk, cp, partial,
                                                count, T, d, S, kp, dev);
  if (err != cudaSuccess) return err;
  const long long BS = (long long)B * S;
  bank_mean_kernel<<<(unsigned)((BS + RT - 1) / RT), RT, 0, st>>>(
      partial, count, (float*)out, BS, S, p.NW);
  return cudaGetLastError();
}

}  // namespace

// The launch of a [B, T] batch at feature dimension d against S speakers
// of K components on the current device: out[0] its warps a block, out[1]
// its dynamic shared memory in bytes, out[2] its resident blocks an SM by
// the occupancy API. Returns a CUDA error code.
extern "C" int srt_bank_bf16_occupancy(int B, int T, int d, int S, int K,
                                       int* out) {
  if (B < 1 || d < 1 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(B, T, d, S, mma_components(K), &p);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  out[0] = p.warps;
  out[1] = p.staged ? p.rows_smem + p.warps * WF * mma_row_words(d) * 4 : 0;
  if (p.staged) {
    if ((err = prepare<SmemFrames, true>(dev)) != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], bank_score_bf16_kernel<SmemFrames, true>, 32 * p.warps,
        out[1]);
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], bank_score_bf16_kernel<GlobalFrames<true>, false>,
      32 * p.warps, 0);
}

// 32-bit words of a row of GmmBank.mma_operator at feature dimension d
// (the layout of csrc/gmm_mma.cuh), or -1 for d < 1; the bf16 values a row
// holds are twice that.
extern "C" int srt_mma_row(int d) { return d < 1 ? -1 : 2 * mma_row_words(d); }

// Components a speaker's rows are padded to, or -1 for K < 1.
extern "C" int srt_mma_components(int K) {
  return K < 1 ? -1 : mma_components(K);
}

// Frames a warp tile takes: the scratch of a call is B * NW * (S + 1)
// floats, NW = max(1, ceil(T / this)).
extern "C" int srt_bank_bf16_warp_frames() { return WF; }

// feats [B, T, d], mask [B, T] (bytes), comp the rows of GmmBank.mma_operator
// [S, srt_mma_components(K), srt_mma_row(d)] (bf16), scratch B * NW * (S +
// 1) floats; writes out [B, S] on device `device` (made current for the
// launch), stream `stream`. Any B: one launch per 65535 utterances.
extern "C" int srt_bank_avg_loglik_bf16(const void* feats, const void* mask,
                                        const void* comp, void* scratch,
                                        void* out, int B, int T, int d, int S,
                                        int K, int device, void* stream) {
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
