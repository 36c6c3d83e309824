// Single-utterance speaker-bank scoring with bf16 operands on the tensor
// cores, for Hopper (sm_90a), plain C interface: K3's precision="bf16".
//
// Replaces speaker_recognition_tpu/ops/pallas_gmm.py:_run with bf16 operands
// (bank_sum_loglik(precision="bf16"), :100, the casts at :136-140): for one
// utterance x [n, d] with mask [n] and a bank of S GMMs with K components,
//     logp[t, k] = [bf16(x^2) | bf16(x)] . [bf16(a_k) | bf16(b_k)] + cw_k
//                                                  (f32 accumulation)
//     lse[t]     = logsumexp_k logp[t, k], floored: > -745 ? lse : log(1e-15)
//     out[s]     = sum_t mask[t] * lse[t]      (or / max(sum_t mask[t], 1))
// with the bank as GmmBank.mma_operator rows (csrc/gmm_mma.cuh). x^2 is
// squared in f32 and rounded once, as the JAX wrapper rounds it (the
// batched kernel squares the rounded x instead). Unlike the TPU kernel it
// applies the floor, as the f32 serial kernel does (ROADMAP queue 3).
//
// What bounds it on this card: a serial decision's few hundred frames are
// microseconds of work (2*dk*kp products a frame and speaker), so what a
// decision pays is the launch and the host around it: one launch.
//
// What the design does: the f32 serial kernel's shape (csrc/gmm_serial.cu)
// with csrc/gmm_mma.cuh's tensor-core inner loop. The grid is (CL, S), the
// CL <= 16 blocks of one speaker a thread-block cluster. A block is 4 warps
// of 32 frames (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on two
// m16 tiles a warp); block r of a cluster takes the frame chunks r, r + CL,
// ... (128 frames each) in order, each warp staging its 32 frames as bf16
// rows in shared memory, and keeps its sum and valid-frame count in
// registers. The speaker's rows are staged once in shared memory while they
// fit beside the frames, else streamed in chunks for every frame chunk
// (no cap on K); past a depth of 512 the wide route builds the fragments
// from the frames in device memory and reads the rows where they lie (any
// d). A lane a quad adds its frames' floored logsumexps; each block sums its
// threads in a fixed order (warp butterflies, then the warps); after a
// cluster barrier rank 0 adds the ranks' sums and counts in rank order
// through distributed shared memory and writes out[s]. No atomics: the
// same bits from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "gmm_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // threads a block = frames a chunk
constexpr int MAX_CLUSTER = 16;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int STATIC_SMEM = 1024;
constexpr int MAX_GRID_Y = 65535;  // speakers a launch takes

// Frames: SmemFrames (STAGED) or GlobalFrames<false>; ch: rows a staged
// chunk; the warps' frame rows follow `rows_smem` bytes of rows.
template <class Frames, bool STAGED>
__global__ void __launch_bounds__(NT) serial_bf16_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const uint32_t* __restrict__ comp, float* __restrict__ out, int n, int d,
    int kp, int ch, int rows_smem, int avg) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float warp_sc[2][WARPS];  // the warps' sums and counts
  __shared__ float block_sc[2];        // the block's, for rank 0
  static_assert(sizeof(warp_sc) + sizeof(block_sc) + 16 <= STATIC_SMEM,
                "static shared memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int s = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int RW = mma_row_words(d), nks = mma_depth(d) / 16;
  const int nchunks = n > 0 ? (n + NT - 1) / NT : 1;

  const RowStream st{reinterpret_cast<const float*>(comp) +
                         (size_t)s * kp * RW,
                     sm, kp, RW, ch};
  if (STAGED) st.fetch(0);
  uint32_t* at = reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(sm) +
                                             rows_smem) +
                 (size_t)warp * WF * RW;
  float acc = 0.f, cnt = 0.f;
  for (int c = rank; c < nchunks; c += CL) {
    // the rows of a streamed speaker come again for every chunk; staged
    // whole, they stay
    if (STAGED && ch < kp && c != rank) {
      __syncthreads();  // every thread is done with the last chunk's rows
      st.fetch(0);
    }
    const int t0 = c * NT + warp * WF;
    const int nf = max(0, min(WF, n - t0));
    const bool ok_lane = lane < nf && mask[t0 + lane];
    const bool active = __any_sync(FULL_MASK, ok_lane);
    Frames fr;
    if constexpr (STAGED) {
      __syncwarp();  // the warp is done with the last chunk's frames
      if (active) stage_frames<false>(at, RW, x + (size_t)t0 * d, nf, d);
      fr = Frames{at, RW};
    } else {
      fr = Frames{x + (size_t)t0 * d, nf, d};
    }
    walk_mma<STAGED>(st, kp, nks, active, fr,
                     [&](int, OnlineLse (&lse)[MT][2]) {
      if (lane % 4 != 0) return;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = mt * 16 + lane / 4 + 8 * h;
          if (i < nf && mask[t0 + i]) acc += lse[mt][h].floored();
        }
    });
    cnt += ok_lane ? 1.f : 0.f;
  }
  // the block's sum and count in a fixed order: a butterfly within each
  // warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(FULL_MASK, acc, off);
    cnt += __shfl_xor_sync(FULL_MASK, cnt, off);
  }
  if (lane == 0) {
    warp_sc[0][warp] = acc;
    warp_sc[1][warp] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    float bs = 0.f, bc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      bs += warp_sc[0][w];
      bc += warp_sc[1][w];
    }
    block_sc[0] = bs;
    block_sc[1] = bc;
  }
  cluster.sync();  // every rank's block_sc is final
  if (rank == 0 && tid == 0) {
    float tot = 0.f, tcnt = 0.f;
    for (int q = 0; q < CL; ++q) {
      const float* sc = cluster.map_shared_rank(&block_sc[0], q);
      tot += sc[0];
      tcnt += sc[1];
    }
    out[s] = avg ? tot / fmaxf(tcnt, 1.f) : tot;
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// Once per device and instantiation: clusters past the portable size, and
// the most dynamic shared memory a launch may ask for.
template <class Frames, bool STAGED>
cudaError_t prepare(int dev) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        serial_bf16_kernel<Frames, STAGED>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err[dev] == cudaSuccess && STAGED)
      err[dev] = cudaFuncSetAttribute(
          serial_bf16_kernel<Frames, STAGED>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          BLOCK_SMEM - STATIC_SMEM);
  });
  return err[dev];
}

// One launch per MAX_GRID_Y speakers (a speaker's cluster does the same work
// in any of them).
template <class Frames, bool STAGED>
cudaError_t launch(int dev, int S, cudaStream_t st, const float* x,
                   const unsigned char* mask, const uint32_t* comp,
                   float* out, int n, int d, int kp, int avg) {
  cudaError_t err = prepare<Frames, STAGED>(dev);
  if (err != cudaSuccess) return err;
  const int RW = mma_row_words(d);
  int rows_smem = 0, ch = kp, smem = 0;
  if (STAGED) {
    const int frames_smem = WARPS * WF * RW * 4;
    ch = mma_chunk(kp, RW, BLOCK_SMEM - STATIC_SMEM - frames_smem,
                   &rows_smem);
    smem = rows_smem + frames_smem;
  }
  const int nchunks = n > 0 ? (n + NT - 1) / NT : 1;
  const int most =
      2 * (smem + STATIC_SMEM) <= BLOCK_SMEM ? MAX_CLUSTER : PORTABLE_CLUSTER;
  const int CL = nchunks < most ? nchunks : most;
  for (int s0 = 0; s0 < S; s0 += MAX_GRID_Y) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL, S - s0 < MAX_GRID_Y ? S - s0 : MAX_GRID_Y);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, serial_bf16_kernel<Frames, STAGED>, x,
                             mask, comp + (size_t)s0 * kp * RW, out + s0, n,
                             d, kp, ch, rows_smem, avg);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x [n, d], mask [n] (bytes), comp the rows of GmmBank.mma_operator [S,
// srt_mma_components(K), srt_mma_row(d)] (bf16; csrc/gmm_score_bf16.cu);
// writes out [S]: sums, or averages over the valid frames when avg. One
// clustered launch on device `device` (made current for the launch), stream
// `stream`; one per 65535 speakers past that.
extern "C" int srt_bank_sum_loglik_bf16(const void* x, const void* mask,
                                        const void* comp, void* out, int n,
                                        int d, int S, int K, int avg,
                                        int device, void* stream) {
  if (d < 1 || K < 1 || S < 1 || n < 0) return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const float* xf = (const float*)x;
  const unsigned char* mk = (const unsigned char*)mask;
  const uint32_t* cp = (const uint32_t*)comp;
  const int kp = mma_components(K);
  cudaStream_t st = (cudaStream_t)stream;
  err = mma_depth(d) <= MAX_STAGED_DK
            ? launch<SmemFrames, true>(device, S, st, xf, mk, cp, (float*)out,
                                       n, d, kp, avg)
            : launch<GlobalFrames<false>, false>(device, S, st, xf, mk, cp,
                                                 (float*)out, n, d, kp, avg);
  if (cur != device) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
