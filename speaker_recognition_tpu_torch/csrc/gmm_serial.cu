// Single-utterance speaker-bank scoring for Hopper (sm_90a), plain C
// interface: the serial and open-set path (GMMSet._scores, llr_scores).
//
// Replaces speaker_recognition_tpu/ops/pallas_gmm.py:_run (the kernel under
// bank_sum_loglik / bank_avg_loglik): for one utterance x [n, d] with mask
// [n] and a bank of S GMMs with K components each,
//     logp[t, k] = sum_j op[j, s*K+k] * [x_t^2 | x_t]_j + cw[s*K+k]
//     lse[t]     = logsumexp_k logp[t, k], floored: lse > -745 ? lse
//                                                         : log(1e-15)
//     out[s]     = sum_t mask[t] * lse[t]      (or / max(sum_t mask[t], 1))
// with op [2d, S*K] and cw [S*K] from models/gmm.bank_operators, read here
// component by component from GmmBank.component_operator (the row layout
// of csrc/gmm_lse.cuh). Unlike the TPU kernel it applies the floor, as
// models/gmm.per_frame_loglik does.
//
// What bounds it on this card: per frame and speaker it does 2*d*K FMAs
// and K exponentials against d floats of features; a speaker's parameters
// (K*P floats, 62 KB at K=256, d=28) are reused by every frame. At the
// serial path's few hundred frames the work is a few microseconds of the
// card, so what a decision pays is launches and the host around them: the
// TPU kernel carried a sum across its sequential grid, which on a GPU took
// a second kernel (and a scratch buffer) to add the chunks' partial sums
// in a fixed order.
//
// What the design does about it: one launch (one per 65535 speakers). The
// grid is (CL, S), and the CL <= 16 blocks of one speaker form a
// thread-block cluster. Block r of a cluster takes the frame chunks r, r +
// CL, ... (NT frames each) in order and keeps its sum and valid-frame count
// in registers, so a long clip needs no more blocks. It streams the
// speaker's component rows through shared memory with 16-byte asynchronous
// copies (all K rows in one buffer while they fit a block's shared memory,
// staged once for all its chunks; else chunks in two buffers, so K has no
// cap) and each lane keeps its frame's features in registers (RegFrames of
// csrc/gmm_lse.cuh, the inner loop the batched kernel shares): a parameter
// load is one broadcast for the warp's 32 frames and a_j x^2 + b_j x is x
// (a_j x + b_j), two FMAs in four independent chains. The route follows the
// feature dimension: registers up to a padded d of 128, and past that
// WideFrames, which leaves the frame and the rows in device memory and so
// takes any d. The logsumexp over components runs online. Each block sums
// its threads in a fixed order (warp butterflies, then the warps); after a
// cluster barrier rank 0 reads the other ranks' sums and valid-frame counts
// through distributed shared memory, adds them in rank order and writes
// out[s]. No partials buffer, no second kernel, no atomics: scores are the
// same bit for bit from run to run (calibrate_rejection thresholds on them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "gmm_lse.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;      // threads per block = frames per chunk
// blocks of a cluster, at most: 16 (the non-portable size Hopper allows)
// while two blocks fit on an SM, so that any GPC can hold the cluster;
// else the portable 8
constexpr int MAX_CLUSTER = 16;
constexpr int PORTABLE_CLUSTER = 8;
// a block's dynamic shared memory: what the static reduction arrays (and
// the alignment of the dynamic buffer after them) leave
constexpr int STATIC_SMEM = 1024;
constexpr int ONE_BUFFER = BLOCK_SMEM - STATIC_SMEM;

// Frames: RegFrames<DP, 1> or WideFrames; ch: rows per staged chunk.
template <class Frames>
__global__ void __launch_bounds__(NT) serial_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ comp, float* __restrict__ out, int n, int d,
    int K, int ch, int avg) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float warp_sc[2][NT / 32];       // the warps' sums and counts
  __shared__ float block_sc[2];               // the block's, for rank 0
  static_assert(sizeof(warp_sc) + sizeof(block_sc) + 16 <= STATIC_SMEM,
                "static shared memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int s = blockIdx.y, tid = threadIdx.x;
  const int P = row_floats(d);
  const int nchunks = n > 0 ? (n + NT - 1) / NT : 1;

  const RowStream st{comp + (size_t)s * K * P, sm, K, P, ch};
  if (Frames::STAGED) st.fetch(0);
  float acc = 0.f, cnt = 0.f;
  for (int c = rank; c < nchunks; c += CL) {
    // the rows of a streamed speaker come again for every chunk; staged
    // whole, they stay
    if (Frames::STAGED && ch < K && c != rank) {
      __syncthreads();  // every thread is done with the last chunk's rows
      st.fetch(0);
    }
    const int t = c * NT + tid;
    Frames fr;
    fr.load(0, t < n ? x + (size_t)t * d : nullptr, d);
    float lse = 0.f;
    walk_components(st, K, true, fr,
                    [&](int, OnlineLse (&v)[1]) { lse = v[0].floored(); });
    if (t < n && mask[t]) {
      acc += lse;
      cnt += 1.f;
    }
  }
  // the block's sum and count in a fixed order: a butterfly within each
  // warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (tid % 32 == 0) {
    warp_sc[0][tid / 32] = acc;
    warp_sc[1][tid / 32] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    float bs = 0.f, bc = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
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
// the most dynamic shared memory a launch of it may ask for.
template <class Frames>
cudaError_t prepare(int dev) {
  constexpr int MAX_DEVICES = 64;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t err[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        serial_kernel<Frames>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err[dev] == cudaSuccess && Frames::STAGED)
      err[dev] = cudaFuncSetAttribute(
          serial_kernel<Frames>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          ONE_BUFFER);
  });
  return err[dev];
}

// speakers a launch takes: the grid's y dimension
constexpr int MAX_GRID_Y = 65535;

// One launch per MAX_GRID_Y speakers (a speaker's cluster does the same work
// in any of them).
template <class Frames>
cudaError_t launch(int dev, int S, int smem, cudaStream_t st, const float* x,
                   const unsigned char* mask, const float* comp, float* out,
                   int n, int d, int K, int ch, int avg) {
  cudaError_t err = prepare<Frames>(dev);
  if (err != cudaSuccess) return err;
  const int nchunks = n > 0 ? (n + NT - 1) / NT : 1;
  const int most =
      2 * (smem + STATIC_SMEM) <= BLOCK_SMEM ? MAX_CLUSTER : PORTABLE_CLUSTER;
  const int CL = nchunks < most ? nchunks : most;
  const size_t P = row_floats(d);
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
    err = cudaLaunchKernelEx(&cfg, serial_kernel<Frames>, x, mask,
                             comp + (size_t)s0 * K * P, out + s0, n, d, K, ch,
                             avg);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Floats per component in GmmBank.component_operator at feature dimension
// d: the row both scoring kernels read.
extern "C" int srt_component_row(int d) { return d < 1 ? -1 : row_floats(d); }

// x [n, d], mask [n] (bytes), comp the component rows [S, K,
// srt_component_row(d)]; writes out [S]: sums, or averages over the valid
// frames when avg. One clustered launch on device `device` (made current
// for the launch), stream `stream`; one per 65535 speakers past that.
extern "C" int srt_bank_sum_loglik(const void* x, const void* mask,
                                   const void* comp, void* out, int n, int d,
                                   int S, int K, int avg, int device,
                                   void* stream) {
  if (d < 1 || K < 1 || S < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const unsigned char* mk = (const unsigned char*)mask;
  const float* cp = (const float*)comp;
  float* o = (float*)out;
  const int dp = padded_dim(d);
  if (dp > MAX_REG_DP) {
    err = launch<WideFrames>(device, S, 0, st, xf, mk, cp, o, n, d, K, K,
                             avg);
  } else {
    int smem;
    const int ch = plan_chunks(K, row_floats(d), ONE_BUFFER, &smem);
    switch (dp) {
#define SRT_SERIAL_CASE(DP)                                                 \
  case DP:                                                                  \
    err = launch<RegFrames<DP, 1>>(device, S, smem, st, xf, mk, cp, o, n, d, \
                                   K, ch, avg);                             \
    break;
      SRT_SERIAL_CASE(4) SRT_SERIAL_CASE(8) SRT_SERIAL_CASE(12)
      SRT_SERIAL_CASE(16) SRT_SERIAL_CASE(20) SRT_SERIAL_CASE(24)
      SRT_SERIAL_CASE(28) SRT_SERIAL_CASE(32) SRT_SERIAL_CASE(36)
      SRT_SERIAL_CASE(40) SRT_SERIAL_CASE(44) SRT_SERIAL_CASE(48)
      SRT_SERIAL_CASE(52) SRT_SERIAL_CASE(56) SRT_SERIAL_CASE(60)
      SRT_SERIAL_CASE(64) SRT_SERIAL_CASE(68) SRT_SERIAL_CASE(72)
      SRT_SERIAL_CASE(76) SRT_SERIAL_CASE(80) SRT_SERIAL_CASE(84)
      SRT_SERIAL_CASE(88) SRT_SERIAL_CASE(92) SRT_SERIAL_CASE(96)
      SRT_SERIAL_CASE(100) SRT_SERIAL_CASE(104) SRT_SERIAL_CASE(108)
      SRT_SERIAL_CASE(112) SRT_SERIAL_CASE(116) SRT_SERIAL_CASE(120)
      SRT_SERIAL_CASE(124) SRT_SERIAL_CASE(128)
#undef SRT_SERIAL_CASE
      default:
        err = cudaErrorInvalidValue;
    }
  }
  if (cur != device) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
