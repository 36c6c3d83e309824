// Fused predict monolith for Hopper (sm_90a), plain C interface.
//
// Replaces speaker_recognition_tpu/ops/pallas_predict.py:_run (K6,
// per-utterance scoring, optional bf16 DFT operands) and :_run_wide (K7,
// transposed batched scoring). Both compute one function, and both
// wrappers (ops/gpu_predict.py) launch this kernel, K6's with BF16 set:
// for utterance b, frames f < T = (Lp - flen)//fshift + 1, flen = 2*fshift,
// and nv = min(max(n_valid[b], 0), T) valid frames,
//     X = signals[b, f*fshift : f*fshift + flen] . D,  Y = X^2
//     ceps = log(max(Y . W, floor)) . dct, masked CMVN over the nv frames
//     lpc  = Levinson(Y . A), non-finite -> 0 (when A has columns)
//     ll[f, s] = logsumexp_k ([feat^2 | feat] . op + cw)[s*K + k],
//                floored: > -745 ? ll : log(1e-15)
//     out[b, s] = sum_{f < nv} ll[f, s] / max(nv, 1)
// BF16 rounds the samples and D to bf16 (nearest even) before the DFT
// product; the products and every sum stay f32.
//
// What bounds it on this card: the frontend's DFT product (~331 kFLOP of
// a frame's ~345 kFLOP at 8 kHz; the bank adds 4*d*S*K), on FP32 CUDA
// cores, against 4*fshift bytes of new signal per frame: compute-bound,
// 0.84 ms at the FP32 peak for 512 x 5 s at 8 kHz.
//
// What the design does about it. CMVN makes the utterance the unit: no
// frame can be scored before its utterance's mean and deviation are
// known. So this is one cooperative launch of a persistent grid (one
// 256-thread block per SM: the frontend's tile takes ~185 KB of shared
// memory at 8 kHz) in four phases, split by grid-wide barriers:
//   1. frontend tiles (csrc/packed_tile.cuh, the frontend kernel's own
//      stages): FT frames of one utterance -> pre-CMVN cepstra and LPC in
//      a feature scratch [B, T, d] in device memory, d floats a frame
//      (18.3 MB at the bench batch, most of it still in L2 when read).
//      The spectra and Y stay on chip. Tiles wholly past nv are skipped;
//   2. per utterance: the masked two-pass CMVN, in place;
//   3. per (speaker group, utterance, FS-frame tile): the group's
//      components staged in shared memory (once per block while the group
//      stays the same; a 4 x 32 bank is one group, an 80 x 256 bank 27
//      groups of 3 speakers), one (frame, speaker) pair per thread with the
//      online logsumexp of csrc/gmm_lse.cuh, then a fixed-order warp sum
//      over the tile's valid frames -> partial [B, tiles, S]; the
//      log-densities never leave the thread;
//   4. out[b, s] = the partials summed in tile order / max(nv, 1).
// Every sum runs in a fixed order with no atomics, and no result depends
// on which block took an item, so two calls give bitwise-equal scores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gmm_lse.cuh"
#include "packed_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FS = 128;   // frames per scoring tile
constexpr int CMVN_CG = NT / 32;

struct Args {
  const float* signals;  // [B, Lp]
  const int* n_valid;    // [B]
  const float* D;        // [flen, ncols]
  const float* W;        // [ncols, nmel]
  const float* A;        // [ncols, nac]
  const float* dct;      // [nmel, nceps]
  const float* op;       // [2d, S*K]
  const float* cw;       // [S*K]
  float* feat;           // scratch [B, T, d]
  float* partial;        // scratch [B, ceil(T/FS), S]
  float* out;            // [B, S]
  int B, Lp, T, flen, fshift, ncols, nmel, nac, nceps, d, S, K, sgroup, cmvn;
  float power_floor;
};

// floats of shared memory the scoring phase takes for sg speakers
__host__ __device__ constexpr int score_floats(int sg, int K, int d) {
  return sg * K * (2 * d + 1) + FS * (d + 1) + sg * FS;
}

__device__ __forceinline__ int valid_frames(const Args& a, int b) {
  return min(max(a.n_valid[b], 0), a.T);
}

template <int FT, int OPL, bool BF16>
__global__ void __launch_bounds__(NT, 1) fused_predict_kernel(const Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int d = a.d;

  // 1. frontend tiles -> pre-CMVN features
  const int nt1 = (a.T + FT - 1) / FT;
  for (long long it = blockIdx.x; it < (long long)a.B * nt1;
       it += gridDim.x) {
    const int b = (int)(it / nt1), f0 = (int)(it % nt1) * FT;
    const int nv = valid_frames(a, b);
    if (f0 >= nv) continue;  // block-uniform: no frame of the tile is read
    __syncthreads();  // the previous tile's readers of shared memory are done
    const float* sums = tile_sums<FT, OPL, BF16>(
        a.signals + (size_t)b * a.Lp + (size_t)f0 * a.fshift,
        a.Lp - f0 * a.fshift, a.D, a.W, a.A, smem, a.flen, a.fshift,
        a.ncols, a.nmel, a.nac, a.power_floor);
    tile_features<OPL>(sums, a.feat + ((size_t)b * a.T + f0) * d,
                       min(FT, a.T - f0), nv - f0, a.dct, a.nmel, a.nac,
                       a.nceps, true);
  }
  grid.sync();

  // 2. masked CMVN per utterance, in place
  if (a.cmvn) {
    auto red = reinterpret_cast<float (*)[32]>(smem);  // [CMVN_CG][32]
    float (*stat)[32] = red + CMVN_CG;                   // [2][32]
    for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
      __syncthreads();
      cmvn_utterance<CMVN_CG>(a.feat + (size_t)b * a.T * d,
                              valid_frames(a, b), d, a.nceps, tid % 32,
                              tid / 32, red, stat);
    }
    grid.sync();
  }

  // 3. per-tile, per-speaker sums of the floored log-likelihoods
  const int P = 2 * d + 1, XS = d + 1;
  const int SK = a.S * a.K;
  const int nt3 = (a.T + FS - 1) / FS;
  const int ngroups = (a.S + a.sgroup - 1) / a.sgroup;
  float* prm = smem;                                   // [sgroup][K][P]
  float* xt = prm + (size_t)a.sgroup * a.K * P;        // [FS][XS]
  float* llb = xt + FS * XS;                           // [sgroup][FS]
  const int warp = tid / 32, lane = tid % 32;
  const long long per_group = (long long)a.B * nt3;
  int staged_group = -1;
  for (long long it = blockIdx.x; it < ngroups * per_group;
       it += gridDim.x) {
    const int g = (int)(it / per_group);
    const int b = (int)(it % per_group / nt3), t0 = (int)(it % nt3) * FS;
    const int nf = min(FS, valid_frames(a, b) - t0);
    if (nf <= 0) continue;  // block-uniform; phase 4 reads no such tile
    const int s0 = g * a.sgroup, sg = min(a.sgroup, a.S - s0);
    __syncthreads();  // the previous item's readers of shared memory are done
    if (g != staged_group) {
      for (int i = tid; i < 2 * d * sg * a.K; i += NT) {
        const int j = i / (sg * a.K), sk = i % (sg * a.K);
        prm[sk * P + j] = a.op[(size_t)j * SK + s0 * a.K + sk];
      }
      for (int sk = tid; sk < sg * a.K; sk += NT)
        prm[sk * P + 2 * d] = a.cw[s0 * a.K + sk];
      staged_group = g;
    }
    const float* xb = a.feat + ((size_t)b * a.T + t0) * d;
    for (int i = tid; i < nf * d; i += NT) xt[(i / d) * XS + i % d] = xb[i];
    __syncthreads();
    for (int q = tid; q < nf * sg; q += NT) {
      const int f = q % nf, sl = q / nf;
      llb[sl * FS + f] =
          floored_lse(xt + f * XS, prm + (size_t)sl * a.K * P, d, a.K);
    }
    __syncthreads();
    for (int sl = warp; sl < sg; sl += NT / 32) {
      float v = 0.f;
      for (int f = lane; f < nf; f += 32) v += llb[sl * FS + f];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0)
        a.partial[((size_t)b * nt3 + t0 / FS) * a.S + s0 + sl] = v;
    }
  }
  grid.sync();

  // 4. per-utterance means
  for (long long i = (long long)blockIdx.x * NT + tid;
       i < (long long)a.B * a.S; i += (long long)gridDim.x * NT) {
    const int b = (int)(i / a.S), s = (int)(i % a.S);
    const int nv = valid_frames(a, b);
    float acc = 0.f;
    for (int t = 0; t < (nv + FS - 1) / FS; ++t)
      acc += a.partial[((size_t)b * nt3 + t) * a.S + s];
    a.out[i] = acc / fmaxf((float)nv, 1.f);
  }
}

// Speakers per scoring group: as many as fit beside a frame tile; 0 when
// not even one speaker's components fit.
int speaker_group(int S, int K, int d) {
  const int per = K * (2 * d + 1) + FS;
  const int room = MAX_SMEM / 4 - FS * (d + 1);
  return room < per ? 0 : std::min(S, room / per);
}

// The frontend tiling and the speaker group of a call; 0 when none fits.
int plan(int flen, int fshift, int nmel, int nac, int d, int S, int K,
         int* ft, int* opl, int* sgroup, int* smem) {
  if (!pick(flen, fshift, nmel + nac, ft, opl)) return 0;
  *sgroup = speaker_group(S, K, d);
  if (*sgroup < 1) return 0;
  const int floats = std::max({smem_floats(*ft, *opl, flen, fshift),
                              score_floats(*sgroup, K, d),
                              (CMVN_CG + 2) * 32});
  *smem = 4 * floats;
  return 1;
}

template <int FT, int OPL, bool BF16>
cudaError_t launch(const Args& a, int smem, cudaStream_t st) {
  const void* kern = (const void*)fused_predict_kernel<FT, OPL, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every block must be resident for the grid-wide barriers; more blocks
  // than the largest phase has items would only wait at them
  const int nt1 = (a.T + FT - 1) / FT, nt3 = (a.T + FS - 1) / FS;
  const int ngroups = (a.S + a.sgroup - 1) / a.sgroup;
  const long long items = std::max({(long long)a.B * nt1,
                                    (long long)ngroups * a.B * nt3,
                                    ((long long)a.B * a.S + NT - 1) / NT});
  const int grid = (int)std::max(1LL, std::min((long long)nsm * per_sm,
                                               items));
  void* params[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), params,
                                    (size_t)smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const Args& a, int ft, int opl, int smem,
                     cudaStream_t st) {
  if (ft == 128) return launch<128, 9, BF16>(a, smem, st);
  if (opl == 9) return launch<64, 9, BF16>(a, smem, st);
  return launch<64, 16, BF16>(a, smem, st);
}

}  // namespace

// Bytes of shared memory a block of the monolith takes for this geometry
// and bank, or -1 when nothing fits (nmel + nac > 128, frames too long, or
// one speaker's K components and a frame tile beyond a block's shared
// memory).
extern "C" int srt_fused_smem_bytes(int flen, int fshift, int nmel, int nac,
                                    int d, int S, int K) {
  int ft, opl, sgroup, smem;
  if (!plan(flen, fshift, nmel, nac, d, S, K, &ft, &opl, &sgroup, &smem))
    return -1;
  return smem;
}

// Floats of device scratch a call takes: the features [B, T, d] and the
// per-tile partial sums [B, ceil(T/FS), S].
extern "C" long long srt_fused_scratch_floats(int B, int T, int d, int S) {
  return (long long)B * T * d + (long long)B * ((T + FS - 1) / FS) * S;
}

extern "C" int srt_fused_predict(
    const void* signals, const void* n_valid, const void* D, const void* W,
    const void* A, const void* dct, const void* op, const void* cw,
    void* scratch, void* out, int B, int Lp, int T, int flen, int fshift,
    int ncols, int nmel, int nac, int nceps, int S, int K,
    float power_floor, int cmvn, int bf16, void* stream) {
  const int order = nac > 0 ? nac - 1 : 0;
  const int d = nceps + order;
  int ft, opl, sgroup, smem;
  if (!plan(flen, fshift, nmel, nac, d, S, K, &ft, &opl, &sgroup, &smem))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.signals = (const float*)signals;
  a.n_valid = (const int*)n_valid;
  a.D = (const float*)D;
  a.W = (const float*)W;
  a.A = (const float*)A;
  a.dct = (const float*)dct;
  a.op = (const float*)op;
  a.cw = (const float*)cw;
  a.feat = (float*)scratch;
  a.partial = a.feat + (size_t)B * T * d;
  a.out = (float*)out;
  a.B = B;
  a.Lp = Lp;
  a.T = T;
  a.flen = flen;
  a.fshift = fshift;
  a.ncols = ncols;
  a.nmel = nmel;
  a.nac = nac;
  a.nceps = nceps;
  a.d = d;
  a.S = S;
  a.K = K;
  a.sgroup = sgroup;
  a.cmvn = cmvn;
  a.power_floor = power_floor;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? dispatch<true>(a, ft, opl, smem, st)
                    : dispatch<false>(a, ft, opl, smem, st));
}
