// Fused predict monolith for Hopper (sm_90a), plain C interface: the
// entry points and the bf16 route's instantiations. The kernel, its design
// notes and its launch are in csrc/predict_fused.cuh; the f32 route's
// instantiations by FFT size in csrc/predict_fused_n*.cu.

#include "predict_fused.cuh"

using namespace srt_fused;

// Floats of a component row the monolith reads at feature dimension d
// (GmmBank.component_operator's row at this width), or -1 for d < 1.
extern "C" int srt_fused_component_row(int d) {
  return d < 1 ? -1 : 2 * score_width(d) + 4;
}

// Floats of device scratch a call takes: the features [B, T, d] and the
// warp tiles' partial sums [B][NW][S], NW = ceil(T / 32) (the most any
// route takes).
extern "C" long long srt_fused_scratch_floats(int B, int T, int d, int S) {
  return (long long)B * T * d + (long long)B * std::max(1, (T + 31) / 32) * S;
}

// Floats of device scratch the bf16 route takes past 128 mel +
// autocorrelation outputs: rows [B * T][128 * chunks] of the sums; 0 up to
// 128 outputs.
extern "C" long long srt_fused_bf16_wide_floats(int B, int T, int nout) {
  const int c = dense_chunks(nout);
  return c > 1 ? (long long)B * T * 128 * c : 0;
}

// The monolith's resident blocks an SM on the bf16 tile Tile with smem
// bytes, at the scoring route of feature dimension d.
template <class Tile>
cudaError_t bf16_tile_blocks(int d, int smem, int* blocks) {
  auto occupancy = [&](auto kern) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, (const void*)kern, Tile::NTH, smem);
  };
  switch (score_width(d)) {
    case 32: return occupancy(fused_predict_kernel<Tile, RegFrames<32, 2>>);
    case MAX_REG_DP:
      return occupancy(fused_predict_kernel<Tile, RegFrames<MAX_REG_DP, 1>>);
  }
  return occupancy(fused_predict_kernel<Tile, WideFrames>);
}

// The bf16 route's tile at a geometry (csrc/packed_tile.cuh pick) for a
// feature dimension d on the current device: its frames a tile, 8 x its
// outputs a lane, whether it reads the samples from device memory, its
// output chunks, its dynamic shared memory in bytes and the monolith's
// resident blocks an SM by the occupancy API, into out[6]. Returns a CUDA
// error code.
extern "C" int srt_fused_bf16_tile(int flen, int fshift, int nout, int d,
                                   int* out) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  pick(flen, fshift, nout, &out[0], &out[1], &out[2]);
  out[3] = dense_chunks(nout);
  const int ft = out[0], opl = out[1], gseg = out[2];
  const int smem = smem_bytes(ft, opl, flen, fshift, gseg);
  out[4] = smem;
  int* blocks = &out[5];
  if (ft == 128)
    return (int)bf16_tile_blocks<DenseBf16Tile<128, 9>>(d, smem, blocks);
  if (ft == 64 && opl == 9)
    return (int)bf16_tile_blocks<DenseBf16Tile<64, 9>>(d, smem, blocks);
  if (ft == 64)
    return (int)bf16_tile_blocks<DenseBf16Tile<64, 16>>(d, smem, blocks);
  if (opl == 9)
    return (int)(gseg
        ? bf16_tile_blocks<DenseBf16Tile<32, 9, true>>(d, smem, blocks)
        : bf16_tile_blocks<DenseBf16Tile<32, 9>>(d, smem, blocks));
  return (int)(gseg
      ? bf16_tile_blocks<DenseBf16Tile<32, 16, true>>(d, smem, blocks)
      : bf16_tile_blocks<DenseBf16Tile<32, 16>>(d, smem, blocks));
}

// signals [B, Lp], n_valid [B], comp the component rows [S, K,
// srt_fused_component_row(d)], dct [nmel, nceps], scratch of
// srt_fused_scratch_floats; writes out [B, S]. bf16 == 0: the FFT route,
// win [flen] and op the packed operator of srt_fft_operator_shape at nfft
// (csrc/frontend_fft.cu), nfft at most 16384, and past 512 outputs wsums
// the srt_fft_wide_floats(B * T, nmel + nac) floats of the sums rows; D
// and WA unread.
// bf16 != 0: the dense route with D [flen, ncols] packed as bf16
// (ops/gpu_frontend.dft_mma_operator), WA the packed W [ncols, nmel] | A
// [ncols, nac] (dense_wa_operator) and wsums of
// srt_fused_bf16_wide_floats; win, op and nfft unread.
extern "C" int srt_fused_predict(
    const void* signals, const void* n_valid, const void* win,
    const void* op, const void* D, const void* WA,
    const void* dct, const void* comp, void* scratch, void* wsums, void* out,
    int B,
    int Lp, int T, int flen, int fshift, int nfft, int ncols, int nmel,
    int nac, int nceps, int S, int K, float pre_emph, int preemph_first,
    float power_floor, int cmvn, int bf16, void* stream) {
  if (B < 1 || T < 1 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.signals = (const float*)signals;
  a.n_valid = (const int*)n_valid;
  a.win = (const float*)win;
  a.op = (const float4*)op;
  a.D = (const uint4*)D;
  a.WA = (const uint4*)WA;
  a.dct = (const float*)dct;
  a.comp = (const float*)comp;
  a.feat = (float*)scratch;
  a.out = (float*)out;
  a.wsums = (float*)wsums;
  a.nchunk = 1;
  a.B = B;
  a.Lp = Lp;
  a.T = T;
  a.flen = flen;
  a.fshift = fshift;
  a.ncols = ncols;
  a.nmel = nmel;
  a.nac = nac;
  a.nceps = nceps;
  a.d = nceps + (nac > 0 ? nac - 1 : 0);
  a.S = S;
  a.K = K;
  a.P = 2 * score_width(a.d) + 4;
  a.partial = a.feat + (size_t)B * T * a.d;
  a.cmvn = cmvn;
  a.preemph_first = preemph_first;
  a.pre_emph = pre_emph;
  a.power_floor = power_floor;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    int ft, opl, gseg;
    pick(flen, fshift, nmel + nac, &ft, &opl, &gseg);
    a.nchunk = dense_chunks(nmel + nac);
    if (a.nchunk > 1 && wsums == nullptr) return (int)cudaErrorInvalidValue;
    if (ft == 128) return (int)with_frames<DenseBf16Tile<128, 9>>(a, st);
    if (ft == 64 && opl == 9)
      return (int)with_frames<DenseBf16Tile<64, 9>>(a, st);
    if (ft == 64) return (int)with_frames<DenseBf16Tile<64, 16>>(a, st);
    if (opl == 9)
      return (int)(gseg ? with_frames<DenseBf16Tile<32, 9, true>>(a, st)
                        : with_frames<DenseBf16Tile<32, 9>>(a, st));
    return (int)(gseg ? with_frames<DenseBf16Tile<32, 16, true>>(a, st)
                      : with_frames<DenseBf16Tile<32, 16>>(a, st));
  }
  const int opl = rfft::pick_opl(nfft, nmel + nac, true);
  if (opl == 0 || 2 * flen > nfft) return (int)cudaErrorInvalidValue;
  a.nchunk = rfft::out_chunks(nmel + nac);
  if (a.nchunk > 1 && wsums == nullptr) return (int)cudaErrorInvalidValue;
  if (nfft <= 128) return (int)launch_fft_64_128(a, nfft, opl, st);
  if (nfft <= 512) return (int)launch_fft_256_512(a, nfft, opl, st);
  if (nfft <= 2048) return (int)launch_fft_1024_2048(a, nfft, opl, st);
  if (nfft <= 4096) return (int)launch_fft_4096(a, nfft, opl, st);
  return (int)launch_fft_8192_16384(a, nfft, opl, st);
}
