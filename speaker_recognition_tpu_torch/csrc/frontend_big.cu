// K5 (the full-spectrum frontend) on the four-step route of N >= 32768
// points (csrc/rfft_big.cuh: a frame's spectrum on a block or a cluster of
// csrc/rfft_cluster.cuh up to 262144 points, the device-memory passes of
// csrc/rfft_passes.cuh past it), for Hopper (sm_90a), plain C interface:
// the route of csrc/frontend_fft.cu's function where one frame's spectrum
// no longer fits the FFT tile, chosen on N in the open (ops/gpu_frontend
// counts it in FULL_BIG_LAUNCHES). Also the route's scratch and operator
// shapes and its fused pass's split, which K1, K4 and the fused predict
// monolith share there. A file of its own so that it builds beside the
// tile's instantiations, and alone with csrc/rfft_cluster.cu
// (speaker_recognition_tpu_torch/tools/fft_ablation.py).

#include <cuda_runtime.h>

#include "rfft_big.cuh"

// Floats of scratch the route of N >= 32768 takes for chunks of `chunk`
// frames with nout outputs (csrc/rfft_big.cuh), or -1 when it does not
// take nfft.
extern "C" long long srt_big_scratch_floats(int nfft, int nout, int chunk) {
  if (!rfft_big::takes(nfft) || chunk < 1) return -1;
  return rfft_big::scratch_floats(nfft, nout, chunk);
}

// S, the bin ranges the route's fused pass splits a chunk of nfc frames of
// nbins bins into (1: no split): the rule's one statement, which
// chip_smoke.py and the tests read.
extern "C" int srt_big_ranges(int nfc, int nbins) {
  if (nfc < 1 || nbins < 1) return -1;
  return rfft_big::ranges(nfc, nbins);
}

// The packed operator the route of N >= 32768 takes (its fused power +
// projection pass, csrc/rfft_big.cuh): the layout of
// srt_fft_operator_shape, rows padded to the route's own operator chunk;
// -1 when the route does not take nfft.
extern "C" int srt_big_operator_shape(int nfft, int nout, int* rows,
                                      int* cols, int* chunks) {
  if (!rfft_big::takes(nfft) || nout < 1) return -1;
  const int opl = rfft::opl_of(nout);
  *chunks = rfft::out_chunks(nout);
  *rows = rfft_big::op_rows(nfft / 2 + 1, opl) * *chunks;
  *cols = rfft::nop(opl);
  return 0;
}

// K5 at an nfft-point FFT, nfft a power of two >= 32768: frames [n, flen]
// windowed and pre-emphasized, op the packed [mel | acorr] operator of
// srt_big_operator_shape, dct [nmel, nceps], scratch of
// srt_big_scratch_floats(nfft, nmel + nac, chunk); writes ceps [n, nceps]
// and r [n, nac].
extern "C" int srt_big_fft_frames(const void* frames, const void* op,
                                  const void* dct, void* ceps, void* r,
                                  void* scratch, int n, int flen, int nfft,
                                  int nmel, int nac, int nceps,
                                  float power_floor, int chunk,
                                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  // row f, folded (sample p plus p + N, p + 2N, ... of a frame longer
  // than N, in that order)
  srt_cluster::FrameSource fr{};
  fr.kind = srt_cluster::FrameSource::ROWS;
  fr.x = (const float*)frames;
  fr.flen = flen;
  return (int)rfft_big::frame_level(
      fr, n, chunk, nfft, (float*)scratch, (const float4*)op,
      (const float*)dct, (float*)ceps, (float*)r, nmel, nac, nceps,
      power_floor, true, (cudaStream_t)stream);
}
