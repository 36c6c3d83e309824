// The fused predict monolith's f32 route at an FFT of N >= 32768 points,
// where a frame's spectrum no longer fits the FFT tile: a route chosen on
// N in the open (ops/gpu_predict counts it in BIG_LAUNCHES), not a
// fallback. It computes the function of csrc/predict_fused.cuh in several
// launches on one stream:
//   1. per chunk of frames of the batch, the spectral stage of
//      csrc/rfft_big.cuh (up to N = 262144 a frame's power on a block or a
//      cluster, csrc/rfft_cluster.cuh; past it the column and row passes;
//      then the fused power + projection onto mel and autocorrelation) and
//      then the signal frontend's features of the
//      chunk (big_features_kernel, as K1's route there computes them: log,
//      DCT, Levinson) into the feature scratch [B, T, d], pre-CMVN;
//   2. the monolith's kernel on that scratch with its frontend phase
//      compiled out (ScoreTile): the masked CMVN per utterance, K2's
//      scoring loop (csrc/gmm_lse.cuh) and the per-utterance means.
// Every sum runs in a fixed order with no atomics, so two calls give the
// same bits.

#include "big_signal.cuh"
#include "predict_fused.cuh"
#include "rfft_big.cuh"

using namespace srt_fused;

// signals [B, Lp], n_valid [B], win [flen], op the packed [mel | acorr]
// operator of srt_big_operator_shape (csrc/frontend_big.cu), dct [nmel,
// nceps], comp the component rows [S, K, srt_fused_component_row(d)],
// scratch of srt_fused_scratch_floats(B, T, d, S), big of
// srt_big_scratch_floats(nfft, nmel + nac, chunk) (csrc/frontend_big.cu)
// for chunks of `chunk` frames;
// writes out [B, S]. nfft a power of two >= 32768.
extern "C" int srt_fused_predict_big(
    const void* signals, const void* n_valid, const void* win,
    const void* op, const void* dct, const void* comp,
    void* scratch, void* big, void* out, int B, int Lp, int T, int flen,
    int fshift, int nfft, int nmel, int nac, int nceps, int S, int K,
    float pre_emph, int preemph_first, float power_floor, int cmvn,
    int chunk, void* stream) {
  const long long n = (long long)B * T;
  if (B < 1 || T < 1 || S < 1 || K < 1 || !rfft_big::takes(nfft) ||
      2 * flen > nfft || chunk < 1 || chunk > 65535 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* nv = (const int*)n_valid;
  float* feat = (float*)scratch;
  const srt_cluster::FrameSource fr =
      signal_frames((const float*)signals, nv, (const float*)win, Lp, T,
                    fshift, flen, pre_emph, preemph_first);
  float* sc = (float*)big;
  for (int g0 = 0; g0 < (int)n; g0 += chunk) {
    const int nfc = (int)std::min<long long>(chunk, n - g0);
    cudaError_t err = srt_cluster::spectra(fr, g0, nfc, nfft, sc,
                                           (const float4*)op, nmel, nac,
                                           power_floor, false, st);
    if (err != cudaSuccess) return (int)err;
    big_features_kernel<<<nfc, 128, 0, st>>>(
        rfft_big::sums_rows(sc, nfft, nfc), nv, (const float*)dct, feat, T,
        g0, nmel, nac, nceps, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  Args a{};
  a.n_valid = nv;
  a.comp = (const float*)comp;
  a.feat = feat;
  a.out = (float*)out;
  a.B = B;
  a.T = T;
  a.nceps = nceps;
  a.d = feature_width(nceps, nac, 1);
  a.S = S;
  a.K = K;
  a.P = 2 * score_width(a.d) + 4;
  a.partial = feat + (size_t)B * T * a.d;
  a.cmvn = cmvn;
  return (int)with_frames<ScoreTile>(a, st);
}
