// The fused predict monolith's f32 route (the FFT tile) at FFT sizes
// 64, 128: one of the instantiation units csrc/predict_fused.cu
// dispatches to, each its own nvcc process.

#include "predict_fused.cuh"

namespace srt_fused {

cudaError_t launch_fft_64_128(const Args& a, int nfft, int opl,
                              cudaStream_t st) {
  return launch_fft_sizes<64, 128>(a, nfft, opl, st);
}

}  // namespace srt_fused
