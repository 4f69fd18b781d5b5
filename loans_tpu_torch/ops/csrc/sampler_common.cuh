// Pieces shared by the crop kernels' sources (separable_sampler.cu,
// rotated_sampler.cu): the launch width, the d theta scratch layout, the
// output positions as the plain PyTorch version forms them, the NaN fill of
// d images and the C error entry point. Each library includes this file;
// ops/_cuda.py hashes it into every library's build key.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerImage = 32;  // = _BWD_THETA_MAX_BLOCKS in stn.py

// Normalized output position u_i = -1 + step * i, as the plain version
// forms it.
__device__ __forceinline__ float out_pos(int i, float step) {
  return __fadd_rn(-1.0f, __fmul_rn(step, (float)i));
}

// Grid (blocks, N): fills d images of every image marked in nan_flags with
// NaN; blocks of unmarked images return at once.
__global__ void fill_nan_images_kernel(const int* __restrict__ nan_flags,
                                       float* __restrict__ d_images,
                                       int64_t per_image) {
  const int64_t n = blockIdx.y;
  if (nan_flags[n] == 0) return;
  const float nan = __int_as_float(0x7fc00000);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < per_image; e += (int64_t)gridDim.x * blockDim.x) {
    d_images[n * per_image + e] = nan;
  }
}

// Steps as the plain version forms them: 2 / (out - 1) in double, rounded
// once to float; 0 for a single output (u = -1).
float out_step(int out) {
  return out > 1 ? (float)(2.0 / (double)(out - 1)) : 0.0f;
}

}  // namespace

extern "C" const char* loans_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
