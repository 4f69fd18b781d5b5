// Separable (axis-aligned) bilinear crop, forward: the CUDA kernel behind
// loans_tpu_torch.ops.stn.sample_separable_kernel.
//
// Replaces loans_tpu/ops/stn.py::_separable_kernel (the Pallas kernel that
// computes out[b, c] = ky . img[b, c] . kx^T with dense hat-weight
// matrices ky[i, y] = max(0, 1 - |p_i - y|) built in VMEM and contracted on
// the MXU).
//
// What bounds it on Hopper: at the serving point (224x224x3 float32 image,
// 75x75 crop) each output reads at most 4 taps of a 602 KB image and the
// crop written is 67.5 KB, so the work is memory traffic, not arithmetic:
// latency-bound at small batch, bandwidth-bound at large batch. The dense
// ky . img . kx^T would spend about 30 MFLOP per image multiplying zeros.
//
// What the design does about it: a hat row has at most two non-zero taps,
// y0 = floor(p) and y0 + 1, so the product is exactly a 4-tap bilinear
// read with zero padding. One thread computes one output element
// (n, i, j, c) from those taps, in NHWC in and out (no transposes around
// the call; neighbouring threads write neighbouring addresses), with the
// weights and sum in float32 and 64-bit offsets. Sampling positions and
// hat weights are evaluated with the same float32 operations, in the same
// order, as the plain PyTorch version (sample_separable), and the sum
// contracts rows first, then columns, as its two matmuls do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Input pixel sampled by output index i along one axis:
// p = (scale * u + shift + 1) * half, with u = -1 + step * i and
// half = (in - 1) / 2. The _rn intrinsics keep nvcc from contracting the
// products into FMAs, so p matches the plain version bit for bit.
__device__ __forceinline__ float sample_pos(float scale, float shift, int i,
                                            float step, float half) {
  const float u = __fadd_rn(-1.0f, __fmul_rn(step, (float)i));
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(scale, u), shift), 1.0f),
                   half);
}

// Hat weight max(0, 1 - |p - j|) of input index j.
__device__ __forceinline__ float hat(float p, int j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, (float)j))));
}

// First tap floor(p) when some tap {floor(p), floor(p) + 1} lies in
// [0, size - 1]; otherwise a value whose taps are both outside.
__device__ __forceinline__ int first_tap(float p, int size) {
  const float f = floorf(p);
  return (f >= -1.0f && f <= (float)(size - 1)) ? (int)f : size;
}

__global__ void separable_sampler_fwd_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    float* __restrict__ out, int h, int w, int c, int h_out, int w_out,
    float step_y, float step_x, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  int64_t rest = idx / c;
  const int j = (int)(rest % w_out);
  rest /= w_out;
  const int i = (int)(rest % h_out);
  const int64_t n = rest / h_out;

  // theta (N, 2, 3) row-major: sx = t[0], tx = t[2], sy = t[4], ty = t[5].
  const float* t = theta + n * 6;
  const float py = sample_pos(__ldg(t + 4), __ldg(t + 5), i, step_y,
                              0.5f * (float)(h - 1));
  const float px = sample_pos(__ldg(t + 0), __ldg(t + 2), j, step_x,
                              0.5f * (float)(w - 1));
  if (isnan(py) || isnan(px)) {  // a NaN hat row poisons the dense product
    out[idx] = __int_as_float(0x7fc00000);
    return;
  }
  const int y0 = first_tap(py, h);
  const int x0 = first_tap(px, w);

  const float* img = images + n * (int64_t)h * w * c + ch;
  float acc = 0.0f;
  for (int x = x0; x <= x0 + 1; ++x) {
    if (x < 0 || x >= w) continue;
    float col = 0.0f;  // sum over rows, as ky . img
    for (int y = y0; y <= y0 + 1; ++y) {
      if (y < 0 || y >= h) continue;
      col += hat(py, y) * __ldg(img + ((int64_t)y * w + x) * c);
    }
    acc += hat(px, x) * col;  // then over columns, as (.) kx^T
  }
  out[idx] = acc;
}

}  // namespace

// images (n, h, w, c), theta (n, 2, 3), out (n, h_out, w_out, c): float32,
// contiguous, on card `device`; `stream` belongs to that card. Returns the
// CUDA error of selecting the card or of the launch (0 on success).
extern "C" int separable_sampler_fwd(const float* images, const float* theta,
                                     float* out, int n, int h, int w, int c,
                                     int h_out, int w_out, int device,
                                     void* stream) {
  const int64_t total = (int64_t)n * h_out * w_out * c;
  if (total == 0) return 0;
  // This library carries its own CUDA runtime, whose current card is not
  // PyTorch's: select it.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  // Steps as the plain version forms them: 2 / (out - 1) in double,
  // rounded once to float; 0 for a single output (u = -1).
  const float step_y = h_out > 1 ? (float)(2.0 / (double)(h_out - 1)) : 0.0f;
  const float step_x = w_out > 1 ? (float)(2.0 / (double)(w_out - 1)) : 0.0f;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  separable_sampler_fwd_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      images, theta, out, h, w, c, h_out, w_out, step_y, step_x, total);
  return (int)cudaGetLastError();
}

extern "C" const char* loans_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
