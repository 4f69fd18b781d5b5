// Separable (axis-aligned) bilinear crop, forward and backward: the CUDA
// kernels behind loans_tpu_torch.ops.stn.sample_separable_kernel.
//
// Replaces loans_tpu/ops/stn.py::_separable_kernel (the Pallas kernel that
// computes out[b, c] = ky . img[b, c] . kx^T with dense hat-weight
// matrices ky[i, y] = max(0, 1 - |p_i - y|) built in VMEM and contracted on
// the MXU) and, for the backward, the JAX VJP of sample_separable that its
// custom_vjp runs (loans_tpu/ops/stn.py:641-650, dense matmuls in XLA).
//
// Forward. What bounds it on Hopper: at the serving point (224x224x3
// float32 image, 75x75 crop) each output reads at most 4 taps of a 602 KB
// image and the crop written is 67.5 KB, so the work is memory traffic,
// not arithmetic: latency-bound at small batch, bandwidth-bound at large
// batch. The dense ky . img . kx^T would spend about 30 MFLOP per image
// multiplying zeros. What the design does about it: a hat row has at most
// two non-zero taps, y0 = floor(p) and y0 + 1, so the product is exactly a
// 4-tap bilinear read with zero padding. One thread computes one output
// element (n, i, j, c) from those taps, in NHWC in and out (no transposes
// around the call; neighbouring threads write neighbouring addresses),
// with the weights and sum in float32 and 64-bit offsets. Sampling
// positions and hat weights are evaluated with the same float32
// operations, in the same order, as the plain PyTorch version
// (sample_separable), and the sum contracts rows first, then columns, as
// its two matmuls do.
//
// Backward, d theta (separable_sampler_bwd_theta). Per image it needs four
// sums over every output element (i, j, c): g * dout/dp_y times u_i and
// alone, g * dout/dp_x times u_j and alone. Each element reads its taps as
// the forward does, plus the row or column floor(p) - 1, where the hat's
// derivative is non-zero when p is an integer (JAX's subgradients: -1 at
// d = 0, -0.5 * sign(d) at |d| = 1, see hat_grad). What bounds it: at
// N = 64 it reads g (4.3 MB) and at most the touched image region
// (38.5 MB), a few microseconds of HBM time, and does a few dozen flops
// per element; with one small reduction per image it is latency- and
// reduction-bound. The design: a fixed number of blocks per image (up to
// kMaxBlocksPerImage, from the crop size only), each thread summing a
// fixed strided set of elements, a shared-memory tree reduction in a
// fixed order per block, and a second small kernel adding the blocks'
// partial sums in order. No float atomics, so the result is
// deterministic. Positions come from the forward's sample_pos, so the two
// kernels agree on which taps are ties. A NaN position gives NaN in that
// image's d theta, as the dense product would.
//
// Backward, d images (separable_sampler_bwd_images): d img = ky^T . g . kx,
// scattered: each output element adds g * hat_y * hat_x to its <= 4 taps
// with float atomics after the buffer is zeroed. The order of those sums
// changes from run to run, so results agree with the plain version to a
// tolerance of float32 rounding, not bit for bit. What bounds it: writing
// the whole (N, H, W, C) gradient (38.5 MB at N = 64), bytes. A NaN
// position fills that image's gradient with NaN, as the dense product
// would. Not launched on the training path, whose images need no grad.

#include "sampler_common.cuh"

namespace {

constexpr int kElementsPerBlock = 2048;

// Input pixel sampled by output index i along one axis:
// p = (scale * u + shift + 1) * half, with u = -1 + step * i and
// half = (in - 1) / 2. The _rn intrinsics keep nvcc from contracting the
// products into FMAs, so p matches the plain version bit for bit.
__device__ __forceinline__ float sample_pos(float scale, float shift, int i,
                                            float step, float half) {
  const float u = out_pos(i, step);
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(scale, u), shift), 1.0f),
                   half);
}

// Hat weight max(0, 1 - |p - j|) of input index j.
__device__ __forceinline__ float hat(float p, int j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, (float)j))));
}

// d hat / dp at d = p - j with JAX's subgradients of maximum(0, 1 - abs(d)):
// abs'(0) = +1; the maximum ties with 0 at |d| = 1 and passes half.
__device__ __forceinline__ float hat_grad(float d) {
  const float s = d >= 0.0f ? 1.0f : -1.0f;
  const float a = fabsf(d);
  return a < 1.0f ? -s : (a == 1.0f ? -0.5f * s : 0.0f);
}

// First tap floor(p) when some tap {floor(p), floor(p) + 1} lies in
// [0, size - 1]; otherwise a value whose taps are both outside.
__device__ __forceinline__ int first_tap(float p, int size) {
  const float f = floorf(p);
  return (f >= -1.0f && f <= (float)(size - 1)) ? (int)f : size;
}

// Weights and derivatives of the three taps floor(p) - 1 + k, k = 0..2
// (zero for taps outside [0, size - 1]); returns the first tap.
__device__ __forceinline__ int axis_taps(float p, int size, float w[3],
                                         float dw[3]) {
  const float f = floorf(p);
  const int first = (f >= -2.0f && f <= (float)size) ? (int)f - 1 : size + 1;
  for (int k = 0; k < 3; ++k) {
    const int t = first + k;
    const bool in = t >= 0 && t < size;
    w[k] = in ? hat(p, t) : 0.0f;
    dw[k] = in ? hat_grad(__fsub_rn(p, (float)t)) : 0.0f;
  }
  return first;
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

// Grid (blocks_per_image, N). Block s of image n sums elements
// e = s * kThreads + tid + k * blocks_per_image * kThreads of that image
// and writes its four sums to partial[n][s][0..3]:
// [sum g*dout/dpy*u_i, sum g*dout/dpy, sum g*dout/dpx*u_j, sum g*dout/dpx].
__global__ void __launch_bounds__(kThreads) separable_sampler_bwd_theta_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    const float* __restrict__ g, float* __restrict__ partial, int h, int w,
    int c, int h_out, int w_out, float step_y, float step_x,
    int64_t per_image, int blocks_per_image) {
  __shared__ float red[4][kThreads];
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const float* t = theta + n * 6;
  const float sx = __ldg(t + 0), tx = __ldg(t + 2);
  const float sy = __ldg(t + 4), ty = __ldg(t + 5);
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  const float* img = images + n * (int64_t)h * w * c;
  const float* gn = g + n * per_image;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t e = (int64_t)s * kThreads + tid; e < per_image;
       e += (int64_t)blocks_per_image * kThreads) {
    const int ch = (int)(e % c);
    const int64_t rest = e / c;
    const int j = (int)(rest % w_out);
    const int i = (int)(rest / w_out);
    const float py = sample_pos(sy, ty, i, step_y, half_y);
    const float px = sample_pos(sx, tx, j, step_x, half_x);
    if (isnan(py) || isnan(px)) {
      const float nan = __int_as_float(0x7fc00000);
      acc[0] = acc[1] = acc[2] = acc[3] = nan;
      continue;
    }
    float wy[3], dwy[3], wx[3], dwx[3];
    const int y_first = axis_taps(py, h, wy, dwy);
    const int x_first = axis_taps(px, w, wx, dwx);
    float d_py = 0.0f, d_px = 0.0f;  // dout/dp_y, dout/dp_x
    for (int kx = 0; kx < 3; ++kx) {
      if (wx[kx] == 0.0f && dwx[kx] == 0.0f) continue;
      const int x = x_first + kx;
      float col = 0.0f, dcol = 0.0f;  // rows first, as ky . img
      for (int ky = 0; ky < 3; ++ky) {
        if (wy[ky] == 0.0f && dwy[ky] == 0.0f) continue;
        const float v = __ldg(img + ((int64_t)(y_first + ky) * w + x) * c + ch);
        col += wy[ky] * v;
        dcol += dwy[ky] * v;
      }
      d_py += wx[kx] * dcol;
      d_px += dwx[kx] * col;
    }
    const float gv = __ldg(gn + e);
    const float gy = gv * d_py, gx = gv * d_px;
    acc[0] += gy * out_pos(i, step_y);
    acc[1] += gy;
    acc[2] += gx * out_pos(j, step_x);
    acc[3] += gx;
  }
  for (int k = 0; k < 4; ++k) red[k][tid] = acc[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      for (int k = 0; k < 4; ++k) red[k][tid] += red[k][tid + stride];
    }
    __syncthreads();
  }
  if (tid < 4) partial[(n * kMaxBlocksPerImage + s) * 4 + tid] = red[tid][0];
}

// One thread per image: adds the blocks' partial sums in order and writes
// d theta (2, 3) = [[half_x*Sx1, 0, half_x*Sx0], [0, half_y*Sy1, half_y*Sy0]].
__global__ void separable_sampler_bwd_theta_finish_kernel(
    const float* __restrict__ partial, float* __restrict__ d_theta, int n,
    int blocks_per_image, float half_y, float half_x) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < blocks_per_image; ++s) {
    for (int k = 0; k < 4; ++k) {
      sum[k] += partial[((int64_t)b * kMaxBlocksPerImage + s) * 4 + k];
    }
  }
  float* d = d_theta + (int64_t)b * 6;
  d[0] = half_x * sum[2];
  d[1] = 0.0f;
  d[2] = half_x * sum[3];
  d[3] = 0.0f;
  d[4] = half_y * sum[0];
  d[5] = half_y * sum[1];
}

// One thread per output element (n, i, j, c), as the forward: adds
// g * hat_y * hat_x to the <= 4 taps of d images (zeroed before). A NaN
// position marks its image in nan_flags instead.
__global__ void separable_sampler_bwd_images_kernel(
    const float* __restrict__ theta, const float* __restrict__ g,
    float* __restrict__ d_images, int* __restrict__ nan_flags, int h, int w,
    int c, int h_out, int w_out, float step_y, float step_x, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  int64_t rest = idx / c;
  const int j = (int)(rest % w_out);
  rest /= w_out;
  const int i = (int)(rest % h_out);
  const int64_t n = rest / h_out;

  const float* t = theta + n * 6;
  const float py = sample_pos(__ldg(t + 4), __ldg(t + 5), i, step_y,
                              0.5f * (float)(h - 1));
  const float px = sample_pos(__ldg(t + 0), __ldg(t + 2), j, step_x,
                              0.5f * (float)(w - 1));
  if (isnan(py) || isnan(px)) {
    nan_flags[n] = 1;
    return;
  }
  const int y0 = first_tap(py, h);
  const int x0 = first_tap(px, w);
  const float gv = __ldg(g + idx);
  float* dimg = d_images + n * (int64_t)h * w * c + ch;
  for (int x = x0; x <= x0 + 1; ++x) {
    if (x < 0 || x >= w) continue;
    const float gx = hat(px, x) * gv;
    if (gx == 0.0f) continue;
    for (int y = y0; y <= y0 + 1; ++y) {
      if (y < 0 || y >= h) continue;
      const float wy = hat(py, y);
      if (wy == 0.0f) continue;
      atomicAdd(dimg + ((int64_t)y * w + x) * c, wy * gx);
    }
  }
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
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  separable_sampler_fwd_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      images, theta, out, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), total);
  return (int)cudaGetLastError();
}

// d theta (n, 2, 3) from images (n, h, w, c), theta (n, 2, 3) and the crop's
// cotangent g (n, h_out, w_out, c); partial is scratch of
// n * kMaxBlocksPerImage * 4 floats. All float32, contiguous, on card
// `device`. Two launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int separable_sampler_bwd_theta(const float* images,
                                           const float* theta, const float* g,
                                           float* partial, float* d_theta,
                                           int n, int h, int w, int c,
                                           int h_out, int w_out, int device,
                                           void* stream) {
  const int64_t per_image = (int64_t)h_out * w_out * c;
  if (n == 0 || per_image == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  int64_t blocks = (per_image + kElementsPerBlock - 1) / kElementsPerBlock;
  if (blocks > kMaxBlocksPerImage) blocks = kMaxBlocksPerImage;
  const dim3 grid((unsigned)blocks, (unsigned)n);
  separable_sampler_bwd_theta_kernel<<<grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
      images, theta, g, partial, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), per_image, (int)blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  separable_sampler_bwd_theta_finish_kernel<<<(n + kThreads - 1) / kThreads,
                                              kThreads, 0,
                                              (cudaStream_t)stream>>>(
      partial, d_theta, n, (int)blocks, 0.5f * (float)(h - 1),
      0.5f * (float)(w - 1));
  return (int)cudaGetLastError();
}

// d images (n, h, w, c) from theta (n, 2, 3) and the crop's cotangent g
// (n, h_out, w_out, c); nan_flags is scratch of n ints. All contiguous, on
// card `device`. A memset, the scatter, a second memset-sized pass only for
// images with a NaN position; returns the first CUDA error (0 on success).
extern "C" int separable_sampler_bwd_images(const float* theta, const float* g,
                                            float* d_images, int* nan_flags,
                                            int n, int h, int w, int c,
                                            int h_out, int w_out, int device,
                                            void* stream) {
  const int64_t per_image = (int64_t)h * w * c;
  if (n == 0 || per_image == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(d_images, 0,
                                    (size_t)n * per_image * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(nan_flags, 0, (size_t)n * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)n * h_out * w_out * c;
  if (total == 0) return 0;
  separable_sampler_bwd_images_kernel<<<(unsigned)((total + kThreads - 1) /
                                                   kThreads),
                                        kThreads, 0, st>>>(
      theta, g, d_images, nan_flags, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fill_nan_images_kernel<<<dim3(64, (unsigned)n), kThreads, 0, st>>>(
      nan_flags, d_images, per_image);
  return (int)cudaGetLastError();
}
