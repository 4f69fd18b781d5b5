// Rotated (general-affine) bilinear crop, forward and backward: the CUDA
// kernels behind loans_tpu_torch.ops.stn.sample_rotated_kernel.
//
// Replaces loans_tpu/ops/stn.py::_rotated_kernel (the Pallas kernel that,
// per image and output row i, builds dense hat-weight matrices over all W
// input columns and H input rows in VMEM and contracts them on the MXU:
// out[i, j] = sum_y hat(py - y) sum_x hat(px - x) img[y, x]) and, for the
// backward, the analytic VJP that its custom_vjp runs
// (_rotated_dense_bwd_impl, loans_tpu/ops/stn.py:256-356, dense per-row
// matmuls in XLA). Sampling positions, for output (i, j):
//   px = (((t00 * u_j + t01 * v_i) + t02) + 1) * (W - 1) / 2,
//   py = (((t10 * u_j + t11 * v_i) + t12) + 1) * (H - 1) / 2,
// in that order, with u_j = -1 + step_x * j and v_i = -1 + step_y * i, all
// float32 with the _rn intrinsics (no FMA contraction), exactly as the
// plain PyTorch version (stn._rotated_positions) forms them. So the kernels
// and the plain version agree bit for bit on the positions and on which
// taps are ties.
//
// Forward (rotated_sampler_fwd). A hat has at most two non-zero taps per
// axis, floor(p) and floor(p) + 1, so the dense contraction is exactly a
// 4-tap bilinear read with zero padding; the TPU's per-row matrix products
// (about 100 GFLOP per call at N = 64, almost all of them on zeros) are not
// carried over. One thread computes one output element (n, i, j, c), NHWC
// in and out, with 64-bit offsets, float32 weights and sum: over the two
// column taps of each row tap, then over the rows, in the plain version's
// order with _rn operations, so the two agree bit for bit. What bounds it
// on Hopper: memory traffic. Unlike the axis-aligned crop, the taps of
// neighbouring outputs lie on a rotated footprint, so a warp's reads
// scatter across image rows; at N = 64 the images (38.5 MB) fit in the
// 50 MB L2, so repeated taps come from L2. Bound: bytes, the crop written
// plus the distinct taps touched.
//
// Backward, d theta (rotated_sampler_bwd_theta). Per output pixel (i, j):
//   gpx = (W - 1) / 2 * sum_c g * sum_y hat(py - y) sum_x hat'(px - x) img,
//   gpy = (H - 1) / 2 * sum_c g * sum_y hat'(py - y) sum_x hat(px - x) img,
// with the dense VJP's subgradient hat'(d) = -sign(d) on |d| < 1 and 0
// elsewhere: 0 at d = 0, so a position exactly on a pixel contributes
// nothing (unlike the separable crop's JAX-autodiff rule). hat' is non-zero
// only where hat is, so the same 2 x 2 taps serve both. Six sums per image:
// gpx * u_j, gpx * v_i, gpx, gpy * u_j, gpy * v_i, gpy, which are d theta
// row-major. What bounds it: it reads g (4.3 MB at N = 64) and the touched
// taps, a few microseconds of HBM time, and does a few dozen flops per
// element; with one reduction per image it is latency- and
// reduction-bound. The design, as the separable crop's d theta: one
// thread per output pixel (looping over channels), a fixed number of
// blocks per image (from the crop size only, at most kMaxBlocksPerImage),
// a shared-memory tree reduction in a fixed order, and a second small
// kernel adding the blocks' partial sums in order. No float atomics, so
// the result is bit-identical between runs. NaN positions give what the
// dense product gives: gpx is NaN where py is NaN (0 where only px is),
// gpy where px is.
//
// Backward, d images (rotated_sampler_bwd_images): each output element
// adds (hat_y * g) * hat_x to its <= 4 taps with float atomics after the
// buffer is zeroed, so the order of the sums changes from run to run.
// What bounds it: writing the whole (N, H, W, C) gradient (38.5 MB at
// N = 64), bytes. A NaN position fills that image's gradient with NaN, as
// the dense product would. Not launched on the training path, whose images
// need no gradient.

#include "sampler_common.cuh"

namespace {

constexpr int kPixelsPerBlock = 512;
constexpr int kSums = 6;

// p = (((a * u + b * v) + shift) + 1) * half, rounded after each operation.
__device__ __forceinline__ float sample_pos(float a, float b, float shift,
                                            float u, float v, float half) {
  return __fmul_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, u), __fmul_rn(b, v)), shift),
                1.0f),
      half);
}

// Hat weight max(0, 1 - |d|).
__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

// The dense VJP's d hat / dp: -sign(d) on |d| < 1, else 0 (0 at d = 0).
__device__ __forceinline__ float hat_grad(float d) {
  if (!(fabsf(d) < 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

// The taps floor(p) + k, k = 0, 1, along an axis of `size` pixels: index
// (0 where outside), hat and hat'. A tap outside the image, or of a
// position that is NaN, infinite or far outside, has zero weights.
struct Taps {
  int idx[2];
  float w[2];
  float dw[2];
};

__device__ __forceinline__ Taps axis_taps(float p, int size) {
  const float f = floorf(p);
  const int first = (f >= -1.0f && f <= (float)(size - 1)) ? (int)f : size;
  Taps t;
  for (int k = 0; k < 2; ++k) {
    const int j = first + k;
    const bool in = j >= 0 && j < size;
    const float d = __fsub_rn(p, (float)j);
    t.idx[k] = in ? j : 0;
    t.w[k] = in ? hat(d) : 0.0f;
    t.dw[k] = in ? hat_grad(d) : 0.0f;
  }
  return t;
}

struct Pos {
  float px, py, u, v;
};

// Positions of output pixel (i, j) of the image whose theta starts at t.
__device__ __forceinline__ Pos positions(const float* __restrict__ t, int i,
                                         int j, float step_y, float step_x,
                                         float half_y, float half_x) {
  Pos p;
  p.u = out_pos(j, step_x);
  p.v = out_pos(i, step_y);
  p.px = sample_pos(__ldg(t + 0), __ldg(t + 1), __ldg(t + 2), p.u, p.v, half_x);
  p.py = sample_pos(__ldg(t + 3), __ldg(t + 4), __ldg(t + 5), p.u, p.v, half_y);
  return p;
}

__global__ void rotated_sampler_fwd_kernel(
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

  const Pos p = positions(theta + n * 6, i, j, step_y, step_x,
                          0.5f * (float)(h - 1), 0.5f * (float)(w - 1));
  if (isnan(p.px) || isnan(p.py)) {  // a NaN hat poisons the dense product
    out[idx] = __int_as_float(0x7fc00000);
    return;
  }
  const Taps tx = axis_taps(p.px, w);
  const Taps ty = axis_taps(p.py, h);
  const float* img = images + n * (int64_t)h * w * c + ch;
  float acc = 0.0f;
  for (int ky = 0; ky < 2; ++ky) {
    float row = 0.0f;  // over the columns of this row tap first
    for (int kx = 0; kx < 2; ++kx) {
      const bool live = tx.w[kx] != 0.0f && ty.w[ky] != 0.0f;
      const float v =
          live ? __ldg(img + ((int64_t)ty.idx[ky] * w + tx.idx[kx]) * c) : 0.0f;
      row = __fadd_rn(row, __fmul_rn(tx.w[kx], v));
    }
    acc = __fadd_rn(acc, __fmul_rn(ty.w[ky], row));
  }
  out[idx] = acc;
}

// Grid (blocks_per_image, N). Block s of image n sums output pixels
// e = s * kThreads + tid + k * blocks_per_image * kThreads of that image and
// writes its six sums to partial[n][s][0..5]:
// [sum gpx*u, sum gpx*v, sum gpx, sum gpy*u, sum gpy*v, sum gpy].
__global__ void __launch_bounds__(kThreads) rotated_sampler_bwd_theta_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    const float* __restrict__ g, float* __restrict__ partial, int h, int w,
    int c, int h_out, int w_out, float step_y, float step_x,
    int blocks_per_image) {
  __shared__ float red[kSums][kThreads];
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int64_t n = blockIdx.y;
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  const float* t = theta + n * 6;
  const float* img = images + n * (int64_t)h * w * c;
  const int64_t pixels = (int64_t)h_out * w_out;
  const float* gn = g + n * pixels * c;
  const float nan = __int_as_float(0x7fc00000);

  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t e = (int64_t)s * kThreads + tid; e < pixels;
       e += (int64_t)blocks_per_image * kThreads) {
    const int j = (int)(e % w_out);
    const int i = (int)(e / w_out);
    const Pos p = positions(t, i, j, step_y, step_x, half_y, half_x);
    const Taps tx = axis_taps(p.px, w);
    const Taps ty = axis_taps(p.py, h);
    float gx = 0.0f, gy = 0.0f;  // sum_c g * dout/dpx, sum_c g * dout/dpy
    for (int ch = 0; ch < c; ++ch) {
      float sx = 0.0f, sy = 0.0f;
      for (int ky = 0; ky < 2; ++ky) {
        float row = 0.0f, drow = 0.0f;  // hat and hat' over the columns
        for (int kx = 0; kx < 2; ++kx) {
          if (tx.w[kx] == 0.0f || ty.w[ky] == 0.0f) continue;
          const float v = __ldg(
              img + ((int64_t)ty.idx[ky] * w + tx.idx[kx]) * c + ch);
          row += tx.w[kx] * v;
          drow += tx.dw[kx] * v;
        }
        sx += ty.w[ky] * drow;
        sy += ty.dw[ky] * row;
      }
      const float gv = __ldg(gn + e * c + ch);
      gx += gv * sx;
      gy += gv * sy;
    }
    float gpx = gx * half_x, gpy = gy * half_y;
    if (isnan(p.py)) gpx = nan;  // the dense product's NaN pattern
    if (isnan(p.px)) gpy = nan;
    acc[0] += gpx * p.u;
    acc[1] += gpx * p.v;
    acc[2] += gpx;
    acc[3] += gpy * p.u;
    acc[4] += gpy * p.v;
    acc[5] += gpy;
  }
  for (int k = 0; k < kSums; ++k) red[k][tid] = acc[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      for (int k = 0; k < kSums; ++k) red[k][tid] += red[k][tid + stride];
    }
    __syncthreads();
  }
  if (tid < kSums) {
    partial[(n * kMaxBlocksPerImage + s) * kSums + tid] = red[tid][0];
  }
}

// One thread per image: adds the blocks' partial sums in order; they are d
// theta (2, 3) row-major.
__global__ void rotated_sampler_bwd_theta_finish_kernel(
    const float* __restrict__ partial, float* __restrict__ d_theta, int n,
    int blocks_per_image) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  float sum[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < blocks_per_image; ++s) {
    for (int k = 0; k < kSums; ++k) {
      sum[k] += partial[((int64_t)b * kMaxBlocksPerImage + s) * kSums + k];
    }
  }
  for (int k = 0; k < kSums; ++k) d_theta[(int64_t)b * kSums + k] = sum[k];
}

// One thread per output element (n, i, j, c), as the forward: adds
// (hat_y * g) * hat_x to the <= 4 taps of d images (zeroed before). A NaN
// position marks its image in nan_flags instead.
__global__ void rotated_sampler_bwd_images_kernel(
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

  const Pos p = positions(theta + n * 6, i, j, step_y, step_x,
                          0.5f * (float)(h - 1), 0.5f * (float)(w - 1));
  if (isnan(p.px) || isnan(p.py)) {
    nan_flags[n] = 1;
    return;
  }
  const Taps tx = axis_taps(p.px, w);
  const Taps ty = axis_taps(p.py, h);
  const float gv = __ldg(g + idx);
  float* dimg = d_images + n * (int64_t)h * w * c + ch;
  for (int ky = 0; ky < 2; ++ky) {
    const float a = ty.w[ky] * gv;
    if (a == 0.0f) continue;
    for (int kx = 0; kx < 2; ++kx) {
      if (tx.w[kx] == 0.0f) continue;
      atomicAdd(dimg + ((int64_t)ty.idx[ky] * w + tx.idx[kx]) * c,
                a * tx.w[kx]);
    }
  }
}

}  // namespace

// images (n, h, w, c), theta (n, 2, 3), out (n, h_out, w_out, c): float32,
// contiguous, on card `device`; `stream` belongs to that card. Returns the
// CUDA error of selecting the card or of the launch (0 on success).
extern "C" int rotated_sampler_fwd(const float* images, const float* theta,
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
  rotated_sampler_fwd_kernel<<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      images, theta, out, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), total);
  return (int)cudaGetLastError();
}

// d theta (n, 2, 3) from images (n, h, w, c), theta (n, 2, 3) and the crop's
// cotangent g (n, h_out, w_out, c); partial is scratch of
// n * kMaxBlocksPerImage * 6 floats. All float32, contiguous, on card
// `device`. Two launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int rotated_sampler_bwd_theta(const float* images,
                                         const float* theta, const float* g,
                                         float* partial, float* d_theta, int n,
                                         int h, int w, int c, int h_out,
                                         int w_out, int device, void* stream) {
  const int64_t pixels = (int64_t)h_out * w_out;
  if (n == 0 || pixels == 0 || c == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  int64_t blocks = (pixels + kPixelsPerBlock - 1) / kPixelsPerBlock;
  if (blocks > kMaxBlocksPerImage) blocks = kMaxBlocksPerImage;
  const dim3 grid((unsigned)blocks, (unsigned)n);
  rotated_sampler_bwd_theta_kernel<<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
      images, theta, g, partial, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), (int)blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rotated_sampler_bwd_theta_finish_kernel<<<(n + kThreads - 1) / kThreads,
                                            kThreads, 0,
                                            (cudaStream_t)stream>>>(
      partial, d_theta, n, (int)blocks);
  return (int)cudaGetLastError();
}

// d images (n, h, w, c) from theta (n, 2, 3) and the crop's cotangent g
// (n, h_out, w_out, c); nan_flags is scratch of n ints. All contiguous, on
// card `device`. A memset, the scatter, a second memset-sized pass only for
// images with a NaN position; returns the first CUDA error (0 on success).
extern "C" int rotated_sampler_bwd_images(const float* theta, const float* g,
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
  rotated_sampler_bwd_images_kernel<<<(unsigned)((total + kThreads - 1) /
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
