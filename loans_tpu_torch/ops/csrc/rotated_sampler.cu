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
// carried over. What bounds it on Hopper: bytes, the distinct taps touched
// and the crop written (a bound of about 5 us at N = 64, 224^2x3 -> 75^2);
// but a call is short enough that its time goes to a fixed cost (launch,
// theta, the product tables) and to its threads' instructions and load
// latency. Unlike the axis-aligned crop, the taps of neighbouring outputs
// lie on a rotated footprint: one output row's can span about 67 input
// rows (|t10| = 0.3 over 223 px), so a band's footprint does not fit in
// shared memory and the forward stays a gather from L1 and L2. The design:
// - One CTA of kFwdThreads threads per band of whole output rows of one
//   image, about kFwdThreads pixels (3 rows at 75^2: 1,600 CTAs at N = 64,
//   six resident on each SM at 40 registers a thread; CTAs of 128 or 512
//   threads, and 2 pixels a thread with their loads interleaved, measured
//   no faster; PERF.md). Theta is read once per thread and every
//   product of a position formed once per CTA: the column table
//   (t00 * u_j, t10 * u_j) and the row table (t01 * v_i, t11 * v_i) in
//   dynamic shared memory, (w_out + rows) * 8 bytes (the limit raised past
//   48 KB for wide crops; past the card's 227 KB, about 29,000 columns, a
//   launch is refused and the wrapper raises).
// - One thread per output pixel, 32-bit offsets inside an image (its base
//   in 64 bits), no division per pixel (the thread steps its row and
//   column). Its positions are three _rn adds and a _rn product on top of
//   the tables, the plain version's operations in its order. The channel
//   loop is unrolled for C = 3 (a generic instance takes any C), so all
//   four taps' C values are loaded before any arithmetic; a tap outside the
//   image reads index 0 and is selected away.
// Float32 weights and sum: over the two column taps of each row tap, then
// over the rows, in the plain version's order with _rn operations, so the
// two agree bit for bit; a NaN position gives a NaN pixel, as the dense
// product does.
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
// element, so bytes set its bound; but a call is short enough that its
// time goes to a fixed cost (launch, the cluster reduction) and to each
// thread's pixels in turn: the arithmetic of their positions and taps, and
// the latency of their loads. The design, one launch per call:
// - One thread-block cluster of kClusterCtas CTAs of kDthetaThreads
//   threads per image (min(2, ceil(pixels / kDthetaThreads)) CTAs); CTA r
//   takes the output pixels [r * pixels / ctas, (r + 1) * pixels / ctas),
//   a band of rows, so its taps share lines in L1.
// - One thread per output pixel: positions stay per pixel (they are 2-D),
//   with 32-bit index arithmetic inside an image (its base in 64 bits) and
//   no division per pixel (the thread steps its row and column). The
//   channel loop is unrolled for C = 3 (a generic instance takes any C),
//   so each tap's C values and g's C values are loaded together before
//   the arithmetic; a tap outside the image reads index 0 and is not
//   summed.
// - A fixed-order reduction inside the kernel (cluster_sum in
//   sampler_common.cuh: warp shuffles, the CTA's warps, then cluster rank 0
//   adding the CTAs' sums over distributed shared memory in rank order);
//   rank 0 writes the six entries. No float atomics and no scratch, so the
//   result is bit-identical between runs. NaN positions give what the
//   dense product gives: gpx is NaN where py is NaN (0 where only px is),
//   gpy where px is.
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

// The forward: kFwdThreads threads per CTA, one output pixel each at a
// time, and a CTA takes a band of about kFwdThreads pixels (whole output
// rows) of one image: at 75^2, 3 rows, 25 bands an image.
constexpr int kFwdThreads = 256;

// Grid n * bands; CTA b of image n takes the output rows [b * h_out /
// bands, (b + 1) * h_out / bands), one thread per pixel. Dynamic shared
// memory holds the CTA's product tables, each product rounded on its own
// (__fmul_rn): (t00 * u_j, t10 * u_j) for each of the w_out columns, then
// (t01 * v_i, t11 * v_i) for each of its rows. A pixel's positions are
// then sample_pos's operations from the products on:
//   px = (((t00 * u_j + t01 * v_i) + t02) + 1) * half_x,
// so they are the plain version's bit for bit. kC is the channel count,
// whose values of all four taps a thread loads before it uses any (a tap
// outside the image reads index 0 and is selected away); 0 takes any c,
// one channel at a time.
template <int kC>
__global__ void __launch_bounds__(kFwdThreads) rotated_sampler_fwd_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    float* __restrict__ out, int h, int w, int c, int h_out, int w_out,
    float step_y, float step_x, int bands) {
  constexpr int kLoaded = kC > 0 ? kC : 1;  // channels loaded together
  const int channels = kC > 0 ? kC : c;
  extern __shared__ float2 products[];
  float2* col_p = products;
  float2* row_p = products + w_out;
  const int tid = threadIdx.x;
  const int n = (int)(blockIdx.x / (unsigned)bands);
  const int band = (int)blockIdx.x - n * bands;
  const int row_begin = (int)((int64_t)band * h_out / bands);
  const int rows = (int)((int64_t)(band + 1) * h_out / bands) - row_begin;

  const float* t = theta + (int64_t)n * 6;
  const float t00 = __ldg(t + 0), t01 = __ldg(t + 1), t02 = __ldg(t + 2);
  const float t10 = __ldg(t + 3), t11 = __ldg(t + 4), t12 = __ldg(t + 5);
  for (int k = tid; k < w_out + rows; k += kFwdThreads) {
    if (k < w_out) {
      const float u = out_pos(k, step_x);
      col_p[k] = make_float2(__fmul_rn(t00, u), __fmul_rn(t10, u));
    } else {
      const float v = out_pos(row_begin + k - w_out, step_y);
      row_p[k - w_out] = make_float2(__fmul_rn(t01, v), __fmul_rn(t11, v));
    }
  }
  __syncthreads();

  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  const float* img = images + (int64_t)n * h * w * channels;
  float* o = out + ((int64_t)n * h_out + row_begin) * w_out * channels;
  const int pixels = rows * w_out;
  // pixel e = r * w_out + j of the band, advanced by kFwdThreads at a time
  // without a division: that is dr rows and dj columns
  const int dr = kFwdThreads / w_out, dj = kFwdThreads - dr * w_out;
  int r = tid / w_out, j = tid - r * w_out;
  for (int e = tid; e < pixels; e += kFwdThreads) {
    const float2 cp = col_p[j], rp = row_p[r];
    const float px = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(cp.x, rp.x), t02), 1.0f), half_x);
    const float py = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(cp.y, rp.y), t12), 1.0f), half_y);
    const Taps tx = axis_taps(px, w);
    const Taps ty = axis_taps(py, h);
    const bool nan = isnan(px) || isnan(py);  // a NaN hat poisons the dense product
    float* dst = o + e * channels;
    for (int ch0 = 0; ch0 < channels; ch0 += kLoaded) {
      float v[kLoaded][2][2];
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const float* tap = img + (ty.idx[ky] * w + tx.idx[kx]) * channels + ch0;
#pragma unroll
          for (int cc = 0; cc < kLoaded; ++cc) v[cc][ky][kx] = __ldg(tap + cc);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kLoaded; ++cc) {
        float acc = 0.0f;
#pragma unroll
        for (int ky = 0; ky < 2; ++ky) {
          float row = 0.0f;  // over the columns of this row tap first
#pragma unroll
          for (int kx = 0; kx < 2; ++kx) {
            const float x = tx.w[kx] != 0.0f && ty.w[ky] != 0.0f ? v[cc][ky][kx] : 0.0f;
            row = __fadd_rn(row, __fmul_rn(tx.w[kx], x));
          }
          acc = __fadd_rn(acc, __fmul_rn(ty.w[ky], row));
        }
        dst[ch0 + cc] = nan ? __int_as_float(0x7fc00000) : acc;
      }
    }
    r += dr;
    j += dj;
    if (j >= w_out) {
      j -= w_out;
      ++r;
    }
  }
}

// Grid n * ctas, one cluster of ctas CTAs per image. Cluster rank r sums
// the output pixels [r * pixels / ctas, (r + 1) * pixels / ctas), one
// thread per pixel at a time; cluster_sum adds the six sums
// [sum gpx*u, sum gpx*v, sum gpx, sum gpy*u, sum gpy*v, sum gpy] over the
// cluster, and rank 0 writes them: d theta (2, 3) row-major. kC is the
// channel count, whose values a thread loads together (each tap's and
// g's) before it uses any; 0 takes any c, one channel at a time.
template <int kC>
__global__ void __launch_bounds__(kDthetaThreads, 2) rotated_sampler_bwd_theta_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    const float* __restrict__ g, float* __restrict__ d_theta, int h, int w,
    int c, int h_out, int w_out, float step_y, float step_x, int ctas) {
  constexpr int kLoaded = kC > 0 ? kC : 1;  // channels loaded together
  const int channels = kC > 0 ? kC : c;
  const int tid = threadIdx.x;
  const int rank = (int)cg::this_cluster().block_rank();
  const int64_t n = blockIdx.x / ctas;
  const int pixels = h_out * w_out;
  const int begin = (int)((int64_t)rank * pixels / ctas);
  const int end = (int)((int64_t)(rank + 1) * pixels / ctas);
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  const float* t = theta + n * 6;
  const float* img = images + n * (int64_t)h * w * channels;
  const float* gn = g + n * (int64_t)pixels * channels;
  const float nan = __int_as_float(0x7fc00000);

  // pixel e = i * w_out + j, advanced by kDthetaThreads at a time without
  // a division: that is di rows and dj columns
  const int di = kDthetaThreads / w_out, dj = kDthetaThreads - di * w_out;
  int i = (begin + tid) / w_out, j = begin + tid - i * w_out;
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = begin + tid; e < end; e += kDthetaThreads) {
    const Pos p = positions(t, i, j, step_y, step_x, half_y, half_x);
    const Taps tx = axis_taps(p.px, w);
    const Taps ty = axis_taps(p.py, h);
    float gx = 0.0f, gy = 0.0f;  // sum_c g * dout/dpx, sum_c g * dout/dpy
    for (int ch0 = 0; ch0 < channels; ch0 += kLoaded) {
      // every tap's kLoaded channel values and g's first; a tap outside
      // the image reads index 0 and is not summed
      float v[kLoaded][2][2], gv[kLoaded];
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const float* tap = img + (ty.idx[ky] * w + tx.idx[kx]) * channels + ch0;
#pragma unroll
          for (int cc = 0; cc < kLoaded; ++cc) v[cc][ky][kx] = __ldg(tap + cc);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kLoaded; ++cc) gv[cc] = __ldg(gn + e * channels + ch0 + cc);
#pragma unroll
      for (int cc = 0; cc < kLoaded; ++cc) {
        float sx = 0.0f, sy = 0.0f;
#pragma unroll
        for (int ky = 0; ky < 2; ++ky) {
          float row = 0.0f, drow = 0.0f;  // hat and hat' over the columns
#pragma unroll
          for (int kx = 0; kx < 2; ++kx) {
            const float x = tx.w[kx] != 0.0f && ty.w[ky] != 0.0f ? v[cc][ky][kx] : 0.0f;
            row += tx.w[kx] * x;
            drow += tx.dw[kx] * x;
          }
          sx += ty.w[ky] * drow;
          sy += ty.dw[ky] * row;
        }
        gx += gv[cc] * sx;
        gy += gv[cc] * sy;
      }
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
    i += di;
    j += dj;
    if (j >= w_out) {
      j -= w_out;
      ++i;
    }
  }
  const float sum = cluster_sum(acc, ctas);
  if (rank == 0 && tid < kSums) d_theta[n * kSums + tid] = sum;
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
  if ((int64_t)n * h_out * w_out * c == 0) return 0;
  // This library carries its own CUDA runtime, whose current card is not
  // PyTorch's: select it.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int band_rows = w_out < kFwdThreads ? kFwdThreads / w_out : 1;
  const int bands = (h_out + band_rows - 1) / band_rows;
  const int rows = (h_out + bands - 1) / bands;  // the most any CTA takes
  const size_t smem = (size_t)(w_out + rows) * sizeof(float2);
  auto kernel = c == 3 ? rotated_sampler_fwd_kernel<3> : rotated_sampler_fwd_kernel<0>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n * (unsigned)bands, kFwdThreads, smem, (cudaStream_t)stream>>>(
      images, theta, out, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), bands);
  return (int)cudaGetLastError();
}

// d theta (n, 2, 3) from images (n, h, w, c), theta (n, 2, 3) and the crop's
// cotangent g (n, h_out, w_out, c). All float32, contiguous, on card
// `device`; offsets inside an image in 32 bits. One cluster launch on
// `stream`; returns its CUDA error (0 on success).
extern "C" int rotated_sampler_bwd_theta(const float* images,
                                         const float* theta, const float* g,
                                         float* d_theta, int n, int h, int w,
                                         int c, int h_out, int w_out,
                                         int device, void* stream) {
  const int64_t pixels = (int64_t)h_out * w_out;
  if (n == 0 || pixels == 0 || c == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int64_t wanted = (pixels + kDthetaThreads - 1) / kDthetaThreads;
  const int ctas = wanted < kClusterCtas ? (int)wanted : kClusterCtas;
  auto kernel = c == 3 ? rotated_sampler_bwd_theta_kernel<3>
                       : rotated_sampler_bwd_theta_kernel<0>;
  return (int)launch_clusters(kernel, n, ctas, 0, (cudaStream_t)stream,
                              images, theta, g, d_theta, h, w, c, h_out,
                              w_out, out_step(h_out), out_step(w_out), ctas);
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
