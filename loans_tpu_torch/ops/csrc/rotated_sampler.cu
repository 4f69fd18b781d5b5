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
// Backward, d images (rotated_sampler_bwd_images):
//   d img[y, x] = sum_{i,j} hat(py_ij - y) * hat(px_ij - x) * g[i, j].
// What bounds it: bytes, writing all of d images (38.5 MB at N = 64,
// 224^2x3) and reading g (4.3 MB), about 12.8 us of HBM time. A scatter
// from the outputs needs the gradient zeroed first and float atomics, whose
// order of sums changes from run to run, and a second pass for NaN: four
// device operations. The design is a gather, one launch, each element of d
// images summed in registers and written once:
// - One CTA of kDimgThreads threads per tile of kDimgTileY x kDimgTileX
//   input pixels of one image (3,136 CTAs at N = 64, four resident on an
//   SM), a block of 2 x 2 pixels a thread.
// - Reach from the inverse map. Output (j, i) samples the exact position
//   M (j, i) + b, M the 2 x 2 linear part of theta times the steps and half
//   sizes; a pixel (x, y) is reached only by outputs inside the open square
//   (x +- 1, y +- 1), whose preimage is a parallelogram in (j, i). The
//   bounding box of the tile's, in double, widened by the float32
//   positions' rounding (ex, ey pixels) and by kReachMargin indices and
//   clamped to the output, holds every output with a tap on the tile
//   (inverse_map, reach_box). A singular or non-finite map (scale 0, a
//   rank-1 theta) takes the whole output as its box.
// - The box's outputs are staged in shared memory, kDimgChunk at a time:
//   their float32 positions by sample_pos (the plain version's operations
//   in its order) and their C values of g, loaded together. Each is filed
//   in a grid of cells by (floor(px), floor(py)); a pixel's live outputs
//   (|px - x| < 1 and |py - y| < 1, exactly where the plain version's
//   _axis_taps puts a non-zero hat on it) lie in its 4 cells (x - 1 or x,
//   y - 1 or y), which it reads in a fixed order, adding
//   (hat_y * g) * hat_x. No two outputs share a cell where the map keeps
//   them a pixel apart (cell_stride: a lattice check on M, stride 1 at
//   224^2 -> 75^2 at scales above about 0.34); where it does not (a small,
//   sheared or upsampled crop), rounds take one class of outputs (box row
//   and column mod a power of two) at a time, each round a clear of the
//   cells and three barriers: 4 rounds at scale 0.3. Where each class
//   would hold one output (a singular or near-singular map, which takes
//   the whole output as its box, or a box smaller than the stride), the
//   CTA lists the chunk's live outputs, those with a tap on the tile, in a
//   fixed order, and every thread tests each against its pixels: two
//   barriers a chunk, and a tile no output reaches costs only the staging.
//   No atomics, no scratch, a fixed order: bit-identical between runs. A
//   pixel no output reaches is a zero.
// - NaN inside the launch: if all six theta entries are finite and at most
//   2^96, no position can be NaN (|u|, |v| <= 1 and (W - 1) / 2 < 2^27
//   keep every sum and product under float32's overflow at 2^128); any
//   other theta has the CTA scan its image's positions (__syncthreads_or).
//   An image with a NaN position gets NaN throughout, as the dense product.
// Not launched on the training path, whose images need no gradient.

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

// d images: a CTA takes a tile of kDimgTileY x kDimgTileX input pixels of
// one image; each of its kDimgThreads threads sums a block of 2 x 2 of
// them in registers. Candidate outputs are staged in shared memory
// kDimgChunk at a time (up to 4 a thread), with a grid of cells, one per
// floor(px), floor(py) that can tap the tile.
constexpr int kDimgTileX = 32, kDimgTileY = 32;
constexpr int kDimgThreads = kDimgTileX * kDimgTileY / 4;
constexpr int kDimgChunk = 4 * kDimgThreads;
constexpr int kCellsX = kDimgTileX + 1, kCellsY = kDimgTileY + 1;
// Indices added on each side of a reach box, beyond the rounding bound.
constexpr double kReachMargin = 1.0;

// The map from output index (j, i) to its exact position:
//   (px, py) = M (j, i) + b, u_j = -1 + step_x * j, v_i = -1 + step_y * i,
// inverted: (j, i) = inv ((px, py) - b). ex, ey bound |float32 position -
// exact position| in pixels: u and v are off by at most 2^-22, and the five
// float32 operations of sample_pos each by 2^-24 of a partial sum at most
// S = |t0| + |t1| + |t2| + 1, so the error is under half * S * 2^-20;
// ex and ey take 2^-18. ok is false where M is singular or any of these is
// not finite: then every output is a candidate.
struct InverseMap {
  double fwd[2][2];
  double inv[2][2];
  double b[2];
  double ex, ey;
  bool ok;
};

__device__ InverseMap inverse_map(const float (&t)[6], float step_y,
                                  float step_x, double half_y, double half_x) {
  InverseMap m;
  const double a = half_x * t[0] * step_x, bb = half_x * t[1] * step_y;
  const double c = half_y * t[3] * step_x, d = half_y * t[4] * step_y;
  m.fwd[0][0] = a;
  m.fwd[0][1] = bb;
  m.fwd[1][0] = c;
  m.fwd[1][1] = d;
  m.b[0] = half_x * ((double)t[2] + 1.0 - t[0] - t[1]);
  m.b[1] = half_y * ((double)t[5] + 1.0 - t[3] - t[4]);
  const double det = a * d - bb * c;
  const double r = 1.0 / det;
  m.inv[0][0] = d * r;
  m.inv[0][1] = -bb * r;
  m.inv[1][0] = -c * r;
  m.inv[1][1] = a * r;
  constexpr double kRounding = 1.0 / (1 << 18);
  m.ex = kRounding * half_x * (fabs(t[0]) + fabs(t[1]) + fabs(t[2]) + 1.0);
  m.ey = kRounding * half_y * (fabs(t[3]) + fabs(t[4]) + fabs(t[5]) + 1.0);
  m.ok = det != 0.0 && isfinite(m.b[0]) && isfinite(m.b[1]) && isfinite(m.ex) && isfinite(m.ey);
  for (int row = 0; row < 2; ++row) {
    for (int k = 0; k < 2; ++k) m.ok = m.ok && isfinite(m.inv[row][k]);
  }
  return m;
}

// The indices [lo, hi] along output axis `axis` (0: j, 1: i) of every
// output whose exact position lies within (ax, ay) pixels of (px, py) =
// (dx, dy) + b, widened by kReachMargin and clamped to [0, out - 1] (empty
// when lo > hi).
__device__ __forceinline__ int2 reach_box(const InverseMap& m, int axis, double dx,
                                          double dy, double ax, double ay, int out) {
  const double center = m.inv[axis][0] * dx + m.inv[axis][1] * dy;
  const double radius = fabs(m.inv[axis][0]) * ax + fabs(m.inv[axis][1]) * ay + kReachMargin;
  const double lo = fmin(fmax(ceil(center - radius), 0.0), (double)out);
  const double hi = fmax(fmin(floor(center + radius), out - 1.0), -1.0);
  return make_int2((int)lo, (int)hi);
}

// The least power of two s such that any two distinct outputs whose index
// differences (dj, di) are multiples of s have exact positions at least
// 1 + 2 max(ex, ey) pixels apart along an axis: their float32 positions are
// then 1 or more apart, and their floors differ, so no two share a cell.
// With w = (dj, di) / s: for ||w||_inf >= 3 the distance is at least
// 3 s / ||inv||_inf (as ||w||_inf <= ||inv||_inf ||M w||_inf); the vectors
// with ||w||_inf <= 2 are checked one by one, one lane of the calling warp
// each (wi = lane / 5, wj = lane % 5 - 2 for the first 15 lanes; one of
// each pair +-w). 2^30 where the map is not ok. Every lane of the warp
// calls it with the same map.
__device__ int cell_stride(const InverseMap& m, int lane) {
  const double need = 1.0 + 2.0 * fmax(m.ex, m.ey);
  const double norm = fmax(fabs(m.inv[0][0]) + fabs(m.inv[0][1]),
                           fabs(m.inv[1][0]) + fabs(m.inv[1][1]));
  const int wi = lane / 5, wj = lane % 5 - 2;
  const bool checks = lane < 15 && !(wi == 0 && wj <= 0);
  for (int s = 1; m.ok && s < (1 << 30); s <<= 1) {
    if (!(3.0 * s >= need * norm)) continue;
    const double dx = s * (m.fwd[0][0] * wj + m.fwd[0][1] * wi);
    const double dy = s * (m.fwd[1][0] * wj + m.fwd[1][1] * wi);
    if (__all_sync(0xffffffffu, !checks || fmax(fabs(dx), fabs(dy)) >= need)) return s;
  }
  return 1 << 30;
}

// The least power of two at or above k >= 1.
__device__ __forceinline__ int pow2_at_least(int k) {
  return k <= 1 ? 1 : 1 << (32 - __clz(k - 1));
}

// What a d images CTA derives from theta once: the tile's box of candidate
// outputs and the class strides of its rounds (powers of two).
struct TilePlan {
  int2 bj, bi;
  int si, sj;
  bool scan;  // si >= box rows and sj >= box columns: a class per output
};

// Grid n * tiles, tiles = tiles_x * ceil(h / kDimgTileY); CTA k of image n
// takes the tile (k / tiles_x, k % tiles_x). kC is the channel count, whose
// sums a thread keeps together; 0 takes any C, one channel at a time (the
// candidates staged again for each).
template <int kC>
__global__ void __launch_bounds__(kDimgThreads, 4) rotated_sampler_bwd_images_kernel(
    const float* __restrict__ theta, const float* __restrict__ g,
    float* __restrict__ d_images, int h, int w, int c, int h_out, int w_out,
    float step_y, float step_x, int tiles_x, int tiles) {
  constexpr int kLoaded = kC > 0 ? kC : 1;  // channels summed together
  constexpr int kHeld = kDimgChunk / kDimgThreads;  // candidates a thread stages
  const int channels = kC > 0 ? kC : c;
  __shared__ TilePlan plan;
  static_assert(kCellsY * kCellsX >= kDimgChunk, "a scan lists a chunk in the cells");
  __shared__ int cells[kCellsY * kCellsX];  // a staged candidate, or -1; a scan's list
  __shared__ int counts[kHeld * (kDimgThreads / 32)];  // a scan: live candidates a warp
  __shared__ float2 cand_pos[kDimgChunk];
  __shared__ float cand_g[kDimgChunk * kLoaded];
  const int tid = threadIdx.x;
  const int n = (int)(blockIdx.x / (unsigned)tiles);
  const int tile = (int)blockIdx.x - n * tiles;
  const int tile_row = tile / tiles_x;
  const int x0 = (tile - tile_row * tiles_x) * kDimgTileX, y0 = tile_row * kDimgTileY;
  const int x_last = min(x0 + kDimgTileX, w) - 1, y_last = min(y0 + kDimgTileY, h) - 1;
  // the thread's block of pixels: columns lx, lx + 1 and rows ly, ly + 1 of the tile
  const int lx = 2 * (tid % (kDimgTileX / 2)), ly = 2 * (tid / (kDimgTileX / 2));
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  float t[6];
  bool tame = true;  // no position can be NaN
  for (int k = 0; k < 6; ++k) {
    t[k] = __ldg(theta + (int64_t)n * 6 + k);
    tame = tame && fabsf(t[k]) <= 0x1p96f;  // false for NaN and inf too
  }
  if (tid < 32) {  // warp 0 plans; the tile's box: its pixels' centres +- (half the tile + 1 + rounding)
    const InverseMap m = inverse_map(t, step_y, step_x, half_y, half_x);
    const int stride = cell_stride(m, tid);
    TilePlan p;
    p.bj = make_int2(0, w_out - 1);
    p.bi = make_int2(0, h_out - 1);
    if (m.ok) {
      const double dx = 0.5 * (x0 + x_last) - m.b[0], dy = 0.5 * (y0 + y_last) - m.b[1];
      const double ax = 0.5 * (x_last - x0) + 1.0 + m.ex, ay = 0.5 * (y_last - y0) + 1.0 + m.ey;
      p.bj = reach_box(m, 0, dx, dy, ax, ay, w_out);
      p.bi = reach_box(m, 1, dx, dy, ax, ay, h_out);
    }
    const int bw = max(1, p.bj.y - p.bj.x + 1), bh = max(1, p.bi.y - p.bi.x + 1);
    p.scan = stride >= bh && stride >= bw;
    p.si = min(stride, pow2_at_least(bh));
    p.sj = min(stride, pow2_at_least(bw));
    if (tid == 0) plan = p;
  }
  bool nan = false;
  if (!tame) {
    for (int e = tid; e < h_out * w_out; e += kDimgThreads) {
      const int i = e / w_out, j = e - i * w_out;
      const float u = out_pos(j, step_x), v = out_pos(i, step_y);
      nan |= isnan(sample_pos(t[0], t[1], t[2], u, v, half_x)) ||
             isnan(sample_pos(t[3], t[4], t[5], u, v, half_y));
    }
  }
  float* dst = d_images + (((int64_t)n * h + y0 + ly) * w + x0 + lx) * channels;
  const int row_step = w * channels;
  // whether pixel (ly + a, lx + b) of the block lies in the image
  const bool inside[2][2] = {{y0 + ly <= y_last && x0 + lx <= x_last, y0 + ly <= y_last && x0 + lx + 1 <= x_last},
                             {y0 + ly + 1 <= y_last && x0 + lx <= x_last, y0 + ly + 1 <= y_last && x0 + lx + 1 <= x_last}};
  if (__syncthreads_or(nan)) {  // a NaN hat poisons the whole dense product
    for (int a = 0; a < 2; ++a) {
      for (int b = 0; b < 2; ++b) {
        if (!inside[a][b]) continue;
        for (int ch = 0; ch < channels; ++ch) dst[a * row_step + b * channels + ch] = __int_as_float(0x7fc00000);
      }
    }
    return;
  }

  const TilePlan p = plan;  // written before __syncthreads_or
  const int2 bj = p.bj, bi = p.bi;
  const int bw = max(0, bj.y - bj.x + 1), bh = max(0, bi.y - bi.x + 1);
  const int box = bw * bh;  // < h_out * w_out
  const int sj_bits = __ffs(p.sj) - 1;
  const float* gn = g + (int64_t)n * h_out * w_out * channels;
  for (int ch0 = 0; ch0 < channels; ch0 += kLoaded) {
    float acc[2][2][kLoaded];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int cc = 0; cc < kLoaded; ++cc) acc[a][b][cc] = 0.0f;
      }
    }
    // adds staged candidate k's products to the block's pixels it reaches
    auto gather = [&](int k) {
      const float2 pos = cand_pos[k];
      float gk[kLoaded];
#pragma unroll
      for (int cc = 0; cc < kLoaded; ++cc) gk[cc] = cand_g[k * kLoaded + cc];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float dy = __fsub_rn(pos.y, (float)(y0 + ly + a));
        if (!(fabsf(dy) < 1.0f)) continue;  // a zero hat
        const float wy = hat(dy);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float dx = __fsub_rn(pos.x, (float)(x0 + lx + b));
          if (!(fabsf(dx) < 1.0f)) continue;
          const float wx = hat(dx);
#pragma unroll
          for (int cc = 0; cc < kLoaded; ++cc) {
            acc[a][b][cc] = __fadd_rn(acc[a][b][cc], __fmul_rn(__fmul_rn(wy, gk[cc]), wx));
          }
        }
      }
    };
    for (int c0 = 0; c0 < box; c0 += kDimgChunk) {
      const int len = min(kDimgChunk, box - c0);
      __syncthreads();  // every thread is done with the last chunk
      // stage this thread's candidates, entries c0 + tid + q * kDimgThreads,
      // box row and column stepped without a division; keep their cells
      // and classes
      int cell[kHeld], cls[kHeld];
      const int drow = kDimgThreads / bw, dcol = kDimgThreads - drow * bw;
      int row = (c0 + tid) / bw, col = c0 + tid - row * bw;
#pragma unroll
      for (int q = 0; q < kHeld; ++q) {
        const int k = tid + q * kDimgThreads;
        cell[q] = -1;
        cls[q] = -1;
        if (k < len) {
          const int i = bi.x + row, j = bj.x + col;
          const float u = out_pos(j, step_x), v = out_pos(i, step_y);
          const float px = sample_pos(t[0], t[1], t[2], u, v, half_x);
          const float py = sample_pos(t[3], t[4], t[5], u, v, half_y);
          cand_pos[k] = make_float2(px, py);
          const float* gp = gn + (i * w_out + j) * channels + ch0;
#pragma unroll
          for (int cc = 0; cc < kLoaded; ++cc) cand_g[k * kLoaded + cc] = __ldg(gp + cc);
          const float fx = floorf(px), fy = floorf(py);
          if (fx >= (float)(x0 - 1) && fx <= (float)x_last && fy >= (float)(y0 - 1) &&
              fy <= (float)y_last) {  // a tap on the tile
            cell[q] = ((int)fy - y0 + 1) * kCellsX + ((int)fx - x0 + 1);
            cls[q] = ((row & (p.si - 1)) << sj_bits) | (col & (p.sj - 1));
          }
        }
        row += drow;
        col += dcol;
        if (col >= bw) {
          col -= bw;
          ++row;
        }
      }
      if (p.scan) {
        // the chunk's live candidates listed in the order (q, warp, lane),
        // then every thread tests each of them against its block
#pragma unroll
        for (int q = 0; q < kHeld; ++q) {
          const unsigned live = __ballot_sync(0xffffffffu, cell[q] >= 0);
          if ((tid & 31) == 0) counts[q * (kDimgThreads / 32) + (tid >> 5)] = __popc(live);
        }
        __syncthreads();
        int total = 0;
#pragma unroll
        for (int q = 0; q < kHeld; ++q) {
          const unsigned live = __ballot_sync(0xffffffffu, cell[q] >= 0);
          int at = total + __popc(live & ((1u << (tid & 31)) - 1u));
          for (int wv = 0; wv < kDimgThreads / 32; ++wv) {
            const int count = counts[q * (kDimgThreads / 32) + wv];
            at += wv < (tid >> 5) ? count : 0;
            total += count;
          }
          if (cell[q] >= 0) cells[at] = tid + q * kDimgThreads;
        }
        __syncthreads();
        for (int e = 0; e < total; ++e) gather(cells[e]);
        continue;
      }
      for (int r = 0; r < p.si * p.sj; ++r) {
        if (r > 0) __syncthreads();  // the last round's gathers are done
        for (int e = tid; e < kCellsY * kCellsX; e += kDimgThreads) cells[e] = -1;
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kHeld; ++q) {
          if (cls[q] == r) cells[cell[q]] = tid + q * kDimgThreads;
        }
        __syncthreads();
        // a pixel (x, y) gathers the candidates whose floors are (x - 1 or
        // x, y - 1 or y): the block's 3 x 3 cells, rows then columns, give
        // each of its pixels its 4 cells in that order
#pragma unroll
        for (int cy = 0; cy < 3; ++cy) {
#pragma unroll
          for (int cx = 0; cx < 3; ++cx) {
            const int k = cells[(ly + cy) * kCellsX + lx + cx];
            if (k >= 0) gather(k);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (!inside[a][b]) continue;
#pragma unroll
        for (int cc = 0; cc < kLoaded; ++cc) dst[a * row_step + b * channels + ch0 + cc] = acc[a][b][cc];
      }
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
// (n, h_out, w_out, c), h_out and w_out at least 1. All float32,
// contiguous, on card `device`; offsets inside an image in 32 bits. One
// launch on `stream` that writes every element; returns its CUDA error (0
// on success).
extern "C" int rotated_sampler_bwd_images(const float* theta, const float* g,
                                          float* d_images, int n, int h, int w,
                                          int c, int h_out, int w_out,
                                          int device, void* stream) {
  if ((int64_t)n * h * w * c == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int tiles_x = (w + kDimgTileX - 1) / kDimgTileX;
  const int tiles = tiles_x * ((h + kDimgTileY - 1) / kDimgTileY);
  auto kernel = c == 3 ? rotated_sampler_bwd_images_kernel<3> : rotated_sampler_bwd_images_kernel<0>;
  kernel<<<(unsigned)n * (unsigned)tiles, kDimgThreads, 0, (cudaStream_t)stream>>>(
      theta, g, d_images, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), tiles_x, tiles);
  return (int)cudaGetLastError();
}
