// Separable (axis-aligned) bilinear crop, forward and backward: the CUDA
// kernels behind loans_tpu_torch.ops.stn.sample_separable_kernel.
//
// Replaces loans_tpu/ops/stn.py::_separable_kernel (the Pallas kernel that
// computes out[b, c] = ky . img[b, c] . kx^T with dense hat-weight
// matrices ky[i, y] = max(0, 1 - |p_i - y|) built in VMEM and contracted on
// the MXU) and, for the backward, the JAX VJP of sample_separable that its
// custom_vjp runs (loans_tpu/ops/stn.py:641-650, dense matmuls in XLA).
//
// Forward (separable_sampler_fwd). A hat row has at most two non-zero
// taps, floor(p) and floor(p) + 1, so the dense ky . img . kx^T (about 30
// MFLOP per image, almost all of it on zeros) is exactly a 4-tap bilinear
// read with zero padding, NHWC in and out. What bounds it on Hopper: bytes,
// the touched image region read and the crop written (at N = 64,
// 224^2x3 -> 75^2: about 12 MB and 4.3 MB, under 5 us of HBM time); but a
// call is short enough that its time goes to a fixed cost (launch, the
// theta loads and tap tables) and to its threads' instructions and rounds
// of load latency: per image only 150 positions are distinct (one per
// output row and column) for 16,875 elements. The design:
// - One CTA of kFwdThreads threads per band of whole output rows of one
//   image, about kFwdThreads pixels: at 75^2, 3 rows, 25 bands an image,
//   so 800 CTAs at N = 32 and 1,600 at N = 64, eight resident on each SM
//   (32 registers a thread), so each SM overlaps one CTA's table build and
//   loads with the others'. CTAs of 128 or 512 threads (bands of 1 or 6
//   rows), threads over (j, c) with bands of 2-8 rows, and the band's input
//   rows copied into shared memory by cp.async.bulk measured slower
//   (PERF.md).
// - Tap tables, built once per CTA in dynamic shared memory by axis_entry
//   (the d theta kernel's): for each of its rows and for each of the w_out
//   columns, the two core taps' offsets, clamped into the image, and their
//   hat weights, (rows + w_out) * 32 bytes (2.5 KB at 75^2). Positions come
//   from sample_pos, the one function every K1 kernel uses. The limit is
//   raised past 48 KB for wide crops, so a crop with w_out up to about
//   7,250 launches (227 KB) and a wider one is refused
//   (cudaErrorInvalidValue, raised by the wrapper).
// - One thread per output pixel, stepping over the band's pixels without a
//   division, 32-bit offsets inside an image (its base in 64 bits). It reads
//   its row's and column's taps from the tables, then issues the loads of
//   both input rows, all four taps and all C channels (unrolled for C = 3,
//   a generic instance takes any C), before it uses any: one round of load
//   latency. A tap outside the image is clamped in, so no load is
//   predicated, and selected away (not multiplied by 0), so an off-image
//   crop is exactly 0. A warp's stores cover 32 neighbouring pixels.
// Weights and sum in float32, rows first, then columns, as the plain
// version's two matmuls (sample_separable); a NaN position gives NaN in
// its row or column of the crop, as the dense product does.
//
// Backward, d theta (separable_sampler_bwd_theta). Per image it needs four
// sums over every output element (i, j, c): g * dout/dp_y times u_i and
// alone, g * dout/dp_x times u_j and alone. Each element reads its taps as
// the forward does, plus the row or column floor(p) - 1, where the hat's
// derivative is non-zero when p is an integer (JAX's subgradients: -1 at
// d = 0, -0.5 * sign(d) at |d| = 1, see hat_grad). What bounds it: at
// N = 64 it reads g (4.3 MB) and the touched image region (at most
// 38.5 MB), a few microseconds of HBM time, and does a few dozen flops per
// element, so bytes set its bound; but a call is short enough that its
// time goes to a fixed cost (launch, tap tables, the cluster reduction)
// and to the latency of each thread's rounds of loads. The design, one
// launch per call:
// - One thread-block cluster of kClusterCtas CTAs of kDthetaThreads
//   threads per image (min(2, h_out) CTAs); CTA r takes the output rows
//   [r * h_out / ctas, (r + 1) * h_out / ctas).
// - Tap tables, built once per CTA in dynamic shared memory: for each of
//   its rows and for each of the w_out columns, the offsets of the two core
//   taps and of the extra tap (hat' only, at a tie), and their weights.
//   Positions come from sample_pos, the forward's, so every kernel agrees
//   with the plain version on which taps are ties. (rows + w_out) * 32
//   bytes: 3.6 KB at 75^2; the limit is raised past 48 KB for wide crops,
//   so a crop with ceil(h_out / 2) + w_out up to about 7,250 launches
//   (227 KB) and a wider one is refused (cudaErrorInvalidValue, raised by
//   the wrapper).
// - Threads run over (j, c), contiguous in NHWC, so a warp's loads of g
//   are coalesced; groups of w_out * c threads split the CTA's rows. Each
//   thread keeps its column's taps in registers and reads each row's from
//   shared memory (a broadcast): no position arithmetic per element,
//   32-bit offsets inside an image (its base in 64 bits). It issues the
//   loads of kRowBatch rows (the 2 x 2 core taps and g, clamped into the
//   image, so none is predicated) before it uses any, so its ~19 rows at
//   75^2 take four rounds of load latency; the extra taps load only at
//   ties.
// - A fixed-order reduction inside the kernel (cluster_sum: warp shuffles,
//   the CTA's warps, then cluster rank 0 adding the CTAs' sums over
//   distributed shared memory in rank order), and rank 0 writes all six
//   entries of the image's d theta, the exact zeros at [0, 1] and [1, 0]
//   included. No float atomics and no scratch, so the result is
//   bit-identical between runs. A NaN position gives NaN in the four used
//   entries of that image's d theta, as the dense product would.
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

// Rows whose loads a thread issues together, before it uses any of them:
// the loop is bound by the latency of its rounds of loads.
constexpr int kRowBatch = 5;

// One output row's (or column's) taps along its axis, from axis_taps: the
// two core taps floor(p) + k, k = 0, 1 (every tap where hat is non-zero,
// and hat' too off a tie), and the extra tap floor(p) - 1, whose hat is 0
// and whose hat' is -0.5 at a tie (p an integer) and 0 elsewhere. Offsets
// are the taps' indices times the axis stride, clamped into the image so
// that every load is in bounds; an outside tap has zero weights and is
// not live. Offsets and weights lie apart: the loads need the first, the
// arithmetic after them the second.
struct __align__(16) TapOffsets {
  int off[2];
  int extra_off;
  float extra_dw;
};
struct __align__(16) TapWeights {
  float w[2];   // hat weights of the core taps
  float dw[2];  // their hat', JAX's subgradients
};

__device__ __forceinline__ bool live(const TapWeights& t, int k) {
  return t.w[k] != 0.0f || t.dw[k] != 0.0f;
}

// Fills the taps of output index i along an axis of `size` input pixels,
// `stride` floats apart; returns whether the position is NaN.
__device__ __forceinline__ bool axis_entry(float scale, float shift, int i,
                                           float step, float half, int size,
                                           int stride, TapOffsets& o,
                                           TapWeights& t) {
  const float p = sample_pos(scale, shift, i, step, half);
  float w[3], dw[3];
  const int first = axis_taps(p, size, w, dw);
  o.extra_off = min(max(first, 0), size - 1) * stride;
  o.extra_dw = dw[0];  // w[0] is 0: d = p - floor(p) + 1 >= 1
  for (int k = 0; k < 2; ++k) {
    o.off[k] = min(max(first + 1 + k, 0), size - 1) * stride;
    t.w[k] = w[k + 1];
    t.dw[k] = dw[k + 1];
  }
  return isnan(p);
}

// The forward: kFwdThreads threads per CTA, one output pixel each at a
// time, and a CTA takes a band of about kFwdThreads pixels (whole output
// rows) of one image: at 75^2, 3 rows, 25 bands an image.
constexpr int kFwdThreads = 256;

// Grid n * bands; CTA b of image n takes the output rows [b * h_out /
// bands, (b + 1) * h_out / bands), one thread per pixel. Dynamic shared
// memory holds its tap tables as the d theta kernel's (its row entries,
// then the w_out column entries: TapOffsets, then TapWeights), built once
// per CTA; a NaN position stores a NaN hat weight, which is live and so
// turns every element of its row or column into NaN, as the dense product
// does. kC is the channel count, whose values of all four taps a thread
// loads before it uses any; 0 takes any c, one channel at a time. Per
// element (i, j, c) with the core taps' values v, summed rows first:
//   out = sum_kx wx[kx] * (sum_ky wy[ky] * v[ky][kx]),
// a tap that is not live (outside the image) selected away.
template <int kC>
__global__ void __launch_bounds__(kFwdThreads) separable_sampler_fwd_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    float* __restrict__ out, int h, int w, int c, int h_out, int w_out,
    float step_y, float step_x, int bands) {
  constexpr int kLoaded = kC > 0 ? kC : 1;  // channels loaded together
  const int channels = kC > 0 ? kC : c;
  extern __shared__ TapOffsets tables[];
  const int tid = threadIdx.x;
  const int n = (int)(blockIdx.x / (unsigned)bands);
  const int band = (int)blockIdx.x - n * bands;
  const int row_begin = (int)((int64_t)band * h_out / bands);
  const int rows = (int)((int64_t)(band + 1) * h_out / bands) - row_begin;
  TapOffsets* row_offs = tables;
  TapOffsets* col_offs = tables + rows;
  TapWeights* row_ws = reinterpret_cast<TapWeights*>(tables + rows + w_out);
  TapWeights* col_ws = row_ws + rows;

  // theta (N, 2, 3) row-major: sx = t[0], tx = t[2], sy = t[4], ty = t[5].
  const float* t = theta + (int64_t)n * 6;
  const float sx = __ldg(t + 0), tx = __ldg(t + 2);
  const float sy = __ldg(t + 4), ty = __ldg(t + 5);
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  const int wc = w * channels;
  for (int k = tid; k < rows + w_out; k += kFwdThreads) {
    TapWeights* entry = k < rows ? &row_ws[k] : &col_ws[k - rows];
    const bool nan = k < rows
        ? axis_entry(sy, ty, row_begin + k, step_y, half_y, h, wc, row_offs[k], *entry)
        : axis_entry(sx, tx, k - rows, step_x, half_x, w, channels, col_offs[k - rows], *entry);
    if (nan) entry->w[0] = __int_as_float(0x7fc00000);
  }
  __syncthreads();

  const float* img = images + (int64_t)n * h * wc;
  float* o = out + ((int64_t)n * h_out + row_begin) * w_out * channels;
  const int pixels = rows * w_out;
  // pixel e = r * w_out + j of the band, advanced by kFwdThreads at a time
  // without a division: that is dr rows and dj columns
  const int dr = kFwdThreads / w_out, dj = kFwdThreads - dr * w_out;
  int r = tid / w_out, j = tid - r * w_out;
  for (int e = tid; e < pixels; e += kFwdThreads) {
    const TapOffsets yo = row_offs[r], xo = col_offs[j];
    const TapWeights yw = row_ws[r], xw = col_ws[j];
    float* dst = o + e * channels;
    for (int ch0 = 0; ch0 < channels; ch0 += kLoaded) {
      float v[kLoaded][2][2];
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const float* tap = img + yo.off[ky] + xo.off[kx] + ch0;
#pragma unroll
          for (int cc = 0; cc < kLoaded; ++cc) v[cc][ky][kx] = __ldg(tap + cc);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kLoaded; ++cc) {
        float acc = 0.0f;
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          float col = 0.0f;  // over the rows first, as ky . img
#pragma unroll
          for (int ky = 0; ky < 2; ++ky) {
            col += yw.w[ky] * (live(yw, ky) && live(xw, kx) ? v[cc][ky][kx] : 0.0f);
          }
          acc += xw.w[kx] * col;  // then over the columns, as (.) kx^T
        }
        dst[ch0 + cc] = acc;
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

// Dynamic shared memory of a kernel with tap tables for `rows` output rows
// and `cols` output columns.
size_t tap_table_bytes(int rows, int cols) {
  return (size_t)(rows + cols) * (sizeof(TapOffsets) + sizeof(TapWeights));
}

// Grid n * ctas, one cluster of ctas CTAs per image. Cluster rank r sums
// the elements (i, j, c) of its rows [r * h_out / ctas,
// (r + 1) * h_out / ctas); cluster_sum adds the four sums
// [sum g*dout/dpy*u_i, sum g*dout/dpy, sum g*dout/dpx*u_j, sum g*dout/dpx]
// over the cluster, and rank 0 writes the image's d theta. The CTA's
// threads form groups of w_out * c (rounded up to a warp) that each take
// every groups-th row; a thread keeps its column's taps in registers.
// Dynamic shared memory: the TapOffsets of the CTA's rows and of all w_out
// columns, then their TapWeights. Per element, with the core taps' values
// v, hat weights w and hat' dw:
//   dout/dp_y = sum_x wx * (sum_y dwy * v + extra_dwy * v(extra row)),
//   dout/dp_x = sum_x dwx * sum_y wy * v + extra_dwx * sum_y wy * v(extra
//   column),
// which is the sum over all three taps of each axis (the extra taps' hat
// is 0), so the extra taps cost loads only at ties.
__global__ void __launch_bounds__(kDthetaThreads, 1) separable_sampler_bwd_theta_kernel(
    const float* __restrict__ images, const float* __restrict__ theta,
    const float* __restrict__ g, float* __restrict__ d_theta, int h, int w,
    int c, int h_out, int w_out, float step_y, float step_x, int ctas) {
  extern __shared__ TapOffsets tables[];
  const int tid = threadIdx.x;
  const int rank = (int)cg::this_cluster().block_rank();
  const int64_t n = blockIdx.x / ctas;
  const int row_begin = rank * h_out / ctas;
  const int rows = (rank + 1) * h_out / ctas - row_begin;
  TapOffsets* row_offs = tables;
  TapOffsets* col_offs = tables + rows;
  TapWeights* row_ws = reinterpret_cast<TapWeights*>(tables + rows + w_out);
  TapWeights* col_ws = row_ws + rows;

  // theta (N, 2, 3) row-major: sx = t[0], tx = t[2], sy = t[4], ty = t[5].
  const float* t = theta + n * 6;
  const float sx = __ldg(t + 0), tx = __ldg(t + 2);
  const float sy = __ldg(t + 4), ty = __ldg(t + 5);
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  const int wc = w * c, row_len = w_out * c;
  bool nan = false;
  for (int k = tid; k < rows + w_out; k += kDthetaThreads) {
    nan |= k < rows
               ? axis_entry(sy, ty, row_begin + k, step_y, half_y, h, wc, row_offs[k], row_ws[k])
               : axis_entry(sx, tx, k - rows, step_x, half_x, w, c, col_offs[k - rows],
                            col_ws[k - rows]);
  }

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int col_threads = min(kDthetaThreads, (row_len + 31) & ~31);
  const int groups = kDthetaThreads / col_threads;
  const int group = tid / col_threads;
  if (__syncthreads_or(nan)) {  // a NaN hat row poisons the dense product
    for (int k = 0; k < 4; ++k) acc[k] = __int_as_float(0x7fc00000);
  } else if (group < groups) {
    const float* img = images + n * (int64_t)h * wc;
    const float* gn = g + (n * h_out + row_begin) * (int64_t)row_len;
    for (int jc = tid - group * col_threads; jc < row_len; jc += col_threads) {
      const int j = jc / c;
      const int ch = jc - j * c;
      const TapOffsets xo = col_offs[j];
      const TapWeights xw = col_ws[j];
      const float u_j = out_pos(j, step_x);
      for (int r0 = group; r0 < rows; r0 += kRowBatch * groups) {
        // every load of the batch first (a row past the CTA's last reads
        // the group's first again and is not summed)
        float v[kRowBatch][2][2], gv[kRowBatch];
#pragma unroll
        for (int b = 0; b < kRowBatch; ++b) {
          int r = r0 + b * groups;
          r = r < rows ? r : group;
          const int* yo = row_offs[r].off;
#pragma unroll
          for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
            for (int kx = 0; kx < 2; ++kx) {
              v[b][ky][kx] = __ldg(img + yo[ky] + xo.off[kx] + ch);
            }
          }
          gv[b] = __ldg(gn + r * row_len + jc);
        }
#pragma unroll
        for (int b = 0; b < kRowBatch; ++b) {
          const int r = r0 + b * groups;
          if (r >= rows) break;
          const TapWeights yw = row_ws[r];
          float d_py = 0.0f, d_px = 0.0f;  // dout/dp_y, dout/dp_x
#pragma unroll
          for (int kx = 0; kx < 2; ++kx) {
            float col = 0.0f, dcol = 0.0f;  // rows first, as ky . img
#pragma unroll
            for (int ky = 0; ky < 2; ++ky) {
              const float x = live(yw, ky) && live(xw, kx) ? v[b][ky][kx] : 0.0f;
              col += yw.w[ky] * x;
              dcol += yw.dw[ky] * x;
            }
            d_py += xw.w[kx] * dcol;
            d_px += xw.dw[kx] * col;
          }
          const float extra_dwy = row_offs[r].extra_dw;
          if (extra_dwy != 0.0f) {  // a tie row: hat' of the row above
            const int extra_off = row_offs[r].extra_off;
            float s = 0.0f;
            for (int kx = 0; kx < 2; ++kx) {
              if (live(xw, kx)) s += xw.w[kx] * __ldg(img + extra_off + xo.off[kx] + ch);
            }
            d_py += extra_dwy * s;
          }
          if (xo.extra_dw != 0.0f) {  // a tie column: hat' of the column left
            const int* yo = row_offs[r].off;
            float s = 0.0f;
            for (int ky = 0; ky < 2; ++ky) {
              if (live(yw, ky)) s += yw.w[ky] * __ldg(img + yo[ky] + xo.extra_off + ch);
            }
            d_px += xo.extra_dw * s;
          }
          const float gy = gv[b] * d_py, gx = gv[b] * d_px;
          acc[0] += gy * out_pos(row_begin + r, step_y);
          acc[1] += gy;
          acc[2] += gx * u_j;
          acc[3] += gx;
        }
      }
    }
  }
  const float sum = cluster_sum(acc, ctas);
  if (rank == 0 && tid < 4) {
    // d theta (2, 3) = [[half_x*S2, 0, half_x*S3], [0, half_y*S0, half_y*S1]]
    float* d = d_theta + n * 6;
    if (tid < 2) {
      d[4 + tid] = half_y * sum;
      d[1 + 2 * tid] = 0.0f;
    } else {
      d[2 * (tid - 2)] = half_x * sum;
    }
  }
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
  if ((int64_t)n * h_out * w_out * c == 0) return 0;
  // This library carries its own CUDA runtime, whose current card is not
  // PyTorch's: select it.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int band_rows = w_out < kFwdThreads ? kFwdThreads / w_out : 1;
  const int bands = (h_out + band_rows - 1) / band_rows;
  const int rows = (h_out + bands - 1) / bands;  // the most any CTA takes
  const size_t smem = tap_table_bytes(rows, w_out);
  auto kernel = c == 3 ? separable_sampler_fwd_kernel<3> : separable_sampler_fwd_kernel<0>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n * (unsigned)bands, kFwdThreads, smem, (cudaStream_t)stream>>>(
      images, theta, out, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), bands);
  return (int)cudaGetLastError();
}

// d theta (n, 2, 3) from images (n, h, w, c), theta (n, 2, 3) and the crop's
// cotangent g (n, h_out, w_out, c), all six entries. All float32,
// contiguous, on card `device`; offsets inside an image in 32 bits. One
// cluster launch on `stream`; returns its CUDA error (0 on success).
extern "C" int separable_sampler_bwd_theta(const float* images,
                                           const float* theta, const float* g,
                                           float* d_theta, int n, int h,
                                           int w, int c, int h_out, int w_out,
                                           int device, void* stream) {
  if (n == 0 || (int64_t)h_out * w_out * c == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int ctas = h_out < kClusterCtas ? h_out : kClusterCtas;
  const int rows = (h_out + ctas - 1) / ctas;  // the most any CTA takes
  const size_t smem = tap_table_bytes(rows, w_out);
  return (int)launch_clusters(separable_sampler_bwd_theta_kernel, n, ctas,
                              smem, (cudaStream_t)stream, images, theta, g,
                              d_theta, h, w, c, h_out, w_out,
                              out_step(h_out), out_step(w_out), ctas);
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
