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
// Backward, d images (separable_sampler_bwd_images): d img = ky^T . g . kx
// per channel. What bounds it: bytes, writing all of d images (38.5 MB at
// N = 64, 224^2x3) and reading g (4.3 MB), about 12.8 us of HBM time; each
// element needs only the few products whose taps reach it. A scatter from
// the outputs (each adding to its <= 4 taps) needs the gradient zeroed
// first and float atomics, whose order of sums changes from run to run, and
// a second pass for NaN: four device operations. The design is a gather,
// one launch, each element of d images computed by one thread:
// - One CTA of kDimgThreads threads per tile of one image: a band of whole
//   input rows, at most kDimgSeg floats of each (all of a 224 x 3 row),
//   about kDimgItems float4 stores (6 rows at 224^2x3, 2,432 CTAs at
//   N = 64).
// - Reach tables, built once per CTA in dynamic shared memory: every output
//   row's and column's position from sample_pos (the one function every K1
//   kernel uses), then for each of the tile's input rows and columns x the
//   range [begin, end) of outputs whose hat reaches it: each output files
//   itself under its two taps floor(p), floor(p) + 1 where |p - x| < 1 by
//   integer atomicMin / atomicMax (the same result in any order). The
//   positions are monotone in the output index (each _rn operation of
//   sample_pos is monotone), so the outputs reaching x are a contiguous
//   range: exactly those where the plain version's hat is non-zero, for a
//   flipped (negative) scale too, and all h_out outputs at scale 0. Their
//   unions give the output rows (the span) and columns (the window) that
//   reach the tile.
// - Columns first, then rows, as the plain version, kDimgStageRows output
//   rows of the span at a time (one stage at 224^2 -> 75^2, where the
//   span is 3 rows): their window of g is copied into shared memory with
//   coalesced loads, several in flight per thread (read from global memory
//   directly where the window is wider than kDimgGRow floats); then the
//   column sums T[i, x, c] = sum_j hat(px_j - x) * g[i, j, c] over the
//   reach of x, one thread per (i, x), into a shared stage laid out as d
//   images' rows; then each thread takes float4 stores of the tile, adds
//   sum_i hat(py_i - y) * T[i, x..x+3] over the stage's i in the reach of
//   its row y (four elements per shared load) and stores them (rows_pass).
//   No sum waits on a load of global memory. An element no output reaches
//   is a zero. Each element is stored once; where the span outgrows one
//   stage (a zero scale, an upsampled crop) a later stage adds onto the
//   first's store, the same thread in a fixed order. No atomics on
//   floats, no scratch: bit-identical between runs. A thread holds no sums
//   across stages, which keeps it at 48 registers, five CTAs an SM; sums
//   held in registers (80 registers) measured slower (PERF.md).
// - NaN inside the launch: the CTA holds every position of its image, and
//   if any is NaN it stores NaN over its tile, as the dense product
//   poisons that whole image's gradient.
// Not launched on the training path, whose images need no gradient.

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

// d images: kDimgThreads threads per CTA; a CTA takes a tile of whole
// input rows (a band) and of at most kDimgSeg floats of them (a segment),
// about kDimgItems stores.
constexpr int kDimgThreads = 256;
constexpr int kDimgItems = 4 * kDimgThreads;
constexpr int kDimgSeg = 2048;
// Output rows of g, and of their column sums, staged in shared memory at a
// time; at most kDimgGRow floats of each g row (the columns that reach the
// CTA's segment) are staged, a wider window is read from global memory.
constexpr int kDimgStageRows = 4;
constexpr int kDimgGRow = 2048;

template <int kVec> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<4> { using T = float4; };

__device__ __forceinline__ void axpy(float& acc, float a, float v) { acc += a * v; }
__device__ __forceinline__ void axpy(float4& acc, float a, float4 v) {
  acc.x += a * v.x;
  acc.y += a * v.y;
  acc.z += a * v.z;
  acc.w += a * v.w;
}
__device__ __forceinline__ float splat(float v, float) { return v; }
__device__ __forceinline__ float4 splat(float v, float4) { return make_float4(v, v, v, v); }

// Grid n * bands * segs; CTA (b, s) of image n takes the input rows
// [b * h / bands, (b + 1) * h / bands) and the floats [s * seg, (s + 1) *
// seg) of each (seg a multiple of C and of kVec, every segment but the last
// seg long). kVec floats per store: 4 (a float4) where W * C is a multiple
// of 4 and d images 16-byte aligned, else 1. Dynamic shared memory: the
// stage of kDimgStageRows x seg floats (first, so 16-byte aligned), the
// reach ranges of the segment's input columns and of the CTA's rows (int2),
// then the h_out row and w_out column positions. Three phases:
//   tables: positions, NaN test, reach ranges; the output rows [i_lo, i_hi)
//     that reach the band;
//   stage, kDimgStageRows output rows i at a time: the column sums
//     T[i, x, c] = sum_j hat(px_j - x) * g[i, j, c] over the reach of x,
//     one thread per (i, x), from g's rows staged in shared memory;
//   rows (rows_pass): d img[y, x, c] += hat(py_i - y) * T[i, x, c] for the
//     i of the stage in the reach of y, a whole kVec-float store's worth
//     read from the stage at once, and stored.
// kC is the channel count (3 on the main path); 0 takes any C.
template <int kC, int kVec>
__global__ void __launch_bounds__(kDimgThreads) separable_sampler_bwd_images_kernel(
    const float* __restrict__ theta, const float* __restrict__ g,
    float* __restrict__ d_images, int h, int w, int c, int h_out, int w_out,
    float step_y, float step_x, int bands, int segs, int seg, int g_cap) {
  using Vec = typename VecOf<kVec>::T;
  constexpr int kLoaded = kC > 0 ? kC : 1;  // channels summed together
  const int channels = kC > 0 ? kC : c;
  extern __shared__ float4 smem[];
  __shared__ int span_lo, span_hi, window_lo, window_hi;
  const int tid = threadIdx.x;
  const int n = (int)(blockIdx.x / (unsigned)(bands * segs));
  const int tile = (int)blockIdx.x - n * bands * segs;
  const int band = tile / segs;
  const int f_begin = (tile - band * segs) * seg;
  const int row_len = w * channels;  // floats of one input row
  const int f_len = min(seg, row_len - f_begin);
  const int x_begin = f_begin / channels, xs = f_len / channels;
  const int row_begin = (int)((int64_t)band * h / bands);
  const int rows = (int)((int64_t)(band + 1) * h / bands) - row_begin;
  float* stage = reinterpret_cast<float*>(smem);  // [kDimgStageRows][seg]
  int2* col_reach = reinterpret_cast<int2*>(stage + kDimgStageRows * seg);  // of x_begin + k
  int2* row_reach = col_reach + xs;
  float* py = reinterpret_cast<float*>(row_reach + rows);
  float* px = py + h_out;
  float* g_stage = px + w_out;  // [kDimgStageRows][g_cap]
  const int chunks = f_len / kVec;  // stores per row of the tile
  const int items = rows * chunks;
  float* dst = d_images + ((int64_t)n * h + row_begin) * row_len + f_begin;

  // theta (N, 2, 3) row-major: sx = t[0], tx = t[2], sy = t[4], ty = t[5].
  const float* t = theta + (int64_t)n * 6;
  const float sx = __ldg(t + 0), tx = __ldg(t + 2);
  const float sy = __ldg(t + 4), ty = __ldg(t + 5);
  const float half_y = 0.5f * (float)(h - 1), half_x = 0.5f * (float)(w - 1);
  bool nan = false;
  for (int k = tid; k < h_out + w_out; k += kDimgThreads) {
    const float p = k < h_out ? sample_pos(sy, ty, k, step_y, half_y)
                              : sample_pos(sx, tx, k - h_out, step_x, half_x);
    py[k] = p;  // px = py + h_out
    nan |= isnan(p);
  }
  for (int k = tid; k < xs + rows; k += kDimgThreads) col_reach[k] = make_int2(INT_MAX, 0);
  if (tid == 0) {
    span_lo = window_lo = INT_MAX;
    span_hi = window_hi = 0;
  }
  if (__syncthreads_or(nan)) {  // a NaN hat poisons the whole dense product
    const Vec v = splat(__int_as_float(0x7fc00000), Vec());
    for (int e = tid; e < items; e += kDimgThreads) {
      const int r = e / chunks;
      reinterpret_cast<Vec*>(dst + r * row_len)[e - r * chunks] = v;
    }
    return;
  }
  // The reach ranges: each output k files itself under its taps
  // floor(p_k) + t, t = 0, 1, on the tile where |p_k - x| < 1 (every input
  // index where its hat is non-zero, and only those), by integer min and
  // max, whose result is the same in any order. The positions are monotone
  // in k, so each range holds exactly the outputs whose hat reaches x. The
  // unions, reduced per warp: the output rows that reach the band (the
  // span) and the output columns that reach the segment (the window).
  for (int k0 = 0; k0 < h_out + w_out; k0 += kDimgThreads) {
    const int k = k0 + tid;
    const bool is_row = k < h_out;
    const int idx = is_row ? k : k - h_out, first = is_row ? row_begin : x_begin;
    const int count = is_row ? rows : xs;
    int row_lo = INT_MAX, row_hi = 0, col_lo = INT_MAX, col_hi = 0;
    if (k < h_out + w_out) {
      const float p = py[k];  // px = py + h_out
      const float f = floorf(p);
      if (f >= (float)(first - 1) && f <= (float)(first + count - 1)) {
        for (int t = 0; t < 2; ++t) {
          const int x = (int)f + t;
          if (x < first || x >= first + count || !(fabsf(__fsub_rn(p, (float)x)) < 1.0f)) continue;
          int2* range = (is_row ? row_reach : col_reach) + (x - first);
          atomicMin(&range->x, idx);
          atomicMax(&range->y, idx + 1);
          (is_row ? row_lo : col_lo) = idx;
          (is_row ? row_hi : col_hi) = idx + 1;
        }
      }
    }
    row_lo = __reduce_min_sync(0xffffffffu, row_lo);
    row_hi = __reduce_max_sync(0xffffffffu, row_hi);
    col_lo = __reduce_min_sync(0xffffffffu, col_lo);
    col_hi = __reduce_max_sync(0xffffffffu, col_hi);
    if ((tid & 31) == 0) {
      if (row_lo < row_hi) {
        atomicMin(&span_lo, row_lo);
        atomicMax(&span_hi, row_hi);
      }
      if (col_lo < col_hi) {
        atomicMin(&window_lo, col_lo);
        atomicMax(&window_hi, col_hi);
      }
    }
  }
  __syncthreads();

  // Adds, for each store of the tile, sum_i hat(py_i - y) * T[i, x..] over
  // the stage's i in the reach of its row y: the first stage writes every
  // store (zeros where no i of it reaches), a later one only the stores
  // some i of it reaches, onto what the first wrote (the same thread's
  // element, so each sum runs over i in order).
  auto rows_pass = [&](int i0, int stage_rows, bool first) {
    const int dr = kDimgThreads / chunks, dq = kDimgThreads - dr * chunks;
    int r = tid / chunks, q = tid - r * chunks;
    for (int e = tid; e < items; e += kDimgThreads) {
      const int2 ri = row_reach[r];
      const int lo = max(ri.x, i0), hi = min(ri.y, i0 + stage_rows);
      Vec* out = reinterpret_cast<Vec*>(dst + r * row_len) + q;
      if (first || lo < hi) {
        Vec acc = first ? splat(0.0f, Vec()) : *out;
        const int y = row_begin + r;
        for (int i = lo; i < hi; ++i) {  // then over the rows, as ky^T . (.)
          axpy(acc, hat(py[i], y), reinterpret_cast<const Vec*>(stage + (i - i0) * seg)[q]);
        }
        *out = acc;
      }
      r += dr;
      q += dq;
      if (q >= chunks) {
        q -= chunks;
        ++r;
      }
    }
  };
  const float* gn = g + (int64_t)n * h_out * w_out * channels;
  const int g_row = w_out * channels;
  const int i_begin = span_lo, i_end = span_hi;
  const int window = max(0, window_hi - window_lo) * channels;
  const int j_begin = window > 0 ? window_lo : 0;
  // g's window of a staged row, or g itself where the window is too wide
  const bool staged = window <= g_cap;
  const int src_row = staged ? g_cap : g_row, src_col = staged ? j_begin : 0;
  for (int i0 = i_begin; i0 < i_end; i0 += kDimgStageRows) {
    const int stage_rows = min(kDimgStageRows, i_end - i0);
    __syncthreads();  // every thread is done with the last stage
    if (staged) {  // coalesced loads, several in flight per thread
      for (int r = 0; r < stage_rows; ++r) {
        const float* gi = gn + (i0 + r) * g_row + j_begin * channels;
#pragma unroll 4
        for (int k = tid; k < window; k += kDimgThreads) g_stage[r * g_cap + k] = __ldg(gi + k);
      }
      __syncthreads();
    }
    const float* src = staged ? g_stage : gn + i0 * g_row;
    // entries (r, x) of the stage, stepped without a division
    const int dr = kDimgThreads / xs, dx = kDimgThreads - dr * xs;
    int r = tid / xs, xl = tid - r * xs;
    for (int e = tid; e < stage_rows * xs; e += kDimgThreads) {
      const int2 rj = col_reach[xl];
      const int x = x_begin + xl;
      const float* gi = src + r * src_row;
      float* out = stage + r * seg + xl * channels;
      for (int ch0 = 0; ch0 < channels; ch0 += kLoaded) {
        float s[kLoaded];
#pragma unroll
        for (int cc = 0; cc < kLoaded; ++cc) s[cc] = 0.0f;
        for (int j = rj.x; j < rj.y; ++j) {  // over the columns first, as kx . g
          const float wx = hat(px[j], x);
          const float* gj = gi + (j - src_col) * channels + ch0;
#pragma unroll
          for (int cc = 0; cc < kLoaded; ++cc) s[cc] += wx * gj[cc];
        }
#pragma unroll
        for (int cc = 0; cc < kLoaded; ++cc) out[ch0 + cc] = s[cc];
      }
      r += dr;
      xl += dx;
      if (xl >= xs) {
        xl -= xs;
        ++r;
      }
    }
    __syncthreads();
    rows_pass(i0, stage_rows, i0 == i_begin);
  }
  if (i_begin >= i_end) rows_pass(0, 0, true);  // no output row reaches the tile: zeros
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
// (n, h_out, w_out, c), h_out and w_out at least 1, c at most kDimgItems.
// All float32, contiguous, on card `device`; offsets inside an image in 32
// bits. One launch on `stream` that writes every element; returns its CUDA
// error (0 on success; cudaErrorInvalidValue for a wider c or a crop whose
// positions overflow shared memory).
extern "C" int separable_sampler_bwd_images(const float* theta, const float* g,
                                            float* d_images, int n, int h,
                                            int w, int c, int h_out, int w_out,
                                            int device, void* stream) {
  if ((int64_t)n * h * w * c == 0) return 0;
  if (c > kDimgItems) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int row_len = w * c;
  const bool vec = row_len % 4 == 0 && c <= kDimgSeg / 4 &&
                   reinterpret_cast<uintptr_t>(d_images) % 16 == 0;
  // a segment holds whole pixels and whole stores: a multiple of c (and of
  // 4 c / gcd(c, 4) with float4 stores), at most kDimgItems stores
  const int unit = vec ? (c % 4 == 0 ? c : (c % 2 == 0 ? 2 * c : 4 * c)) : c;
  const int most = vec ? kDimgSeg : kDimgItems;
  const int seg = min(row_len, most / unit * unit);
  const int segs = (row_len + seg - 1) / seg;
  const int chunks = vec ? seg / 4 : seg;
  const int band_rows = max(1, kDimgItems / chunks);
  const int bands = (h + band_rows - 1) / band_rows;
  const int rows = (h + bands - 1) / bands;  // the most any CTA takes
  const int g_cap = min(w_out * c, kDimgGRow);
  const size_t smem = (size_t)kDimgStageRows * seg * sizeof(float) +
                      (size_t)(seg / c + rows) * sizeof(int2) +
                      (size_t)(h_out + w_out + kDimgStageRows * g_cap) * sizeof(float);
  auto kernel = c == 3 ? (vec ? separable_sampler_bwd_images_kernel<3, 4>
                              : separable_sampler_bwd_images_kernel<3, 1>)
                       : (vec ? separable_sampler_bwd_images_kernel<0, 4>
                              : separable_sampler_bwd_images_kernel<0, 1>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n * (unsigned)(bands * segs), kDimgThreads, smem, (cudaStream_t)stream>>>(
      theta, g, d_images, h, w, c, h_out, w_out, out_step(h_out),
      out_step(w_out), bands, segs, seg, g_cap);
  return (int)cudaGetLastError();
}
