// Pieces shared by the crop kernels' sources (separable_sampler.cu,
// rotated_sampler.cu): the launch width, the output positions as the plain
// PyTorch version forms them, the NaN fill of d images, the dynamic
// shared-memory limit, the d theta kernels' cluster reduction and cluster
// launch, and the C error entry point. Each library includes this file;
// ops/_cuda.py hashes it into every library's build key.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// The d theta kernels: one thread-block cluster of at most kClusterCtas
// CTAs of kDthetaThreads threads per image; at N = 64, 128 CTAs, one per
// SM of the H100's 132, all running at once. More and smaller CTAs per
// image (clusters of 4 or 8) measured slower at N = 64 on the H100 (see
// PERF.md): a GPC holds only whole clusters, so at 64 registers a thread
// fewer than 64 clusters of 8 CTAs of 256 threads fit at once, and every
// CTA pays for building its tap tables and for the cluster barriers.
constexpr int kDthetaThreads = 512;
constexpr int kClusterCtas = 2;

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

// Sums acc[k] over every thread of the calling thread-block cluster, in a
// fixed order: down each warp with shuffles, over the CTA's warps in warp
// order, then over the cluster's `ctas` CTAs in rank order, which rank 0
// reads from their shared memory. No atomics, so the result is the same on
// every run. Every thread of every CTA of the cluster must call it
// (kDthetaThreads per CTA). Thread k < kSums of cluster rank 0 gets sum k;
// every other thread gets 0.
template <int kSums>
__device__ float cluster_sum(float (&acc)[kSums], int ctas) {
  constexpr int kWarps = kDthetaThreads / 32;
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float cta_sums[kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], offset);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = warp_sums[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    cta_sums[threadIdx.x] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's cta_sums written and visible
  float total = 0.0f;
  if (cluster.block_rank() == 0 && threadIdx.x < kSums) {
    total = cta_sums[threadIdx.x];
    for (int r = 1; r < ctas; ++r) {
      total += *cluster.map_shared_rank(&cta_sums[threadIdx.x], r);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 still reads its memory
  return total;
}

// Lets `kernel` launch with `smem` bytes of dynamic shared memory: raises
// its limit past the default 48 KB when asked for more. Returns the CUDA
// error (cudaErrorInvalidValue past the card's 227 KB) and clears it, so a
// later call does not read it again.
template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Launches `kernel` on one 1-D cluster of `ctas` CTAs (kDthetaThreads
// each) per image, n images, with `smem` bytes of dynamic shared memory
// (allow_smem). Returns the CUDA error of the launch (0 on success) and
// clears it, so a later call does not read it again.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int n, int ctas,
                            size_t smem, cudaStream_t stream,
                            Args... args) {
  const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)n * (unsigned)ctas);
  config.blockDim = dim3(kDthetaThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)ctas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
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
