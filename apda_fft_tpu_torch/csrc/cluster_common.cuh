// Thread-block clusters for rows longer than one block's shared memory:
// the row's split into segments, the walks' view of a row spread over a
// cluster, and the cluster launch.
//
// Included by lowlat_window.cu (B2 and B3, whose cluster kernels spread one
// window's FFT buffers over a cluster; they use the launch alone) and by
// prominence_select_scan.cu (B1) and prominence_scans.cu (B5), whose
// cluster kernels take one row per cluster of kClusterSize CTAs: CTA r
// holds segment r of the row (in its shared memory while it fits, else in
// device memory) and the 32-bin chunk summaries of that segment; a warp's
// walk reads the other CTAs' bins over distributed shared memory, and their
// summaries there too or, where the whole row's fit, from a copy each CTA
// gathers (gather_summaries).  The segments depend on the row length alone (kClusterSize is a
// portable cluster size on Hopper), so B1's threshold order does too
// (detector_common.cuh).

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "walk_common.cuh"

namespace apda {

namespace cg = cooperative_groups;

// CTAs of a row's cluster.
constexpr int kClusterSize = 8;
// Bins of a lane stride: a segment is a whole number of them.
constexpr int kSegmentStride = 128;
// Returned by launch_clusters (never a cudaError_t) when not one cluster of
// the launch can be placed on the device at its shared memory size.
constexpr int kClusterNotPlaced = -2;

// Bins of each CTA's segment of a row of h bins: h split into kClusterSize
// contiguous segments of a whole number of strides, the last one shorter.
__host__ __device__ __forceinline__ int segment_bins(int h) {
  const int stride = kClusterSize * kSegmentStride;
  return (h + stride - 1) / stride * kSegmentStride;
}

// The walks' view (walk_common.cuh warp_walk_row) of a row spread over the
// cluster: bin i lies in segment i / seg.  Chunk c's summaries lie in CTA
// c / (seg / 32), or, where every CTA has gathered the whole row's
// (gather_summaries), in this CTA's arrays at c.  Every CTA lays out its
// shared memory alike, so one CTA's pointers map to the same places in the
// others'.
struct ClusterRow {
  const float* x;  // the row in device memory
  float* xs;       // this CTA's segment in shared memory, or null: bins from x
  float* smax;     // chunk maxima and minima: the row's, or this CTA's segment's
  float* smin;
  int seg;
  bool whole;      // smax/smin hold the whole row's summaries
  __device__ __forceinline__ float bin(int i) const {
    if (xs == nullptr) return x[i];
    const int r = i / seg;
    return cg::this_cluster().map_shared_rank(xs, r)[i - r * seg];
  }
  __device__ __forceinline__ bool summed() const { return true; }
  __device__ __forceinline__ float cmin(int c) const { return summary(smin, c); }
  __device__ __forceinline__ float cmax(int c) const { return summary(smax, c); }
  __device__ __forceinline__ float summary(float* s, int c) const {
    if (whole) return s[c];
    const int per = seg >> 5, r = c / per;
    return cg::this_cluster().map_shared_rank(s, r)[c - r * per];
  }
};

// Each CTA's chunk summaries lie at smax/smin[rank * per ..) of arrays of
// kClusterSize * per entries in every CTA (16-byte aligned, per a multiple
// of 4): after a cluster barrier that follows their building, copies the
// other CTAs' parts into this CTA's arrays with 16-byte loads, four in
// flight a thread, so that the walks read them from local shared memory.
// Needs a block barrier before they are read.
__device__ __forceinline__ void gather_summaries(float* smax, float* smin, int per) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int per4 = per / 4, n4 = kClusterSize * per4;
  float4* mx = reinterpret_cast<float4*>(smax);
  float4* mn = reinterpret_cast<float4*>(smin);
  for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * blockDim.x) {
    float4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per4;
      if (i < n4 && r != rank) {
        a[u] = cluster.map_shared_rank(mx, r)[i];
        b[u] = cluster.map_shared_rank(mn, r)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4 && i / per4 != rank) {
        mx[i] = a[u];
        mn[i] = b[u];
      }
    }
  }
}

// xs[0..n) <- src[0..n) for one CTA: every 16-byte piece in flight at once
// (cp.async, no registers held), where src and n allow it, else load_row.
// Needs a block barrier before xs is read.
__device__ __forceinline__ void load_segment(const float* __restrict__ src, float* xs, int n) {
  if ((n & 3) != 0 || (reinterpret_cast<size_t>(src) & 15) != 0) {
    load_row(src, xs, n);
    return;
  }
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
    __pipeline_memcpy_async(xs + 4 * q, src + 4 * q, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Launches `kernel` over `blocks` CTAs of `threads` threads in clusters of
// kClusterSize, with `smem` bytes of dynamic shared memory each.  Before
// the first launch at a size above checked[device] it opts in to the size
// and asks how many such clusters the device can hold at once:
// kClusterNotPlaced when none.  Returns 0 or a cudaError_t.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int blocks, int threads, size_t smem,
                    cudaStream_t stream, int device, size_t* checked, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool known = device >= 0 && device < 64 && checked[device] >= smem + 1;
  if (!known) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kClusterNotPlaced;
    if (device >= 0 && device < 64) checked[device] = smem + 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace apda
