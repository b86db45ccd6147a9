// Device code shared by the port's detector kernels: block reductions, the
// candidate walk order, and the noise threshold.
//
// Included, through walk_common.cuh, by prominence_select_scan.cu and
// prominence_scans.cu (one block per window of a batch) and by
// lowlat_window.cu (one block for one whole window).  Everything that feeds
// a decision uses explicitly rounded IEEE operations (no FMA contraction,
// IEEE division and sqrt); build without fast math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace apda {

struct Pick {  // a candidate in walk order: score descending, index ascending
  float s;
  int i;
};
struct I2 {
  int a, b;
};

__device__ __forceinline__ float shfl(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ int shfl(int v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ Pick shfl(Pick v, int o) { return {shfl(v.s, o), shfl(v.i, o)}; }
__device__ __forceinline__ I2 shfl(I2 v, int o) { return {shfl(v.a, o), shfl(v.b, o)}; }

__device__ __forceinline__ bool before(Pick p, Pick q) {
  return p.s > q.s || (p.s == q.s && p.i < q.i);
}

struct SumF {
  __device__ float operator()(float p, float q) const { return __fadd_rn(p, q); }
};
struct SumI {
  __device__ int operator()(int p, int q) const { return p + q; }
};
struct First {
  __device__ Pick operator()(Pick p, Pick q) const { return before(p, q) ? p : q; }
};
struct MaxMinI {
  __device__ I2 operator()(I2 p, I2 q) const { return {max(p.a, q.a), min(p.b, q.b)}; }
};

// Block-wide reduction; every thread gets the result.  `red` holds one
// partial per warp and is free again when this returns.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl(v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nwarps; ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

// Per-warp partials of every reduction type, for blocks of up to W warps.
template <int W>
struct Scratch {
  float f[W];
  int i[W];
  Pick p[W];
  I2 i2[W];
};

// The selection score: the magnitude rounded half to even to 4 decimals.
__device__ __forceinline__ float score_of(float v) {
  return __fdiv_rn(rintf(__fmul_rn(v, 1e4f)), 1e4f);
}

// Noise threshold mean + 2*std (ddof=1) of x[0..h), in two passes like the
// reference (sum -> mean, then the sum of squared deviations / (h-1)).
//
// THE THRESHOLD ORDER of the select+scan detector (B1), a function of h
// alone, which its plain twin (ops/stats.py `ordered_mean_std`) follows bit
// for bit.  Each sum - the bins, then the squared deviations about the
// rounded mean, each d = x - mean and d*d rounded - is taken so:
//   * h <= kSharedMaxH (57856; this function in a block of 128 threads, or
//     of roundup32(h) below h = 128, whose missing lanes would add +0.0 and
//     leave every rounded result unchanged): 128 lanes, lane l adding
//     x[l], x[l+128], ... in increasing index with plain rounded adds from
//     +0.0; then block_reduce: the xor butterfly at offsets 16, 8, 4, 2, 1
//     within each warp of 32 lanes, then the four warp sums in order;
//   * longer rows (prominence_select_scan.cu's cluster kernel): kClusterSize
//     contiguous segments of segment_bins(h) bins (a whole number of 128-lane
//     strides; the last segment shorter), CTA r summing segment r like a
//     short row but with Kahan-compensated lanes run over whole strides (the
//     missing bins of the last segment are +0.0 terms, which a compensated
//     lane does not skip), the lane's running sum taken as its value; then
//     the segments' partials added in rank order.
template <typename S>
__device__ float noise_threshold(const float* x, int h, S& sc, float* sd_out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) s = __fadd_rn(s, x[i]);
  s = block_reduce(s, SumF(), sc.f);
  const float mean = __fdiv_rn(s, (float)h);
  float v = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float d = __fsub_rn(x[i], mean);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  v = block_reduce(v, SumF(), sc.f);
  const float sd = __fsqrt_rn(__fdiv_rn(v, (float)(h - 1)));
  *sd_out = sd;
  return __fadd_rn(mean, __fmul_rn(2.0f, sd));
}

// A strict interior local maximum of x[0..h) above the threshold.
__device__ __forceinline__ bool is_candidate(const float* x, int h, int i, float thr) {
  return i >= 1 && i <= h - 2 && x[i] > x[i - 1] && x[i] > x[i + 1] && x[i] > thr;
}

}  // namespace apda
