// Device code shared by the port's detector kernels: block reductions, the
// candidate walk order, the noise threshold and the prominence/width scan.
//
// Included by prominence_select_scan.cu (one block per window of a batch)
// and lowlat_window.cu (one block for one whole window).  Everything that
// feeds a decision uses explicitly rounded IEEE operations (no FMA
// contraction, IEEE division and sqrt); build without fast math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace apda {

struct Pick {  // a candidate in walk order: score descending, index ascending
  float s;
  int i;
};
struct F2 {
  float a, b;
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
__device__ __forceinline__ F2 shfl(F2 v, int o) { return {shfl(v.a, o), shfl(v.b, o)}; }
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
struct MinMinF {
  __device__ F2 operator()(F2 p, F2 q) const {
    return {q.a < p.a ? q.a : p.a, q.b < p.b ? q.b : p.b};
  }
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
  F2 f2[W];
  I2 i2[W];
};

// The selection score: the magnitude rounded half to even to 4 decimals.
__device__ __forceinline__ float score_of(float v) {
  return __fdiv_rn(rintf(__fmul_rn(v, 1e4f)), 1e4f);
}

// Noise threshold mean + 2*std (ddof=1) of x[0..h), in two passes like the
// reference (sum -> mean, then the sum of squared deviations / (h-1)).
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

// Prominence and width in bins of the peak (j, peak) on the row x[0..h).
template <typename S>
__device__ void scan_at(const float* x, int h, int j, float peak, S& sc, float* prom_out,
                        int* bins_out) {
  const int nt = blockDim.x;
  // Nearest blockers (samples above the peak) on each side.
  I2 blk = {-1, h};
  for (int i = threadIdx.x; i < h; i += nt) {
    if (x[i] > peak) {
      if (i < j) blk.a = max(blk.a, i);
      if (i > j) blk.b = min(blk.b, i);
    }
  }
  blk = block_reduce(blk, MaxMinI(), sc.i2);
  // Valleys: minima over the open intervals (blocker, j) and (j, blocker).
  F2 mn = {INFINITY, INFINITY};
  for (int i = threadIdx.x; i < h; i += nt) {
    const float xi = x[i];
    if (i > blk.a && i < j && xi < mn.a) mn.a = xi;
    if (i > j && i < blk.b && xi < mn.b) mn.b = xi;
  }
  mn = block_reduce(mn, MinMinF(), sc.f2);
  const float min_left = mn.a < peak ? mn.a : peak;
  const float min_right = mn.b < peak ? mn.b : peak;
  const float prom = __fsub_rn(peak, fmaxf(min_left, min_right));
  const float valley = __fsub_rn(peak, prom);
  const float target = __fadd_rn(valley, __fmul_rn(prom, 0.707f));
  // Width stops: nearest index on each side at or below the target, or
  // above the peak; clamped to [0, h-1].
  I2 st = {0, h - 1};
  for (int i = threadIdx.x; i < h; i += nt) {
    const float xi = x[i];
    if (xi <= target || xi > peak) {
      if (i <= j) st.a = max(st.a, i);
      if (i >= j) st.b = min(st.b, i);
    }
  }
  st = block_reduce(st, MaxMinI(), sc.i2);
  *prom_out = prom;
  *bins_out = max(st.b - st.a, 1);
}

}  // namespace apda
