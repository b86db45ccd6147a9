// Fused candidate selection + prominence/width scans of the flexible
// (prominence) detector, one thread block per window, for sm_90a.
//
// Replaces the TPU kernel `prominence_select_scan_pallas`
// (apda_fft_tpu/ops/detector_pallas.py, body `_fused_kernel`).  For each row
// x[0..H) of a [B, H] float32 magnitude batch it computes:
//   * the noise threshold mean + 2*std (ddof=1), in two passes like the
//     reference (sum -> mean, then the sum of squared deviations / (H-1));
//   * the strict interior local maxima above it and their count n_cand;
//   * up to min(n_cand, M) picks in the reference's walk order: the
//     4-dp-rounded magnitude descending, ties by ascending bin;
//   * per pick, the prominence (peak minus the higher flanking valley, each
//     valley bounded by the nearest sample above the peak) and the -3 dB
//     width in bins at valley + 0.707*prominence;
//   * for the slots past n_cand, the fill an exhausted argmax gives:
//     bin 0, is_cand 0, magnitude x[0], and the scans at (0, x[0]).
//
// What bounds it on the card: not bytes (the row is read from device memory
// once) but a latency-bound chain of block reductions - per live round one
// selection reduction and three scan reductions (blockers, valleys, width
// stops), each a warp-shuffle tree plus two __syncthreads, on a row that
// sits in shared memory.  The design answers that with one block per window:
// B independent chains run side by side on the SMs, so the card's
// parallelism comes from the batch, while each block keeps its row in
// shared memory (H*4 bytes: 8 KB at N=4096, 128 KB at N=65536) and needs no
// second H-sized buffer.  Round s finds the candidate that comes next after
// round s-1's pick in (score desc, index asc) order, computing scores on
// the fly, so no mask-out array is written.  Rows stop after their own live
// rounds.
//
// Arithmetic that decides: the selection score rint(x*1e4)/1e4, the
// threshold and the width target use explicitly rounded IEEE operations
// (no FMA contraction, IEEE division and sqrt); build without fast math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

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

__device__ __forceinline__ float score_of(float v) {
  return __fdiv_rn(rintf(__fmul_rn(v, 1e4f)), 1e4f);
}

struct Scratch {
  float f[kMaxWarps];
  int i[kMaxWarps];
  Pick p[kMaxWarps];
  F2 f2[kMaxWarps];
  I2 i2[kMaxWarps];
};

// Prominence and width in bins of the peak (j, peak) on the row x[0..h).
__device__ void scan_at(const float* x, int h, int j, float peak, Scratch& sc,
                        float* prom_out, int* bins_out) {
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

__global__ void __launch_bounds__(kMaxThreads)
select_scan_kernel(const float* __restrict__ mags, int h, int m, int* __restrict__ cid,
                   unsigned char* __restrict__ is_cand, float* __restrict__ cmag,
                   float* __restrict__ prom, int* __restrict__ bins,
                   float* __restrict__ std_out, int* __restrict__ ncand_out) {
  extern __shared__ float x[];
  __shared__ Scratch sc;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row = blockIdx.x;
  const float* src = mags + row * (size_t)h;
  for (int i = tid; i < h; i += nt) x[i] = src[i];
  __syncthreads();

  // Threshold: mean + 2*std, ddof=1.
  float s = 0.f;
  for (int i = tid; i < h; i += nt) s = __fadd_rn(s, x[i]);
  s = block_reduce(s, SumF(), sc.f);
  const float mean = __fdiv_rn(s, (float)h);
  float v = 0.f;
  for (int i = tid; i < h; i += nt) {
    const float d = __fsub_rn(x[i], mean);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  v = block_reduce(v, SumF(), sc.f);
  const float sd = __fsqrt_rn(__fdiv_rn(v, (float)(h - 1)));
  const float thr = __fadd_rn(mean, __fmul_rn(2.0f, sd));

  auto candidate = [&](int i) {
    return i >= 1 && i <= h - 2 && x[i] > x[i - 1] && x[i] > x[i + 1] && x[i] > thr;
  };
  int c = 0;
  for (int i = tid; i < h; i += nt) c += candidate(i) ? 1 : 0;
  const int n_cand = block_reduce(c, SumI(), sc.i);
  const int live = min(n_cand, m);
  const size_t o = row * (size_t)m;

  Pick prev = {0.f, -1};
  for (int r = 0; r < live; ++r) {
    Pick best = {-INFINITY, h};  // loses to every candidate
    for (int i = tid; i < h; i += nt) {
      if (!candidate(i)) continue;
      const Pick p = {score_of(x[i]), i};
      if ((r == 0 || before(prev, p)) && before(p, best)) best = p;
    }
    best = block_reduce(best, First(), sc.p);
    float pr;
    int bn;
    scan_at(x, h, best.i, x[best.i], sc, &pr, &bn);
    if (tid == 0) {
      cid[o + r] = best.i;
      is_cand[o + r] = 1;
      cmag[o + r] = x[best.i];
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
    prev = best;
  }
  if (live < m) {
    float pr;
    int bn;
    scan_at(x, h, 0, x[0], sc, &pr, &bn);
    for (int r = live + tid; r < m; r += nt) {
      cid[o + r] = 0;
      is_cand[o + r] = 0;
      cmag[o + r] = x[0];
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
  }
  if (tid == 0) {
    std_out[row] = sd;
    ncand_out[row] = n_cand;
  }
}

}  // namespace

extern "C" {

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// on `stream`; outputs are [b, m] slots and [b] per-row values.  Returns the
// cudaError_t of the launch (0 on success).
int apda_prominence_select_scan(const float* mags, int b, int h, int m, int* cid,
                                unsigned char* is_cand, float* cmag, float* prom,
                                int* bins, float* std_out, int* ncand_out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  int threads = h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)h * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(select_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  select_scan_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      mags, h, m, cid, is_cand, cmag, prom, bins, std_out, ncand_out);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
