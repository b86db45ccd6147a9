// Warp-level device code of the port's detector kernels ("warp walks"): the
// row load, the 32-bin chunk summaries, the walk-order keys with their
// compaction and ranking, and the prominence / width scan of one peak by
// one warp.
//
// Included by prominence_select_scan.cu (B1), prominence_scans.cu (B5) and
// lowlat_window.cu (both single-window kernels, B2 and B3).  A row may lie
// in shared or in device memory.  Every value is an order, a
// compare, a min or max, or the reference's explicitly rounded arithmetic,
// so a warp's scan gives the same bits as the masked-reduction scans of the
// plain twins (ops/peaks_prominence.py `_prominence_and_width`), however
// the work is split.  Build without fast math.

#pragma once

#include "detector_common.cuh"

namespace apda {

constexpr unsigned kFull = 0xffffffffu;
// Keys a shared candidate list holds at most.  A row has at most h/5
// samples at or above mean + 2*std (Cantelli's inequality), so h/4 + 2 keys
// hold every candidate of any row up to this cap.
constexpr int kMaxList = 4096;

// The row's 32-bin chunks.
__host__ __device__ __forceinline__ int n_chunks(int h) { return (h + 31) / 32; }

// x[0..h) <- src[0..h): four independent loads in flight per thread, 16
// bytes each where the row allows it.
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* x, int h) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if ((h & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* x4 = reinterpret_cast<float4*>(x);
    const int h4 = h / 4;
    for (int q0 = tid; q0 < h4; q0 += 4 * nt) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u * nt < h4) v[u] = __ldg(s4 + q0 + u * nt);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u * nt < h4) x4[q0 + u * nt] = v[u];
      }
    }
  } else {
    for (int i0 = tid; i0 < h; i0 += 4 * nt) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * nt < h) v[u] = __ldg(src + i0 + u * nt);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * nt < h) x[i0 + u * nt] = v[u];
      }
    }
  }
}

// The walk-order key: ascending keys are scores descending, bins ascending.
__device__ __forceinline__ unsigned long long walk_key(float v, int i) {
  float s = score_of(v);
  if (s == 0.f) s = 0.f;  // -0 and +0 tie, as in `before`
  const unsigned u = __float_as_uint(s);
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)(~ordered) << 32) | (unsigned)i;
}

// is_candidate's test with the threshold first, which most bins fail.
__device__ __forceinline__ bool candidate_at(const float* x, int h, int i, float thr) {
  const float v = x[i];
  return v > thr && i >= 1 && i <= h - 2 && v > x[i - 1] && v > x[i + 1];
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// Maxima and minima of the row's 32-bin chunks (NaN never taken).
struct Summaries {
  float* max;
  float* min;
};

// sm.max/sm.min[c] <- the maximum and minimum of x's chunk c, for the whole
// block.  Two neighbouring lanes a chunk, 16 bins each, each lane starting
// at its own bin so that a warp's 32 reads fall on 32 banks.  NaN is never
// taken; a chunk with no number in it gets NaN, which never stops a walk.
// Every lane of a warp runs the same loop, so the shuffles are full.
__device__ __forceinline__ void build_summaries(const float* x, int h, Summaries sm) {
  const int halves = 2 * n_chunks(h);
  for (int w0 = 0; w0 < halves; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    const int c = w >> 1;
    float mx = -INFINITY, mn = INFINITY;
    bool any = false;
    if (w < halves) {
      const int first = c * 32 + (w & 1) * 16;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = first + ((k + c) & 15);
        const float v = i < h ? x[i] : NAN;
        any |= v == v;
        mx = v > mx ? v : mx;
        mn = v < mn ? v : mn;
      }
    }
    const float omx = __shfl_xor_sync(kFull, mx, 1), omn = __shfl_xor_sync(kFull, mn, 1);
    any |= __shfl_xor_sync(kFull, (int)any, 1) != 0;
    if (w < halves && (w & 1) == 0) {
      sm.max[c] = any ? (omx > mx ? omx : mx) : NAN;
      sm.min[c] = any ? (omn < mn ? omn : mn) : NAN;
    }
  }
}

// The nearest index on one side of j where `stop(x[i])` holds, walking
// outward from `from` (j - 1 or j + 1 for blockers, j for width stops); -1
// when there is none.  Lanes fold the samples strictly
// between `from` and that index into `mn`.  The walk takes the rest of the
// chunk holding `from`, then 32 chunk summaries a ballot (`chunk_stop(min,
// max)` holds exactly for a chunk holding a bin where `stop` does; the
// chunks before it fold their minima into `mn`), then the bins of the chunk
// that stops it: about three ballots plus one per 1024 bins, whatever its
// length.  Without summaries (`sm.max` null) it takes every chunk bin by bin.
template <int kDir, bool kMin, typename Stop, typename ChunkStop>
__device__ __forceinline__ int warp_walk(const float* x, int h, int from, Stop stop,
                                         ChunkStop chunk_stop, Summaries sm, float* mn) {
  const int lane = threadIdx.x & 31;
  if (kDir < 0 ? from < 0 : from >= h) return -1;
  // Bins of one chunk from `from` to its far edge, nearest first.
  const auto in_chunk = [&](int c, int start) {
    const int i = start + kDir * lane;
    const bool in = (i >> 5) == c && i >= 0 && i < h;
    const float v = in ? x[i] : 0.f;
    const unsigned hit = __ballot_sync(kFull, in && stop(v));
    const int first = hit ? __ffs(hit) - 1 : 32;
    if (kMin && in && lane < first && v < *mn) *mn = v;
    return hit ? start + kDir * first : -1;
  };
  const int c0 = from >> 5;
  int found = in_chunk(c0, from);
  if (found >= 0) return found;
  const int nc = n_chunks(h);
  if (sm.max == nullptr) {
    for (int c = c0 + kDir; c >= 0 && c < nc; c += kDir) {
      found = in_chunk(c, kDir < 0 ? c * 32 + 31 : c * 32);
      if (found >= 0) return found;
    }
    return -1;
  }
  for (int cb = c0 + kDir; kDir < 0 ? cb >= 0 : cb < nc; cb += 32 * kDir) {
    const int c = cb + kDir * lane;
    const bool in = c >= 0 && c < nc;
    const float cmin = in ? sm.min[c] : 0.f;
    const unsigned hit = __ballot_sync(kFull, in && chunk_stop(cmin, in ? sm.max[c] : 0.f));
    const int first = hit ? __ffs(hit) - 1 : 32;
    if (kMin && in && lane < first && cmin < *mn) *mn = cmin;
    if (hit) {
      const int cs = cb + kDir * first;
      return in_chunk(cs, kDir < 0 ? cs * 32 + 31 : cs * 32);
    }
  }
  return -1;
}

// The prominence and width in bins of the peak (j, peak) on x[0..h),
// computed by one warp: the sets of the masked-reduction scans (nearest
// blockers above the peak, valley minima over the open intervals between
// them and j, width stops at or below the target or above the peak), with
// the same compares and rounded operations, gathered by walking outward
// from j instead of by reductions over the row.  `sm.max` is null when the
// row has no chunk summaries.  j lies in [-1, h]; the bins i < j, i > j,
// i <= j and i >= j are taken within [0, h), so j = -1 and j = h stand for
// any bin before or past the row, and peak may be any value.
__device__ inline void warp_scan_at(const float* x, int h, int j, float peak, Summaries sm,
                                    float* prom_out, int* bins_out) {
  // Nearest blockers (samples above the peak) on each side; the valleys are
  // the minima over the open intervals (blocker, j) and (j, blocker).
  const auto above = [peak](float v) { return v > peak; };
  const auto chunk_above = [peak](float, float cmax) { return cmax > peak; };
  float mn_l = INFINITY, mn_r = INFINITY;
  warp_walk<-1, true>(x, h, j - 1, above, chunk_above, sm, &mn_l);
  warp_walk<1, true>(x, h, j + 1, above, chunk_above, sm, &mn_r);
  mn_l = warp_min(mn_l);
  mn_r = warp_min(mn_r);
  const float min_left = mn_l < peak ? mn_l : peak;
  const float min_right = mn_r < peak ? mn_r : peak;
  const float prom = __fsub_rn(peak, fmaxf(min_left, min_right));
  const float valley = __fsub_rn(peak, prom);
  const float target = __fadd_rn(valley, __fmul_rn(prom, 0.707f));
  // Width stops: the nearest index on each side (j included) at or below
  // the target, or above the peak; 0 and h-1 when there is none.
  const auto outside = [peak, target](float v) { return v <= target || v > peak; };
  const auto chunk_outside = [peak, target](float cmin, float cmax) {
    return cmin <= target || cmax > peak;
  };
  const int st_a = warp_walk<-1, false>(x, h, j, outside, chunk_outside, sm, nullptr);
  const int st_b = warp_walk<1, false>(x, h, j, outside, chunk_outside, sm, nullptr);
  *prom_out = prom;
  *bins_out = max((st_b < 0 ? h - 1 : st_b) - max(st_a, 0), 1);
}

// Compacts the candidates of x[0..h) above `thr` into keys[0..cap) and adds
// their count to *n_listed (shared, zeroed and published by the caller's
// barriers; it may exceed cap, and then the list is incomplete).  A thread
// tests up to 32 bins (i = c*nt + tid) into a bit mask, a warp prefix sum
// places its candidates, and one shared atomic per warp reserves them.
// Every lane of a warp runs the same loops, so the shuffles are full.
__device__ __forceinline__ void compact_candidates(const float* x, int h, float thr,
                                                   unsigned long long* keys, int cap,
                                                   int* n_listed) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int chunks = (h + nt - 1) / nt;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    unsigned mask = 0;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int i = (c0 + c) * nt + tid;
      if (c0 + c < chunks && i < h && candidate_at(x, h, i, thr)) mask |= 1u << c;
    }
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    int base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(n_listed, incl);
    int at = __shfl_sync(kFull, base, 31) + incl - cnt;
    for (; mask; mask &= mask - 1, ++at) {
      const int i = (c0 + __ffs(mask) - 1) * nt + tid;
      if (at < cap) keys[at] = walk_key(x[i], i);
    }
  }
}

// Ranks the complete list keys[0..n): a key's rank is the number of smaller
// keys (counted up to `hi`); the bins of ranks lo..hi-1 go to
// picks[0..hi-lo), in walk order.
__device__ __forceinline__ void rank_picks(const unsigned long long* keys, int n, int lo,
                                           int hi, int* picks) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const unsigned long long key = keys[q];
    int rank = 0;
    int p = 0;
    for (; p + 8 <= n && rank < hi; p += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) rank += keys[p + u] < key ? 1 : 0;
    }
    for (; p < n && rank < hi; ++p) rank += keys[p] < key ? 1 : 0;
    if (rank >= lo && rank < hi) picks[rank - lo] = (int)(key & 0xffffffffu);
  }
}

}  // namespace apda
