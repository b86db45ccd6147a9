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
// once) but barriers, the latency of the chains between them and, once
// those are few, the instructions of the fixed per-row stages.  The design
// keeps the barriers to a handful per row, whatever M is:
//   1. the row goes to shared memory with 16-byte loads, and beside it the
//      maximum and minimum of each 32-bin chunk; the threshold is
//      `noise_threshold` (two block sums, whose order decides which bins
//      are candidates);
//   2. one pass compacts the candidates into a shared list of 64-bit keys,
//      (~ordered score bits) << 32 | bin, whose ascending order is the walk
//      order: a bit mask per thread, a warp prefix sum and one shared atomic
//      per warp place them, and the list's length is n_cand;
//   3. each candidate's rank is the number of smaller keys in the list
//      (stopping at M); ranks below M are the picks, in order;
//   4. warps take the picks (and the exhausted fill) round-robin and scan
//      each without a block barrier: ballots walk outward from the peak,
//      over the rest of its chunk, then 32 chunk summaries a ballot, then
//      the bins of the chunk that stops the walk, to the nearest blocker on
//      each side while lanes keep the valley minima; a second walk finds
//      the width stops.  A walk costs a few ballots, not H.
// 128 threads and 32 registers a thread put a [2048, 2048] batch on the card
// in one wave.  What remains at B=2048, H=2048 is mostly the fixed per-row
// work - the row load (all rows at once), the threshold's two block sums,
// the compaction (an IEEE division per candidate key): at M=2 the kernel
// takes about three quarters of its time at M=12.
// Where the list outgrows its room (more than kMaxList keys, or what shared
// memory holds beside a long row) the picks come straight from the row, one
// block reduction per round in walk order, and are scanned the same way.
// Both routes give the same bits as the block-wide `scan_at`: every value is
// an order, a compare, a min or max, or scan_at's explicitly rounded
// arithmetic.  Build without fast math.

#include "detector_common.cuh"

namespace {

using namespace apda;

// Threads of a block: 128, so that a [2048, 2048] batch is resident on the
// card in one wave (16 blocks an SM; 256 threads were slower).
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Keys the shared candidate list holds at most.  A row has at most h/5
// samples at or above mean + 2*std (Cantelli's inequality), so h/4 + 2 keys
// hold every candidate of any row up to this cap.
constexpr int kMaxList = 4096;
// Dynamic shared memory a block may use on Hopper, less 1 KB for the
// kernel's static scratch.
constexpr size_t kSmemCap = 227 * 1024 - 1024;

// The row's 32-bin chunks, and whether their maxima and minima fit in
// shared memory beside the row (every h but the last ~3 K below the cap).
__host__ __device__ __forceinline__ int n_chunks(int h) { return (h + 31) / 32; }
__host__ __device__ __forceinline__ bool has_summaries(int h) {
  return 4LL * h + 8LL * n_chunks(h) <= (long long)kSmemCap;
}

// Length of the candidate list beside a row of h floats and its summaries
// (even, so that what follows stays 16-byte aligned): each entry is a key
// and at most one pick slot (12 bytes).
__host__ __device__ __forceinline__ int list_cap(int h) {
  const long long used = 4LL * h + (has_summaries(h) ? 8LL * n_chunks(h) : 0);
  const long long room = ((long long)kSmemCap - used) / 12;
  long long cap = h / 4 + 2;
  if (cap > kMaxList) cap = kMaxList;
  if (cap > room) cap = room;
  return cap > 0 ? (int)(cap & ~1LL) : 0;
}

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

// The nearest index on one side of j where `stop(x[i])` holds, walking
// outward from `from` (j - 1 or j + 1 for blockers, j for width stops); -1
// when there is none.  Lanes fold the samples strictly between `from` and
// that index into `mn`.  The walk takes the rest of the chunk holding
// `from`, then 32 chunk summaries a ballot (`chunk_stop(min, max)` holds
// exactly for a chunk holding a bin where `stop` does; the chunks before it
// fold their minima into `mn`), then the bins of the chunk that stops it:
// about three ballots plus one per 1024 bins, whatever its length.  Without
// summaries (`sm.max` null) it takes every chunk bin by bin.
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

// scan_at's prominence and width of the peak (j, peak) on x[0..h), computed
// by one warp: the same sets, compares and rounded operations, gathered by
// walking outward from j instead of by block reductions.  `sm.max` is null
// when the row has no chunk summaries.
__device__ void warp_scan_at(const float* x, int h, int j, float peak, Summaries sm,
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

struct Out {
  int* cid;
  unsigned char* is_cand;
  float* cmag;
  float* prom;
  int* bins;
};

// Slot r of the row's outputs (from offset o) holds the pick j; one warp.
__device__ __forceinline__ void scan_pick(const float* x, int h, Summaries sm, int j,
                                          size_t o, int r, Out out) {
  float pr;
  int bn;
  warp_scan_at(x, h, j, x[j], sm, &pr, &bn);
  if ((threadIdx.x & 31) == 0) {
    out.cid[o + r] = j;
    out.is_cand[o + r] = 1;
    out.cmag[o + r] = x[j];
    out.prom[o + r] = pr;
    out.bins[o + r] = bn;
  }
}

// Slots live..m-1: the exhausted fill; one warp.
__device__ __forceinline__ void scan_fill(const float* x, int h, Summaries sm, size_t o,
                                          int live, int m, Out out) {
  float pr;
  int bn;
  warp_scan_at(x, h, 0, x[0], sm, &pr, &bn);
  for (int r = live + (threadIdx.x & 31); r < m; r += 32) {
    out.cid[o + r] = 0;
    out.is_cand[o + r] = 0;
    out.cmag[o + r] = x[0];
    out.prom[o + r] = pr;
    out.bins[o + r] = bn;
  }
}

// At most 32 registers a thread, so that 16 blocks of 128 threads fit an SM.
__global__ void __launch_bounds__(kMaxThreads, 2048 / kMaxThreads)
select_scan_kernel(const float* __restrict__ mags, int h, int m, Out out,
                   float* __restrict__ std_out, int* __restrict__ ncand_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch<kMaxWarps> sc;
  __shared__ int n_listed;
  const int cap = list_cap(h);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* x = reinterpret_cast<float*>(keys + cap);
  const bool summed = has_summaries(h);
  const Summaries sm = {summed ? x + h : nullptr, summed ? x + h + n_chunks(h) : nullptr};
  int* picks = reinterpret_cast<int*>(x + h + (summed ? 2 * n_chunks(h) : 0));
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int lane = tid & 31;
  const size_t row = blockIdx.x;
  const float* src = mags + row * (size_t)h;
  load_row(src, x, h);
  if (tid == 0) n_listed = 0;
  __syncthreads();
  if (summed) {  // read after noise_threshold's barriers
    // Two neighbouring lanes a chunk, 16 bins each, each lane starting at
    // its own bin so that a warp's 32 reads fall on 32 banks.  NaN is never
    // taken; a chunk with no number in it gets NaN, which never stops a walk.
    const int halves = 2 * n_chunks(h);
    for (int w0 = 0; w0 < halves; w0 += nt) {
      const int w = w0 + tid;
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

  // Threshold: mean + 2*std, ddof=1.
  float sd;
  const float thr = noise_threshold(x, h, sc, &sd);

  // Compact the candidates into the list; the count is n_cand.  A thread
  // tests up to 32 bins (i = c*nt + tid) into a bit mask, a warp prefix sum
  // places its candidates, and one shared atomic per warp reserves them.
  // Every lane of a warp runs the same loops, so the shuffles are full.
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
    if (lane == 31 && incl > 0) base = atomicAdd(&n_listed, incl);
    int at = __shfl_sync(kFull, base, 31) + incl - cnt;
    for (; mask; mask &= mask - 1, ++at) {
      const int i = (c0 + __ffs(mask) - 1) * nt + tid;
      if (at < cap) keys[at] = walk_key(x[i], i);
    }
  }
  __syncthreads();
  const int n_cand = n_listed;
  const int live = min(n_cand, m);
  const size_t o = row * (size_t)m;

  if (n_cand <= cap) {
    // Rank = the number of smaller keys; ranks below `live` are the picks.
    for (int q = tid; q < n_cand; q += nt) {
      const unsigned long long key = keys[q];
      int rank = 0;
      int p = 0;
      for (; p + 8 <= n_cand && rank < live; p += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) rank += keys[p + u] < key ? 1 : 0;
      }
      for (; p < n_cand && rank < live; ++p) rank += keys[p] < key ? 1 : 0;
      if (rank < live) picks[rank] = (int)(key & 0xffffffffu);
    }
    __syncthreads();
    for (int r = warp; r < live; r += nwarps) scan_pick(x, h, sm, picks[r], o, r, out);
  } else {
    // The list overflowed: select from the row, one block reduction a round
    // (round s takes the candidate after round s-1's pick in walk order),
    // and scan each pick on a warp in turn.
    auto candidate = [&](int i) { return is_candidate(x, h, i, thr); };
    Pick prev = {0.f, -1};
    for (int r = 0; r < live; ++r) {
      Pick best = {-INFINITY, h};  // loses to every candidate
      for (int i = tid; i < h; i += nt) {
        if (!candidate(i)) continue;
        const Pick p = {score_of(x[i]), i};
        if ((r == 0 || before(prev, p)) && before(p, best)) best = p;
      }
      best = block_reduce(best, First(), sc.p);
      if (warp == r % nwarps) scan_pick(x, h, sm, best.i, o, r, out);
      prev = best;
    }
  }
  if (live < m && warp == live % nwarps) scan_fill(x, h, sm, o, live, m, out);
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
  if ((size_t)h * sizeof(float) > kSmemCap) return (int)cudaErrorInvalidValue;
  int threads = h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  const int cap = list_cap(h);
  const size_t smem = (size_t)cap * 8 + (size_t)h * sizeof(float) +
                      (has_summaries(h) ? (size_t)8 * n_chunks(h) : 0) + (size_t)min(cap, m) * 4;
  // Dynamic shared memory past 48 KB needs the opt-in, once per device
  // for the largest size asked so far.
  static size_t opted_in[64];
  if (smem > 48 * 1024 && (device < 0 || device >= 64 || smem > opted_in[device])) {
    err = cudaFuncSetAttribute(select_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) opted_in[device] = smem;
  }
  const Out out = {cid, is_cand, cmag, prom, bins};
  select_scan_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(mags, h, m, out, std_out,
                                                                  ncand_out);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
