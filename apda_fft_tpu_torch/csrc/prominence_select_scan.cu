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
// A row longer than shared memory holds (h > kSharedMaxH) takes a second
// kernel, picked on the host: one thread-block cluster of kClusterSize CTAs
// a row (cluster_common.cuh), so that a batch of a few long rows still
// spreads over the card (B=16 makes 128 CTAs on 132 SMs).  CTA r keeps
// segment r of the row in its shared memory (in device memory past ~280 K
// bins) with its chunk summaries; the threshold's two sums are each a
// cluster barrier and a sum of the CTAs' partials over distributed shared
// memory (the long-row order of detector_common.cuh); each CTA compacts and
// ranks its own candidates up to M, the CTAs' winners are ranked against
// each other over distributed shared memory, and the cluster's 32 warps
// walk the picks across the CTAs' segments, on the whole row's chunk
// summaries that each CTA gathers where they fit.  A local list
// that overflows sends the whole cluster to the select-from-the-row route,
// one cluster reduction a round.
// Both routes give the same bits as the plain twin's masked-reduction scans:
// every value is an order, a compare, a min or max, or their explicitly
// rounded arithmetic.  The steps' device code is walk_common.cuh's, shared
// with the scans-only kernel (B5) and the flexible single-window kernel
// (B2).  Build without fast math.

#include "cluster_common.cuh"

namespace {

using namespace apda;

// Threads of a block: 128, so that a [2048, 2048] batch is resident on the
// card in one wave (16 blocks an SM; 256 threads were slower).
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
// Dynamic shared memory a block may use on Hopper, less 1 KB for the
// kernel's static scratch.
constexpr size_t kSmemCap = 227 * 1024 - 1024;

// Longest row the kernel keeps in shared memory.
constexpr int kSharedMaxH = (int)(kSmemCap / sizeof(float));

// Whether the row's chunk maxima and minima fit in shared memory beside it
// (every h but the last ~3 K below the cap).
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
  const size_t row = blockIdx.x;
  const float* src = mags + row * (size_t)h;
  load_row(src, x, h);
  if (tid == 0) n_listed = 0;
  __syncthreads();
  if (summed) build_summaries(x, h, sm);  // read after noise_threshold's barriers

  // Threshold: mean + 2*std, ddof=1.
  float sd;
  const float thr = noise_threshold(x, h, sc, &sd);

  // Compact the candidates into the list; the count is n_cand.
  compact_candidates(x, h, thr, keys, cap, &n_listed);
  __syncthreads();
  const int n_cand = n_listed;
  const int live = min(n_cand, m);
  const size_t o = row * (size_t)m;

  if (n_cand <= cap) {
    // Rank = the number of smaller keys; ranks below `live` are the picks.
    rank_picks(keys, n_cand, 0, live, picks);
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

// scan_pick and scan_fill on a row spread over the cluster.
__device__ __forceinline__ void cluster_scan_pick(const ClusterRow& row, int h, int j, size_t o,
                                                  int r, Out out) {
  const float peak = row.bin(j);
  float pr;
  int bn;
  warp_scan_row(row, h, j, peak, &pr, &bn);
  if ((threadIdx.x & 31) == 0) {
    out.cid[o + r] = j;
    out.is_cand[o + r] = 1;
    out.cmag[o + r] = peak;
    out.prom[o + r] = pr;
    out.bins[o + r] = bn;
  }
}

__device__ __forceinline__ void cluster_scan_fill(const ClusterRow& row, int h, size_t o,
                                                  int live, int m, Out out) {
  const float x0 = row.bin(0);
  float pr;
  int bn;
  warp_scan_row(row, h, 0, x0, &pr, &bn);
  for (int r = live + (threadIdx.x & 31); r < m; r += 32) {
    out.cid[o + r] = 0;
    out.is_cand[o + r] = 0;
    out.cmag[o + r] = x0;
    out.prom[o + r] = pr;
    out.bins[o + r] = bn;
  }
}

// Warps of a cluster; pick g goes to cluster warp g % kClusterWarps.
constexpr int kClusterWarps = kClusterSize * kMaxWarps;
// Pick slots a CTA keeps at most: its warps' share of the picks of a row
// whose candidates all fit the CTAs' lists.
constexpr int kPickSlotsMax = kClusterSize * kMaxList / kClusterWarps * kMaxWarps;

// Shared memory of one CTA of the cluster kernel at (h, m), in this order:
// its candidate list (kMaxList keys), its ranked winners (up to m keys),
// the chunk maxima and minima (of the whole row while they fit, else of its
// segment), its pick slots, then, while it fits, its segment with a
// neighbour bin on each side.  Each "fits" is judged beside the most the
// rest can take (m of any size), so it depends on h alone: the segment
// first (h <= 280576), then the whole row's summaries (h <= 198656, and
// 280577..598016 beside a segment in device memory).
struct ClusterPlan {
  int seg;          // bins of a segment
  int win_cap;      // winner keys (even)
  int sums;         // entries of the maxima (and of the minima)
  int pick_cap;     // pick slots (a multiple of 4)
  bool seg_smem;    // the segment in shared memory
  bool whole_sums;  // the whole row's summaries in every CTA
  size_t smem;      // bytes
};

constexpr long long kFixedMax = 8LL * kMaxList + 8LL * kMaxList + 4LL * kPickSlotsMax;

__host__ __device__ __forceinline__ bool segment_in_smem(int h) {
  const long long seg = segment_bins(h);
  return kFixedMax + 8LL * (seg / 32) + 4LL * (seg + 8) <= (long long)kSmemCap;
}

__host__ __device__ __forceinline__ bool whole_summaries(int h) {
  const long long seg = segment_bins(h);
  return kFixedMax + 8LL * kClusterSize * (seg / 32) +
             (segment_in_smem(h) ? 4LL * (seg + 8) : 0) <= (long long)kSmemCap;
}

__host__ __device__ __forceinline__ ClusterPlan cluster_plan(int h, int m) {
  ClusterPlan p;
  p.seg = segment_bins(h);
  const int wins = m < kMaxList ? m : kMaxList;
  p.win_cap = (wins + 1) & ~1;
  const int picks = m < kClusterSize * kMaxList ? m : kClusterSize * kMaxList;
  p.pick_cap = (picks + kClusterWarps - 1) / kClusterWarps * kMaxWarps;
  p.seg_smem = segment_in_smem(h);
  p.whole_sums = whole_summaries(h);
  p.sums = (p.whole_sums ? kClusterSize : 1) * (p.seg / 32);
  p.smem = 8 * (size_t)kMaxList + 8 * (size_t)p.win_cap + 8 * (size_t)p.sums +
           4 * (size_t)p.pick_cap + (p.seg_smem ? 4 * ((size_t)p.seg + 8) : 0);
  return p;
}

// A row past kSharedMaxH on one cluster of kClusterSize CTAs of 128
// threads (blockIdx.x / kClusterSize is the row): the steps of the kernel
// above, each CTA on its segment, joined by six cluster barriers - the
// threshold's two sums, the candidate counts, the ranked winners, the
// picks' slots, and the exit, so that no CTA leaves while another may read
// its shared memory.
__global__ void __launch_bounds__(kMaxThreads)
select_scan_cluster_kernel(const float* __restrict__ mags, int h, int m, Out out,
                           float* __restrict__ std_out, int* __restrict__ ncand_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch<kMaxWarps> sc;
  __shared__ int n_listed;
  __shared__ int counts[kClusterSize];
  __shared__ float part[2];
  __shared__ Pick best_of[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gw = rank * kMaxWarps + warp;  // the warp's place in the cluster
  const size_t row = blockIdx.x / kClusterSize;
  const ClusterPlan p = cluster_plan(h, m);
  const int lo = rank * p.seg;
  const int n = max(0, min(p.seg, h - lo));
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* win = keys + kMaxList;
  float* smax = reinterpret_cast<float*>(win + p.win_cap);
  float* smin = smax + p.sums;
  int* picks = reinterpret_cast<int*>(smin + p.sums);
  const int own = p.whole_sums ? rank * (p.seg / 32) : 0;  // this CTA's chunks
  float* xs = p.seg_smem ? reinterpret_cast<float*>(picks + p.pick_cap) + 4 : nullptr;
  const float* x = mags + row * (size_t)h;
  // The segment with its neighbour bins at s[-1] and s[n] (where they exist).
  const float* s = xs != nullptr ? xs : x + lo;
  if (xs != nullptr) {
    load_segment(x + lo, xs, n);
    if (tid == 0) {
      xs[-1] = lo > 0 ? x[lo - 1] : 0.f;
      xs[n] = lo + n < h ? x[lo + n] : 0.f;
    }
  }
  if (tid == 0) n_listed = 0;
  __syncthreads();
  // Read after the cluster barriers; gathered after the first.
  build_summaries(s, n, Summaries{smax + own, smin + own});
  const ClusterRow view = {x, xs, smax, smin, p.seg, p.whole_sums};

  // Threshold: mean + 2*std, ddof=1, in the long-row order
  // (detector_common.cuh): Kahan lanes over whole strides, the block tree,
  // then the CTAs' partials in rank order.
  const int strides = p.seg / kMaxThreads;
  const auto cluster_sum = [&](float mean, bool squares, float* slot) {
    float acc = 0.f, c = 0.f;
    for (int k = 0; k < strides; ++k) {
      const int li = k * kMaxThreads + tid;
      float v = 0.f;
      if (li < n) {
        v = s[li];
        if (squares) {
          const float d = __fsub_rn(v, mean);
          v = __fmul_rn(d, d);
        }
      }
      const float y = __fsub_rn(v, c);
      const float t = __fadd_rn(acc, y);
      c = __fsub_rn(__fsub_rn(t, acc), y);
      acc = t;
    }
    acc = block_reduce(acc, SumF(), sc.f);
    if (tid == 0) *slot = acc;
    cluster.sync();
    float total = *cluster.map_shared_rank(slot, 0);
    for (int r = 1; r < kClusterSize; ++r) {
      total = __fadd_rn(total, *cluster.map_shared_rank(slot, r));
    }
    return total;
  };
  const float mean = __fdiv_rn(cluster_sum(0.f, false, &part[0]), (float)h);
  if (p.whole_sums) gather_summaries(smax, smin, p.seg / 32);  // read after later barriers
  const float var = cluster_sum(mean, true, &part[1]);
  const float sd = __fsqrt_rn(__fdiv_rn(var, (float)(h - 1)));
  const float thr = __fadd_rn(mean, __fmul_rn(2.0f, sd));

  // Each CTA compacts its segment's candidates; the counts add up to n_cand.
  compact_segment(s, lo, n, h, thr, keys, kMaxList, &n_listed);
  cluster.sync();
  if (tid < kClusterSize) counts[tid] = *cluster.map_shared_rank(&n_listed, tid);
  __syncthreads();
  int n_cand = 0;
  bool overflow = false;
  for (int r = 0; r < kClusterSize; ++r) {
    n_cand += counts[r];
    overflow |= counts[r] > kMaxList;
  }
  const int live = min(n_cand, m);
  const size_t o = row * (size_t)m;

  if (!overflow) {
    // Each CTA ranks its own list up to m: its winners, in walk order.
    const int nw = min(n_listed, m);
    rank_keys(keys, n_listed, 0, nw, [win](int r, unsigned long long key) { win[r] = key; });
    // A winner's rank in the row is the number of smaller winners of all
    // CTAs (exact below m: a CTA's keys below it are all its winners): its
    // own index, plus a binary search of each other CTA's winners, one
    // thread a (winner, CTA) pair, added up in the spent list's room.
    cluster.sync();  // the winners are published, the list is spent
    int* grank = reinterpret_cast<int*>(keys);
    for (int q = tid; q < nw; q += kMaxThreads) grank[q] = q;
    __syncthreads();
    for (int t = tid; t < nw * kClusterSize; t += kMaxThreads) {
      const int q = t / kClusterSize, r = t % kClusterSize;
      if (r == rank) continue;
      const unsigned long long key = win[q];
      const unsigned long long* w = cluster.map_shared_rank(win, r);
      int a = 0, b = min(counts[r], m);  // w[0..b) ascending: count those below key
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (w[mid] < key) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      if (a > 0) atomicAdd(&grank[q], a);
    }
    __syncthreads();
    // The picks go to the pick slots of the CTA whose warp scans them.
    for (int q = tid; q < nw; q += kMaxThreads) {
      const int g = grank[q];
      if (g < live) {
        const int cw = g % kClusterWarps;
        int* slots = cluster.map_shared_rank(picks, cw / kMaxWarps);
        slots[g / kClusterWarps * kMaxWarps + cw % kMaxWarps] = (int)(win[q] & 0xffffffffu);
      }
    }
    cluster.sync();
    for (int g = gw; g < live; g += kClusterWarps) {
      cluster_scan_pick(view, h, picks[g / kClusterWarps * kMaxWarps + warp], o, g, out);
    }
  } else {
    // A list overflowed: select from the row, one cluster reduction a round
    // (round r takes the candidate after round r-1's pick in walk order),
    // and scan each pick on a warp in turn.
    Pick prev = {0.f, -1};
    for (int r = 0; r < live; ++r) {
      Pick best = {-INFINITY, h};  // loses to every candidate
      for (int li = tid; li < n; li += kMaxThreads) {
        const float v = s[li];
        const int g = lo + li;
        if (!(v > thr && g >= 1 && g <= h - 2 && v > s[li - 1] && v > s[li + 1])) continue;
        const Pick q = {score_of(v), g};
        if ((r == 0 || before(prev, q)) && before(q, best)) best = q;
      }
      best = block_reduce(best, First(), sc.p);
      if (tid == 0) best_of[r & 1] = best;
      // Round r+1 writes the other slot; round r+2 writes this one after
      // the next barrier, which every CTA reaches having read it.
      cluster.sync();
      best = *cluster.map_shared_rank(&best_of[r & 1], 0);
      for (int q = 1; q < kClusterSize; ++q) {
        best = First()(best, *cluster.map_shared_rank(&best_of[r & 1], q));
      }
      if (gw == r % kClusterWarps) cluster_scan_pick(view, h, best.i, o, r, out);
      prev = best;
    }
  }
  if (live < m && gw == live % kClusterWarps) cluster_scan_fill(view, h, o, live, m, out);
  if (rank == 0 && tid == 0) {
    std_out[row] = sd;
    ncand_out[row] = n_cand;
  }
  cluster.sync();
}

// Shared memory of one block of the shared-memory kernel over rows of h
// bins at budget m.
size_t plan(int h, int m) {
  const int cap = list_cap(h);
  return (size_t)cap * 8 + (size_t)h * sizeof(float) +
         (has_summaries(h) ? (size_t)8 * n_chunks(h) : 0) + (size_t)min(cap, m) * 4;
}

// Dynamic shared memory past 48 KB needs the opt-in, once per kernel and
// device for the largest size asked so far (opted_in[device]).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, int device, size_t* opted_in) {
  if (smem > 48 * 1024 && (device < 0 || device >= 64 || smem > opted_in[device])) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) opted_in[device] = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of the cluster kernel at (h, m), for a
// row past kSharedMaxH (the wrapper's message when a cluster cannot be
// placed).
long long apda_select_scan_cluster_smem(int h, int m) {
  return (long long)cluster_plan(h, m).smem;
}

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// on `stream`; outputs are [b, m] slots and [b] per-row values.  Rows past
// kSharedMaxH take the cluster kernel.  Returns the cudaError_t of the
// launch (0 on success), or kClusterNotPlaced when not one cluster fits on
// the device.
int apda_prominence_select_scan(const float* mags, int b, int h, int m, int* cid,
                                unsigned char* is_cand, float* cmag, float* prom,
                                int* bins, float* std_out, int* ncand_out,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  const Out out = {cid, is_cand, cmag, prom, bins};
  const cudaStream_t s = (cudaStream_t)stream;
  static size_t opted_in[2][64];
  if (h > kSharedMaxH) {
    const ClusterPlan p = cluster_plan(h, m);
    if (p.smem > kSmemCap) return (int)cudaErrorInvalidValue;  // past ~4.7 M bins
    return launch_clusters(select_scan_cluster_kernel, b * kClusterSize, kMaxThreads, p.smem,
                           s, device, opted_in[1], mags, h, m, out, std_out, ncand_out);
  }
  const size_t smem = plan(h, m);
  int threads = h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  err = opt_in(select_scan_kernel, smem, device, opted_in[0]);
  if (err != cudaSuccess) return (int)err;
  select_scan_kernel<<<b, threads, smem, s>>>(mags, h, m, out, std_out, ncand_out);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
