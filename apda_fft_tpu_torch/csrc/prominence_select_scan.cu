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
// Both routes give the same bits as the plain twin's masked-reduction scans:
// every value is an order, a compare, a min or max, or their explicitly
// rounded arithmetic.  The steps' device code is walk_common.cuh's, shared
// with the scans-only kernel (B5) and the flexible single-window kernel
// (B2).  Build without fast math.

#include "walk_common.cuh"

namespace {

using namespace apda;

// Threads of a block: 128, so that a [2048, 2048] batch is resident on the
// card in one wave (16 blocks an SM; 256 threads were slower).
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
// Dynamic shared memory a block may use on Hopper, less 1 KB for the
// kernel's static scratch.
constexpr size_t kSmemCap = 227 * 1024 - 1024;

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
