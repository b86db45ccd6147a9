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
// kernel, picked on the host, with the same steps: the row stays in device
// memory and is read through the caches, the candidate list with its pick
// slots and the chunk summaries stay in shared memory (at h = 65536: 48 KB
// and 16 KB), and the summaries go to a global workspace the wrapper
// allocates once they no longer fit beside the list (h > ~729 K).  The
// threshold's sums are compensated there: a thread's share is hundreds of
// bins.  The shared-memory kernel's code is the one it had before.
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

// A row past kSharedMaxH: its candidate list (the most keys a list holds)
// with one pick slot each, then its chunk summaries while they fit beside
// it; else the summaries take 2*n_chunks(h) floats of workspace a row.
__host__ __device__ __forceinline__ bool long_summaries_in_smem(int h) {
  return 12LL * kMaxList + 8LL * n_chunks(h) <= (long long)kSmemCap;
}

// noise_threshold for a long row: the same two passes, each thread's share
// summed with compensation (Kahan).  A thread's share of a long row is
// hundreds of bins, and a plain running sum that has taken a tall peak
// loses the small bins after it: 1e-5 of the std on a two-tone row of
// h = 65536, where the reference sums pairwise.
template <typename S>
__device__ float noise_threshold_long(const float* x, int h, S& sc, float* sd_out) {
  float s = 0.f, c = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float y = __fsub_rn(x[i], c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
  s = block_reduce(s, SumF(), sc.f);
  const float mean = __fdiv_rn(s, (float)h);
  float v = 0.f;
  c = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float d = __fsub_rn(x[i], mean);
    const float y = __fsub_rn(__fmul_rn(d, d), c);
    const float t = __fadd_rn(v, y);
    c = __fsub_rn(__fsub_rn(t, v), y);
    v = t;
  }
  v = block_reduce(v, SumF(), sc.f);
  const float sd = __fsqrt_rn(__fdiv_rn(v, (float)(h - 1)));
  *sd_out = sd;
  return __fadd_rn(mean, __fmul_rn(2.0f, sd));
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

// The kernel's steps for a row past kSharedMaxH, kept out of the kernel
// above so that its compiled code stays as it was: the row x is read from
// device memory, the list and pick slots come first in shared memory, then
// the chunk summaries while they fit (else `ws` holds them, 2*n_chunks(h)
// floats a row), and the threshold's sums are compensated.
__global__ void __launch_bounds__(kMaxThreads, 2048 / kMaxThreads)
select_scan_long_kernel(const float* __restrict__ mags, int h, int m, Out out,
                        float* __restrict__ std_out, int* __restrict__ ncand_out, float* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch<kMaxWarps> sc;
  __shared__ int n_listed;
  const int cap = kMaxList;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t row = blockIdx.x;
  const float* x = mags + row * (size_t)h;
  const bool in_smem = long_summaries_in_smem(h);
  float* sums = in_smem ? reinterpret_cast<float*>(keys + cap) : ws + row * 2 * (size_t)n_chunks(h);
  const Summaries sm = {sums, sums + n_chunks(h)};
  int* picks = reinterpret_cast<int*>(keys + cap) + (in_smem ? 2 * n_chunks(h) : 0);
  if (tid == 0) n_listed = 0;
  build_summaries(x, h, sm);  // read after the threshold's barriers
  float sd;
  const float thr = noise_threshold_long(x, h, sc, &sd);
  compact_candidates(x, h, thr, keys, cap, &n_listed);
  __syncthreads();
  const int n_cand = n_listed;
  const int live = min(n_cand, m);
  const size_t o = row * (size_t)m;
  if (n_cand <= cap) {
    rank_picks(keys, n_cand, 0, live, picks);
    __syncthreads();
    for (int r = warp; r < live; r += nwarps) scan_pick(x, h, sm, picks[r], o, r, out);
  } else {
    Pick prev = {0.f, -1};
    for (int r = 0; r < live; ++r) {
      Pick best = {-INFINITY, h};  // loses to every candidate
      for (int i = tid; i < h; i += nt) {
        if (!is_candidate(x, h, i, thr)) continue;
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

// Shared memory of one block and floats of global workspace of one launch
// over b rows of h bins at budget m.
struct Plan {
  size_t smem;
  size_t ws_floats;
};

Plan plan(int b, int h, int m) {
  if (h > kSharedMaxH) {
    const bool in_smem = long_summaries_in_smem(h);
    const size_t sums = 8 * (size_t)n_chunks(h);
    return {(size_t)kMaxList * 8 + (in_smem ? sums : 0) + (size_t)min(kMaxList, m) * 4,
            in_smem ? 0 : (size_t)b * sums / 4};
  }
  const int cap = list_cap(h);
  return {(size_t)cap * 8 + (size_t)h * sizeof(float) +
              (has_summaries(h) ? (size_t)8 * n_chunks(h) : 0) + (size_t)min(cap, m) * 4,
          0};
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

// Floats of global workspace a launch over b rows of h bins needs (0 when
// everything fits in shared memory).
long long apda_select_scan_workspace_floats(int b, int h) {
  return (long long)plan(b, h, 1).ws_floats;
}

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// on `stream`; outputs are [b, m] slots and [b] per-row values.  `ws` holds
// apda_select_scan_workspace_floats(b, h) floats (may be null when that is
// 0).  Returns the cudaError_t of the launch (0 on success).
int apda_prominence_select_scan(const float* mags, int b, int h, int m, int* cid,
                                unsigned char* is_cand, float* cmag, float* prom,
                                int* bins, float* std_out, int* ncand_out, float* ws,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  const Plan p = plan(b, h, m);
  if (p.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Out out = {cid, is_cand, cmag, prom, bins};
  const cudaStream_t s = (cudaStream_t)stream;
  int threads = h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  static size_t opted_in[2][64];
  if (h > kSharedMaxH) {
    err = opt_in(select_scan_long_kernel, p.smem, device, opted_in[1]);
    if (err != cudaSuccess) return (int)err;
    select_scan_long_kernel<<<b, threads, p.smem, s>>>(mags, h, m, out, std_out, ncand_out, ws);
  } else {
    err = opt_in(select_scan_kernel, p.smem, device, opted_in[0]);
    if (err != cudaSuccess) return (int)err;
    select_scan_kernel<<<b, threads, p.smem, s>>>(mags, h, m, out, std_out, ncand_out);
  }
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
