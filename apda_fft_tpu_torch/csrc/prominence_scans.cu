// Prominence and -3 dB width of pre-selected candidates, one thread block
// per window, for sm_90a.
//
// Replaces the TPU kernel `prominence_scans_pallas`
// (apda_fft_tpu/ops/detector_pallas.py, body `_scan_kernel`).  For each row
// x[0..H) of a [B, H] float32 magnitude batch, with the row's candidate slots
// cid/cmag [M] and its count n_valid of valid slots (a prefix), it computes
// for every slot i < min(max(n_valid, 0), M) the prominence (peak minus the
// higher flanking valley, each valley bounded by the nearest sample above the
// peak) and the -3 dB width in bins at valley + 0.707*prominence, with the
// peak taken from cmag.  Slots past that are written as prominence 0 /
// width 1.  As in the JAX kernel, cid is only compared with bin indices: it
// may be any int32, inside [0, H) or not, and cmag need not be x[cid].
//
// What bounds it on the card: not bytes (the row is read from device memory
// once) but the latency of each slot's scan.  The select+scan kernel's warp
// walks (walk_common.cuh) do that work here without any block barrier after
// the load: the row goes to shared memory with 16-byte loads, the maxima and
// minima of its 32-bin chunks beside it (one barrier each), then the block's
// warps take the valid slots round-robin and each scans its slot by walking
// outward from cid over the chunk summaries - a few ballots a walk, not H.
// Rows too long for the summaries beside them walk bin by bin.  A row
// longer than shared memory holds (h > kSharedMaxH) takes a second kernel,
// picked on the host: one thread-block cluster of kClusterSize CTAs a row
// (cluster_common.cuh), CTA r holding segment r of the row (in device
// memory past ~437 K bins) and its chunk summaries, the valid slots spread
// over the cluster's warps, each walking the CTAs' bins and summaries over
// distributed shared memory.  A row with no valid slot writes its fill and
// loads nothing.  On the select+scan kernel's picks the results are that
// kernel's bits (the same warp walks).
// Build without fast math.

#include "cluster_common.cuh"

namespace {

using namespace apda;

// Dynamic shared memory a block may use on Hopper (the kernel has no static
// shared memory).
constexpr size_t kSmemCap = 227 * 1024;

// Longest row the kernel keeps in shared memory.
constexpr int kSharedMaxH = (int)(kSmemCap / sizeof(float));

__host__ __device__ __forceinline__ bool has_summaries(int h) {
  return 4LL * h + 8LL * n_chunks(h) <= (long long)kSmemCap;
}

// kThreads threads a block and at most 32 registers a thread: 2048 threads
// an SM, so a [2048, 2048] batch is resident in one wave.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
preselected_scans_kernel(const float* __restrict__ mags, int h, int m,
                         const int* __restrict__ cid, const float* __restrict__ cmag,
                         const int* __restrict__ n_valid, float* __restrict__ prom,
                         int* __restrict__ bins) {
  extern __shared__ __align__(16) float x[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const size_t o = row * (size_t)m;
  const int live = min(max(n_valid[row], 0), m);
  for (int r = live + tid; r < m; r += kThreads) {
    prom[o + r] = 0.f;
    bins[o + r] = 1;
  }
  if (live == 0) return;  // the whole block: no barrier follows
  const bool summed = has_summaries(h);
  const Summaries sm = {summed ? x + h : nullptr, summed ? x + h + n_chunks(h) : nullptr};
  load_row(mags + row * (size_t)h, x, h);
  __syncthreads();
  if (summed) {
    build_summaries(x, h, sm);
    __syncthreads();
  }
  for (int r = warp; r < live; r += kThreads / 32) {
    // A bin before the row gives the sets of bin -1, one past it those of
    // bin h: clamped, and with no j +- 1 overflowing at the ends of int.
    const int j = min(max(cid[o + r], -1), h);
    float pr;
    int bn;
    warp_scan_at(x, h, j, cmag[o + r], sm, &pr, &bn);
    if ((tid & 31) == 0) {
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
  }
}

// Whether a cluster CTA keeps its segment in shared memory beside its
// chunk summaries (h <= 437248), and whether it then also holds the whole
// row's summaries (h <= 309248, and 437249..929792 beside a segment in
// device memory); its own summaries always are.
__host__ __device__ __forceinline__ bool segment_in_smem(int h) {
  const long long seg = segment_bins(h);
  return 8LL * (seg / 32) + 4LL * seg <= (long long)kSmemCap;
}

__host__ __device__ __forceinline__ bool whole_summaries(int h) {
  const long long seg = segment_bins(h);
  return 8LL * kClusterSize * (seg / 32) + (segment_in_smem(h) ? 4LL * seg : 0) <=
         (long long)kSmemCap;
}

// Dynamic shared memory of one CTA of the cluster kernel: the chunk maxima
// and minima (of the whole row, or of its segment), then the segment.
__host__ __device__ __forceinline__ size_t cluster_smem(int h) {
  const size_t seg = segment_bins(h);
  return 8 * (whole_summaries(h) ? kClusterSize : 1) * (seg / 32) +
         (segment_in_smem(h) ? 4 * seg : 0);
}

// A row past kSharedMaxH on one cluster of kClusterSize CTAs
// (blockIdx.x / kClusterSize is the row): each CTA builds its segment's
// summaries, a cluster barrier publishes them, the cluster's warps take the
// valid slots round-robin, and a last barrier keeps every CTA's shared
// memory until no walk may read it.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
preselected_scans_cluster_kernel(const float* __restrict__ mags, int h, int m,
                                 const int* __restrict__ cid, const float* __restrict__ cmag,
                                 const int* __restrict__ n_valid, float* __restrict__ prom,
                                 int* __restrict__ bins) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarps = kThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x / kClusterSize;
  const size_t o = row * (size_t)m;
  const int live = min(max(n_valid[row], 0), m);
  for (int r = live + rank * kThreads + tid; r < m; r += kClusterSize * kThreads) {
    prom[o + r] = 0.f;
    bins[o + r] = 1;
  }
  if (live == 0) return;  // every CTA of the row: no cluster barrier follows
  const int seg = segment_bins(h);
  const int lo = rank * seg;
  const int n = max(0, min(seg, h - lo));
  const float* x = mags + row * (size_t)h;
  const bool whole = whole_summaries(h);
  const int sums = (whole ? kClusterSize : 1) * (seg / 32);
  const int own = whole ? rank * (seg / 32) : 0;  // this CTA's chunks
  float* smax = smem;
  float* smin = smax + sums;
  float* xs = segment_in_smem(h) ? smin + sums : nullptr;
  if (xs != nullptr) {
    load_segment(x + lo, xs, n);
    __syncthreads();
  }
  build_summaries(xs != nullptr ? xs : x + lo, n, Summaries{smax + own, smin + own});
  cluster.sync();
  if (whole) {
    gather_summaries(smax, smin, seg / 32);
    __syncthreads();
  }
  const ClusterRow view = {x, xs, smax, smin, seg, whole};
  for (int r = rank * kWarps + (tid >> 5); r < live; r += kClusterSize * kWarps) {
    const int j = min(max(cid[o + r], -1), h);  // as in the kernel above
    float pr;
    int bn;
    warp_scan_row(view, h, j, cmag[o + r], &pr, &bn);
    if ((tid & 31) == 0) {
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
  }
  cluster.sync();
}

// Shared memory of one block of the shared-memory kernel over rows of h
// bins.
size_t plan(int h) {
  return (size_t)h * sizeof(float) + (has_summaries(h) ? 8 * (size_t)n_chunks(h) : 0);
}

// Dynamic shared memory past 48 KB needs the opt-in, once per kernel and
// device for the largest size asked so far.
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

template <int kThreads>
int launch(const float* mags, int b, int h, int m, const int* cid, const float* cmag,
           const int* n_valid, float* prom, int* bins, int device, cudaStream_t stream) {
  static size_t opted_in[2][64];
  if (h > kSharedMaxH) {
    const size_t smem = cluster_smem(h);
    if (smem > kSmemCap) return (int)cudaErrorInvalidValue;  // past ~7 M bins
    return launch_clusters(preselected_scans_cluster_kernel<kThreads>, b * kClusterSize,
                           kThreads, smem, stream, device, opted_in[1], mags, h, m, cid, cmag,
                           n_valid, prom, bins);
  }
  const size_t smem = plan(h);
  const cudaError_t err = opt_in(preselected_scans_kernel<kThreads>, smem, device, opted_in[0]);
  if (err != cudaSuccess) return (int)err;
  preselected_scans_kernel<kThreads><<<b, kThreads, smem, stream>>>(mags, h, m, cid, cmag,
                                                                    n_valid, prom, bins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of the cluster kernel, for a row past
// kSharedMaxH (the wrapper's message when a cluster cannot be placed).
long long apda_scans_cluster_smem(int h) { return (long long)cluster_smem(h); }

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// with the slots cid/cmag ([b, m] int32/float32) and n_valid ([b] int32) on
// `stream`, in blocks of `threads` (128 or 256); outputs are prom/bins
// [b, m] float32/int32.  Rows past kSharedMaxH take the cluster kernel.
// Returns the cudaError_t of the launch (0 on success), or
// kClusterNotPlaced when not one cluster fits on the device.
int apda_prominence_scans(const float* mags, int b, int h, int m, const int* cid,
                          const float* cmag, const int* n_valid, float* prom, int* bins,
                          int threads, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || m <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == 128) return launch<128>(mags, b, h, m, cid, cmag, n_valid, prom, bins, device, s);
  if (threads == 256) return launch<256>(mags, b, h, m, cid, cmag, n_valid, prom, bins, device, s);
  return (int)cudaErrorInvalidValue;
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
