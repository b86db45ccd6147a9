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
// picked on the host: the row stays in device memory, read through the
// caches, and its summaries go to shared memory (to a global workspace the
// wrapper allocates past ~930 K bins).  A row with no valid slot writes its
// fill and loads nothing.  On the select+scan kernel's
// picks the results are that kernel's bits (the same warp_scan_at).
// Build without fast math.

#include "walk_common.cuh"

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

// A row past kSharedMaxH: whether its chunk summaries fit in shared memory.
__host__ __device__ __forceinline__ bool long_summaries_in_smem(int h) {
  return 8LL * n_chunks(h) <= (long long)kSmemCap;
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

// The kernel's steps for a row past kSharedMaxH, kept out of the kernel
// above so that its compiled code stays as it was: the row is read from
// device memory, its chunk summaries go to shared memory while they fit,
// else to `ws` (2*n_chunks(h) floats a row).
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
preselected_scans_long_kernel(const float* __restrict__ mags, int h, int m,
                              const int* __restrict__ cid, const float* __restrict__ cmag,
                              const int* __restrict__ n_valid, float* __restrict__ prom,
                              int* __restrict__ bins, float* ws) {
  extern __shared__ __align__(16) float smem[];
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
  const float* x = mags + row * (size_t)h;
  float* sums = long_summaries_in_smem(h) ? smem : ws + row * 2 * (size_t)n_chunks(h);
  const Summaries sm = {sums, sums + n_chunks(h)};
  build_summaries(x, h, sm);
  __syncthreads();
  for (int r = warp; r < live; r += kThreads / 32) {
    const int j = min(max(cid[o + r], -1), h);  // as in the kernel above
    float pr;
    int bn;
    warp_scan_at(x, h, j, cmag[o + r], sm, &pr, &bn);
    if ((tid & 31) == 0) {
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
  }
}

// Shared memory of one block and floats of global workspace of one launch
// over b rows of h bins.
struct Plan {
  size_t smem;
  size_t ws_floats;
};

Plan plan(int b, int h) {
  const size_t sums = 8 * (size_t)n_chunks(h);
  if (h > kSharedMaxH) {
    return long_summaries_in_smem(h) ? Plan{sums, 0} : Plan{0, (size_t)b * sums / 4};
  }
  return {(size_t)h * sizeof(float) + (has_summaries(h) ? sums : 0), 0};
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
cudaError_t launch(const float* mags, int b, int h, int m, const int* cid, const float* cmag,
                   const int* n_valid, float* prom, int* bins, float* ws, int device,
                   cudaStream_t stream) {
  const Plan p = plan(b, h);
  static size_t opted_in[2][64];
  cudaError_t err;
  if (h > kSharedMaxH) {
    err = opt_in(preselected_scans_long_kernel<kThreads>, p.smem, device, opted_in[1]);
    if (err != cudaSuccess) return err;
    preselected_scans_long_kernel<kThreads><<<b, kThreads, p.smem, stream>>>(
        mags, h, m, cid, cmag, n_valid, prom, bins, ws);
  } else {
    err = opt_in(preselected_scans_kernel<kThreads>, p.smem, device, opted_in[0]);
    if (err != cudaSuccess) return err;
    preselected_scans_kernel<kThreads><<<b, kThreads, p.smem, stream>>>(mags, h, m, cid, cmag,
                                                                        n_valid, prom, bins);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of global workspace a launch over b rows of h bins needs (0 when
// everything fits in shared memory).
long long apda_scans_workspace_floats(int b, int h) { return (long long)plan(b, h).ws_floats; }

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// with the slots cid/cmag ([b, m] int32/float32) and n_valid ([b] int32) on
// `stream`, in blocks of `threads` (128 or 256); outputs are prom/bins
// [b, m] float32/int32.  `ws` holds apda_scans_workspace_floats(b, h)
// floats (may be null when that is 0).  Returns the cudaError_t of the
// launch (0 on success).
int apda_prominence_scans(const float* mags, int b, int h, int m, const int* cid,
                          const float* cmag, const int* n_valid, float* prom, int* bins,
                          float* ws, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || m <= 0) return 0;
  if (plan(b, h).ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == 128) {
    err = launch<128>(mags, b, h, m, cid, cmag, n_valid, prom, bins, ws, device, s);
  } else if (threads == 256) {
    err = launch<256>(mags, b, h, m, cid, cmag, n_valid, prom, bins, ws, device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
