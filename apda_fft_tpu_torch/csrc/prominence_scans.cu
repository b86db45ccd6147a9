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
// Rows too long for the summaries walk bin by bin.  A row with no valid
// slot writes its fill and loads nothing.  On the select+scan kernel's
// picks the results are that kernel's bits (the same warp_scan_at).
// Build without fast math.

#include "walk_common.cuh"

namespace {

using namespace apda;

// Dynamic shared memory a block may use on Hopper (the kernel has no static
// shared memory).
constexpr size_t kSmemCap = 227 * 1024;

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

template <int kThreads>
cudaError_t launch(const float* mags, int b, int h, int m, const int* cid, const float* cmag,
                   const int* n_valid, float* prom, int* bins, int device, cudaStream_t stream) {
  const size_t smem =
      (size_t)h * sizeof(float) + (has_summaries(h) ? 8 * (size_t)n_chunks(h) : 0);
  // Dynamic shared memory past 48 KB needs the opt-in, once per device
  // for the largest size asked so far.
  static size_t opted_in[64];
  if (smem > 48 * 1024 && (device < 0 || device >= 64 || smem > opted_in[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        preselected_scans_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) opted_in[device] = smem;
  }
  preselected_scans_kernel<kThreads><<<b, kThreads, smem, stream>>>(mags, h, m, cid, cmag,
                                                                    n_valid, prom, bins);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// with the slots cid/cmag ([b, m] int32/float32) and n_valid ([b] int32) on
// `stream`, in blocks of `threads` (128 or 256); outputs are prom/bins
// [b, m] float32/int32.  Returns the cudaError_t of the launch (0 on
// success).
int apda_prominence_scans(const float* mags, int b, int h, int m, const int* cid,
                          const float* cmag, const int* n_valid, float* prom, int* bins,
                          int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || m <= 0) return 0;
  if ((size_t)h * sizeof(float) > kSmemCap) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == 128) {
    err = launch<128>(mags, b, h, m, cid, cmag, n_valid, prom, bins, device, s);
  } else if (threads == 256) {
    err = launch<256>(mags, b, h, m, cid, cmag, n_valid, prom, bins, device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
