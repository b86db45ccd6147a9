// Prominence and -3 dB width of pre-selected candidates, one thread block
// per window, for sm_90a.
//
// Replaces the TPU kernel `prominence_scans_pallas`
// (apda_fft_tpu/ops/detector_pallas.py, body `_scan_kernel`).  For each row
// x[0..H) of a [B, H] float32 magnitude batch, with the row's candidate slots
// cid/cmag [M] and its count n_valid of valid slots (a prefix), it computes
// for every slot i < min(n_valid, M) the prominence (peak minus the higher
// flanking valley, each valley bounded by the nearest sample above the peak)
// and the -3 dB width in bins at valley + 0.707*prominence, with the peak
// taken from cmag.  Slots past that are written as prominence 0 / width 1.
//
// What bounds it on the card: the same as the select+scan kernel's scans -
// a latency-bound chain of three block reductions per valid slot (blockers,
// valleys, width stops) on a row that sits in shared memory; the row is read
// from device memory once.  One block per window lets B chains run side by
// side on the SMs, and a row stops after its own valid slots.  The scan is
// `scan_at` of detector_common.cuh, so on the select+scan kernel's picks the
// results are the same bits as that kernel's.
//
// The kernel clamps n_valid to [0, M], so a bad count cannot read past a
// row's slots; cid is only compared with bin indices, never used as one.

#include "detector_common.cuh"

namespace {

using namespace apda;

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__global__ void __launch_bounds__(kMaxThreads)
scans_kernel(const float* __restrict__ mags, int h, int m, const int* __restrict__ cid,
             const float* __restrict__ cmag, const int* __restrict__ n_valid,
             float* __restrict__ prom, int* __restrict__ bins) {
  extern __shared__ float x[];
  __shared__ Scratch<kMaxWarps> sc;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row = blockIdx.x;
  const float* src = mags + row * (size_t)h;
  for (int i = tid; i < h; i += nt) x[i] = src[i];
  __syncthreads();

  const size_t o = row * (size_t)m;
  const int live = min(max(n_valid[row], 0), m);
  for (int r = 0; r < live; ++r) {
    float pr;
    int bn;
    scan_at(x, h, cid[o + r], cmag[o + r], sc, &pr, &bn);
    if (tid == 0) {
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
  }
  for (int r = live + tid; r < m; r += nt) {
    prom[o + r] = 0.f;
    bins[o + r] = 1;
  }
}

}  // namespace

extern "C" {

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// with the slots cid/cmag ([b, m] int32/float32) and n_valid ([b] int32) on
// `stream`; outputs are prom/bins [b, m] float32/int32.  Returns the
// cudaError_t of the launch (0 on success).
int apda_prominence_scans(const float* mags, int b, int h, int m, const int* cid,
                          const float* cmag, const int* n_valid, float* prom, int* bins,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || m <= 0) return 0;
  int threads = h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)h * sizeof(float);
  // Dynamic plus static shared memory past 48 KB needs the opt-in; ask for
  // what the launch uses every time.
  err = cudaFuncSetAttribute(scans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  scans_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(mags, h, m, cid, cmag, n_valid,
                                                           prom, bins);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
