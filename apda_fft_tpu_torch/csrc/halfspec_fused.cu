// FFT-shaped half-spectrum magnitudes of a batch of real windows, for sm_90a.
//
// Replaces the TPU kernel `halfspec_magnitudes_pallas`
// (apda_fft_tpu/ops/fft_pallas.py, body `_fused_kernel`).  For each row
// x[0..n) of a [B, n] float32 batch, n a power of two >= 64, it writes
// |X[k]| = |rfft(x)[k]| for k < n/2 in bin order, DC zeroed.  The windows
// arrive centred (`center_and_pad` or the mean detrend), so nothing is
// subtracted here.  The transform is the FFT of fft_common.cuh: each row
// packed into n/2 complex points, Stockham passes (radix 8, one radix-2/4
// pass first) between two shared buffers, then the real split, all on one
// float64-built twiddle table (ops/fft_cuda.py `_twiddle_table`).
//
// What bounds it on the card: the function moves 6*n bytes a window and
// needs |rfft|'s ~2.5*n*log2(n) operations, so its bound is bytes (15 us at
// B=2048, n=4096).  The row is read once with 16-byte loads and the n/2
// magnitudes written once, both coalesced; the passes exchange points
// through shared memory (two buffers of n/2 complex points a window, every
// 16th slot skipped so that the radix-8 strides do not pile onto one bank).
// At n <= 1024 a block of 256 threads holds several windows (n/16 threads
// each); at n >= 2048 one window.  Above n = 16384 the two buffers outgrow
// the 227 KB a block may use and live in a per-window slice of a global
// workspace the wrapper allocates (slow, L2-resident, but any n works).
// At n = 4096 a block uses 34 KB, so 6 windows share an SM and the batch
// runs in about 2.6 waves; each window loads its row in one burst and then
// computes, so HBM likely idles between bursts (not measured: the card's
// counters cannot be read).  The FFT's device code is shared with the
// flexible single-window kernel (lowlat_window.cu).  Build without fast
// math.

#include "fft_common.cuh"

namespace {

using namespace apda;

// 256 threads a block: 64 and 128 were slower on the H100, 512 no faster.
constexpr int kThreads = 256;
// Dynamic shared memory a block may use on Hopper.
constexpr size_t kSmemCap = 227 * 1024;

// Threads per window and windows per block at L complex points.
__host__ __device__ __forceinline__ int window_threads(int l) {
  return l / 8 < kThreads ? l / 8 : kThreads;
}

size_t smem_bytes(int l) {
  return (size_t)(kThreads / window_threads(l)) * 2 * padded(l) * sizeof(float2);
}

__global__ void __launch_bounds__(kThreads)
halfspec_fft_kernel(const float* __restrict__ x, int b, int n, const float2* __restrict__ t,
                    float* __restrict__ out, float2* __restrict__ ws, int in_smem) {
  extern __shared__ float2 smem[];
  const int l = n / 2;
  const int tw = window_threads(l);
  const int slot = threadIdx.x / tw;
  const size_t row = (size_t)blockIdx.x * (kThreads / tw) + slot;
  // Threads of a window slot past the batch run every loop zero times but
  // still reach every barrier.
  const int first = row < (size_t)b ? threadIdx.x - slot * tw : l + 1;
  const int lp = padded(l);
  float2* a = in_smem ? smem + (size_t)slot * 2 * lp : ws + (row < (size_t)b ? row : 0) * 2 * lp;
  float2* c = a + lp;
  pack_row<false>(x + row * n, 0.f, a, l, first, tw);
  __syncthreads();
  fft_passes(a, c, l, first, tw, t);
  split_mags(a, t, out + row * l, l, first, tw);
}

}  // namespace

extern "C" {

// Floats of global workspace one window at length n needs (0 when its two
// exchange buffers fit in shared memory).
long long apda_halfspec_workspace_floats(int n) {
  const int l = n / 2;
  return smem_bytes(l) <= kSmemCap ? 0 : 4 * (long long)padded(l);
}

// |X[k]|, k < n/2, of the b windows x ([b, n] float32, contiguous, 16-byte
// aligned) into out ([b, n/2] float32) on `stream`.  `table` is
// `_twiddle_table(n)`: W_n^k, k < n/2, as interleaved float32 pairs; `ws`
// holds b * apda_halfspec_workspace_floats(n) floats (may be null when that
// is 0).  Returns the cudaError_t of the launch (0 on success).
int apda_halfspec_fused(const float* x, int b, int n, const float* table, float* out, float* ws,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  if (n < 64 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int l = n / 2;
  const bool in_smem = smem_bytes(l) <= kSmemCap;
  if (!in_smem && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? smem_bytes(l) : 0;
  const int per_block = kThreads / window_threads(l);
  // Dynamic shared memory past 48 KB needs the opt-in; ask for what the
  // launch uses every time.
  err = cudaFuncSetAttribute(halfspec_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (b + per_block - 1) / per_block;
  halfspec_fft_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, b, n, reinterpret_cast<const float2*>(table), out, reinterpret_cast<float2*>(ws),
      in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
