// Fused four-step DFT -> half-spectrum magnitudes of a batch of windows,
// one thread block per window, for sm_90a.
//
// Replaces the TPU kernel `halfspec_magnitudes_pallas`
// (apda_fft_tpu/ops/fft_pallas.py, body `_fused_kernel`).  For each row
// x[0..n) of a [B, n] float32 batch, n = n1*n2 a power of two >= 64 split by
// `split_pow2` (n1 >= n2), it computes the four-step DFT against the
// float64-built tables (DFT over m1, twiddle W_n^{k1*m2}, DFT over m2) and
// writes |X[k]| for k = k1 + n1*k2 < n/2 in bin order, DC zeroed.  The
// windows arrive centred (`center_and_pad` or the mean detrend), so nothing
// is subtracted here; the arithmetic is the single-window kernel's front end
// (fourstep_common.cuh) without its mean.
//
// What bounds it on the card: the function needs only 6*n bytes of input and
// output a window and |rfft|'s ~2.5*n*log2(n) operations, so its bound is
// bytes (15 us at B=2048, n=4096).  This four-step does more: 2*n*n1 +
// 4*(n/2)*n2 float32 FMAs a window (1.05 M at n=4096, 85 FLOPs per byte,
// where the H100 breaks even at 20), which floor it at 64 us on FP32 FMAs.
// They run as plain FMA loops on the CUDA cores: the tensor cores' float32
// path is TF32 and would break the 1e-6 spectrum contract.  The design is the simple one: the batch gives one
// block per window, so every SM has blocks; the tables (a few KB to 1.5 MB)
// are read from global memory, where they stay L2-resident and each table
// row is a broadcast along a warp; the [2*n1, n2] intermediate lives in
// dynamic shared memory while it fits in the 227 KB a block may use
// (n <= 16384) and in a per-window slice of a global workspace the wrapper
// allocates otherwise, so any power of two the TPU kernel takes is taken.
// Each FMA still loads one operand from shared memory or L1, so the loop is
// load-bound well before the FMA rate.

#include "fourstep_common.cuh"

namespace {

using namespace apda;

constexpr int kThreads = 256;
// Dynamic shared memory a block may use on Hopper.
constexpr size_t kSmemCap = 227 * 1024;

size_t intermediate_bytes(int n) { return 2 * (size_t)n * sizeof(float); }

__global__ void __launch_bounds__(kThreads)
halfspec_fused_kernel(const float* __restrict__ x, int n1, int n2, FourStepTables t,
                      float* __restrict__ out, float* __restrict__ ws, int b_smem) {
  extern __shared__ float smem[];
  const size_t row = blockIdx.x;
  const size_t n = (size_t)n1 * n2;
  float* b = b_smem ? smem : ws + row * 2 * n;
  fourstep_halfspec<false>(x + row * n, 0.f, n1, n2, t, b, out + row * (n / 2));
}

}  // namespace

extern "C" {

// Floats of global workspace one window at length n needs (0 when its
// intermediate fits in shared memory).
long long apda_halfspec_workspace_floats(int n) {
  return intermediate_bytes(n) <= kSmemCap ? 0 : 2 * (long long)n;
}

// |X[k]|, k < n/2, of the b windows x ([b, n1*n2] float32, contiguous) into
// out ([b, n/2] float32) on `stream`.  The tables are `_tables(n1, n2)`;
// `ws` holds b * apda_halfspec_workspace_floats(n) floats (may be null when
// that is 0).  Returns the cudaError_t of the launch (0 on success).
int apda_halfspec_fused(const float* x, int b, int n1, int n2, const float* cs1,
                        const float* twc, const float* tws, const float* c2h,
                        const float* s2h, float* out, float* ws, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  const int n = n1 * n2;
  const bool b_smem = intermediate_bytes(n) <= kSmemCap;
  if (!b_smem && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = b_smem ? intermediate_bytes(n) : 0;
  // Dynamic shared memory past 48 KB needs the opt-in; ask for what the
  // launch uses every time.
  err = cudaFuncSetAttribute(halfspec_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const FourStepTables t = {cs1, twc, tws, c2h, s2h};
  halfspec_fused_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(x, n1, n2, t, out, ws,
                                                                      b_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
