// FFT-shaped half-spectrum magnitudes of a batch of real windows, for sm_90a.
//
// Replaces the TPU kernel `halfspec_magnitudes_pallas`
// (apda_fft_tpu/ops/fft_pallas.py, body `_fused_kernel`).  For each row
// x[0..n) of a [B, n] float32 batch, n a power of two >= 64, it writes
// |X[k]| = |rfft(x)[k]| for k < n/2 in bin order, DC zeroed.  The windows
// arrive centred (`center_and_pad` or the mean detrend), so nothing is
// subtracted here.  With L = n/2:
//   1. pack: z[m] = x[2m] + i*x[2m+1], L complex points;
//   2. the L-point complex FFT Z in Stockham passes: one radix-2 or radix-4
//      pass when log2(L) is not a multiple of 3, then radix-8 passes.  Each
//      thread loads the points of one butterfly into registers, twiddles
//      and transforms them there and stores them in natural order into the
//      other of two buffers, so there is no bit-reversal pass;
//   3. split: for 1 <= k <= L/2, with A = Z[k], B = conj Z[L-k],
//      E = (A+B)/2, O = (A-B)/2 and W = W_n^k,
//      X[k] = E - i*W*O and X[L-k] = conj(E + i*W*O): one thread takes the
//      pair and writes both magnitudes, with explicitly rounded operations.
// Every twiddle comes from one float32 table of W_n^k, k < n/2, built in
// float64 (ops/fft_cuda.py `_twiddle_table`): a pass's W_L^j is W_n^(2j),
// and W_n^(k+n/2) = -W_n^k covers the rest, so no twiddle is computed with
// sin/cos on the card and the error grows as O(eps*log n).
//
// What bounds it on the card: the function moves 6*n bytes a window and
// needs |rfft|'s ~2.5*n*log2(n) operations, so its bound is bytes (15 us at
// B=2048, n=4096).  The row is read once with 16-byte loads and the n/2
// magnitudes written once, both coalesced; the passes exchange points
// through shared memory (two buffers of L complex points a window, every
// 16th slot skipped so that the radix-8 strides do not pile onto one bank).
// At n <= 1024 a block of 256 threads holds several windows (L/8 threads
// each); at n >= 2048 one window.  Above n = 16384 the two buffers outgrow
// the 227 KB a block may use and live in a per-window slice of a global
// workspace the wrapper allocates (slow, L2-resident, but any n works).
// At n = 4096 a block uses 34 KB, so 6 windows share an SM and the batch
// runs in about 2.6 waves; each window loads its row in one burst and then
// computes, so HBM likely idles between bursts (not measured: the card's
// counters cannot be read here).  Build without fast math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// 256 threads a block: 64 and 128 were slower on the H100, 512 no faster.
constexpr int kThreads = 256;
// Dynamic shared memory a block may use on Hopper.
constexpr size_t kSmemCap = 227 * 1024;
constexpr float kSqrtHalf = 0.70710678118654752f;

// Threads per window and windows per block at L complex points.
__host__ __device__ __forceinline__ int window_threads(int l) {
  return l / 8 < kThreads ? l / 8 : kThreads;
}
// Points of one exchange buffer: every 16th slot is skipped.
__host__ __device__ __forceinline__ int padded(int l) { return l + (l >> 4); }
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

size_t smem_bytes(int l) {
  return (size_t)(kThreads / window_threads(l)) * 2 * padded(l) * sizeof(float2);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) { return {a.y, -a.x}; }

// W_n^e for 0 <= e < n from the table of W_n^k, k < n/2 = l.
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ t, int e, int l) {
  if (e < l) return __ldg(t + e);
  const float2 w = __ldg(t + e - l);
  return {-w.x, -w.y};
}

// In-register R-point DFTs, natural order: v[r] <- sum_m v[m] W_R^(r*m).
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = mul_mi(csub(a1, a3));
  a0 = cadd(s02, s13);
  a2 = csub(s02, s13);
  a1 = cadd(d02, d13);
  a3 = csub(d02, d13);
}

__device__ __forceinline__ void dft8(float2* v) {
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = {kSqrtHalf * (o1.x + o1.y), kSqrtHalf * (o1.y - o1.x)};   // * W_8
  o2 = mul_mi(o2);                                               // * W_8^2
  o3 = {kSqrtHalf * (o3.y - o3.x), -kSqrtHalf * (o3.x + o3.y)};  // * W_8^3
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    dft2(v);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    dft8(v);
  }
}

// One radix-R Stockham pass over L = l points: the sub-transforms of length
// ns become length ns*R.  Butterfly b reads src[b + r*l/R], twiddles point r
// by W_(ns*R)^(r*k), k = b mod ns, and writes dst[(b-k)*R + k + r*ns].
template <int R>
__device__ __forceinline__ void stockham_pass(const float2* src, float2* dst, int l, int ns,
                                              int first, int stride,
                                              const float2* __restrict__ t) {
  const int nb = l / R;
  const int step = 2 * l / (ns * R);  // W_(ns*R) = W_n^step
  for (int b = first; b < nb; b += stride) {
    const int k = b & (ns - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[pad(b + r * nb)];
    if (ns > 1) {  // the first pass's twiddles are all W^0 = 1
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], twiddle(t, r * k * step, l));
    }
    dft<R>(v);
    const int d = (b - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad(d + r * ns)] = v[r];
  }
}

__device__ __forceinline__ float mag(float re, float im) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
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

  // Pack: one float4 is the two complex points z[2q], z[2q+1].
  // Four independent 16-byte loads in flight per thread.
  const float4* src = reinterpret_cast<const float4*>(x + row * n);
  for (int q0 = first; q0 < l / 2; q0 += 4 * tw) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u * tw < l / 2) v[u] = __ldg(src + q0 + u * tw);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * tw;
      if (q < l / 2) {
        a[pad(2 * q)] = {v[u].x, v[u].y};
        a[pad(2 * q + 1)] = {v[u].z, v[u].w};
      }
    }
  }
  __syncthreads();

  int ns = 1;
  const int rem = (31 - __clz(l)) % 3;
  if (rem != 0) {
    if (rem == 1) {
      stockham_pass<2>(a, c, l, ns, first, tw, t);
    } else {
      stockham_pass<4>(a, c, l, ns, first, tw, t);
    }
    ns <<= rem;
    float2* s = a;
    a = c;
    c = s;
    __syncthreads();
  }
  for (; ns < l; ns *= 8) {
    stockham_pass<8>(a, c, l, ns, first, tw, t);
    float2* s = a;
    a = c;
    c = s;
    __syncthreads();
  }

  // Split the packed transform into the real one; a holds Z.
  float* o = out + row * l;
  for (int k = first; k <= l / 2; k += tw) {
    if (k == 0) {
      o[0] = 0.f;
      continue;
    }
    const float2 za = a[pad(k)], zb = a[pad(l - k)];
    const float er = 0.5f * (za.x + zb.x), ei = 0.5f * (za.y - zb.y);
    const float orr = 0.5f * (za.x - zb.x), oi = 0.5f * (za.y + zb.y);
    const float2 w = __ldg(t + k);
    const float pr = w.x * orr - w.y * oi;  // W*O = pr + i*pi; i*W*O = -pi + i*pr
    const float pi = w.x * oi + w.y * orr;
    o[k] = mag(er + pi, ei - pr);
    if (l - k != k) o[l - k] = mag(er - pi, ei + pr);
  }
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
