// The FFT of the port's front-end kernels: |X[k]| = |rfft(x)[k]|, k < n/2,
// DC zeroed, of a real float32 row x[0..n), n a power of two >= 64, with
// L = n/2:
//   1. pack: z[m] = x[2m] + i*x[2m+1] (minus the row's mean when asked),
//      L complex points;
//   2. the L-point complex FFT Z in Stockham passes: one radix-2 or radix-4
//      pass when log2(L) is not a multiple of 3, then radix-8 passes.  Each
//      thread loads the points of one butterfly into registers, twiddles
//      and transforms them there and stores them in natural order into the
//      other of two buffers, so there is no bit-reversal pass;
//   3. split: for 1 <= k <= L/2, with A = Z[k], B = conj Z[L-k],
//      E = (A+B)/2, O = (A-B)/2 and W = W_n^k,
//      X[k] = E - i*W*O and X[L-k] = conj(E + i*W*O): one thread takes the
//      pair and writes both magnitudes.
// Every twiddle comes from one float32 table of W_n^k, k < n/2, built in
// float64 (ops/fft_cuda.py `_twiddle_table`): a pass's W_L^j is W_n^(2j),
// and W_n^(k+n/2) = -W_n^k covers the rest, so no twiddle is computed with
// sin/cos on the card and the error grows as O(eps*log n).  The exchange
// buffers skip every 16th slot so that the radix-8 strides do not pile onto
// one bank.
//
// The threads of one row are `first`, `first + stride`, ...: a slice of a
// block (halfspec_fused.cu, several rows a block at small n), the whole
// block (lowlat_window.cu, one window), or the CTAs of a thread-block
// cluster (lowlat_window.cu's cluster kernels, whose exchange buffers are
// spread over the CTAs' shared memory).  The pass, pack and split read and
// write a buffer through a view (`buf[i]` is point i: `Padded` for a buffer
// in one block's memory), so every layout runs the same arithmetic.  Every
// thread of the block reaches the barriers of `fft_passes`.  Build without
// fast math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace apda {

constexpr float kSqrtHalf = 0.70710678118654752f;

// Points of one exchange buffer: every 16th slot is skipped.
__host__ __device__ __forceinline__ int padded(int l) { return l + (l >> 4); }
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// An exchange buffer in one block's memory (shared, or a workspace): point
// i at slot pad(i).
template <typename T>
struct Padded {
  T* p;
  __device__ __forceinline__ T& operator[](int i) const { return p[pad(i)]; }
};

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
template <int R, typename Src, typename Dst>
__device__ __forceinline__ void stockham_pass(const Src src, const Dst dst, int l, int ns,
                                              int first, int stride,
                                              const float2* __restrict__ t) {
  const int nb = l / R;
  const int step = 2 * l / (ns * R);  // W_(ns*R) = W_n^step
  for (int b = first; b < nb; b += stride) {
    const int k = b & (ns - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[b + r * nb];
    if (ns > 1) {  // the first pass's twiddles are all W^0 = 1
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], twiddle(t, r * k * step, l));
    }
    dft<R>(v);
    const int d = (b - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[d + r * ns] = v[r];
  }
}

// Pack of the row x (16-byte aligned) into the buffer view a: one float4 is
// the two complex points z[2q], z[2q+1]; with kCentre each sample first
// loses `mean` (rounded subtraction).  Four independent 16-byte loads in
// flight per thread.
template <bool kCentre, typename Buf>
__device__ __forceinline__ void pack_points(const float* __restrict__ x, float mean, const Buf a,
                                            int l, int first, int stride) {
  const float4* src = reinterpret_cast<const float4*>(x);
  for (int q0 = first; q0 < l / 2; q0 += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u * stride < l / 2) v[u] = __ldg(src + q0 + u * stride);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * stride;
      if (q < l / 2) {
        if (kCentre) {
          v[u] = make_float4(__fsub_rn(v[u].x, mean), __fsub_rn(v[u].y, mean),
                             __fsub_rn(v[u].z, mean), __fsub_rn(v[u].w, mean));
        }
        a[2 * q] = {v[u].x, v[u].y};
        a[2 * q + 1] = {v[u].z, v[u].w};
      }
    }
  }
}

template <bool kCentre>
__device__ __forceinline__ void pack_row(const float* __restrict__ x, float mean, float2* a,
                                         int l, int first, int stride) {
  pack_points<kCentre>(x, mean, Padded<float2>{a}, l, first, stride);
}

// The Stockham passes over the packed points in a, exchanging through c;
// on return a holds Z (the two pointers swap with each pass).  The caller
// has placed a barrier between the pack and this; a barrier ends each pass.
__device__ __forceinline__ void fft_passes(float2*& a, float2*& c, int l, int first, int stride,
                                           const float2* __restrict__ t) {
  int ns = 1;
  const int rem = (31 - __clz(l)) % 3;
  if (rem != 0) {
    if (rem == 1) {
      stockham_pass<2>(Padded<const float2>{a}, Padded<float2>{c}, l, ns, first, stride, t);
    } else {
      stockham_pass<4>(Padded<const float2>{a}, Padded<float2>{c}, l, ns, first, stride, t);
    }
    ns <<= rem;
    float2* s = a;
    a = c;
    c = s;
    __syncthreads();
  }
  for (; ns < l; ns *= 8) {
    stockham_pass<8>(Padded<const float2>{a}, Padded<float2>{c}, l, ns, first, stride, t);
    float2* s = a;
    a = c;
    c = s;
    __syncthreads();
  }
}

__device__ __forceinline__ float mag(float re, float im) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// Split of the packed transform Z (the buffer view a) into the real one's
// magnitudes o[k], k < l, in bin order, DC 0 (`o[k] = v` stores them: a
// pointer, or a view of the places they go).
template <typename Buf, typename Mags>
__device__ __forceinline__ void split_points(const Buf a, const float2* __restrict__ t,
                                             const Mags o, int l, int first, int stride) {
  for (int k = first; k <= l / 2; k += stride) {
    if (k == 0) {
      o[0] = 0.f;
      continue;
    }
    const float2 za = a[k], zb = a[l - k];
    const float er = 0.5f * (za.x + zb.x), ei = 0.5f * (za.y - zb.y);
    const float orr = 0.5f * (za.x - zb.x), oi = 0.5f * (za.y + zb.y);
    const float2 w = __ldg(t + k);
    const float pr = w.x * orr - w.y * oi;  // W*O = pr + i*pi; i*W*O = -pi + i*pr
    const float pi = w.x * oi + w.y * orr;
    o[k] = mag(er + pi, ei - pr);
    if (l - k != k) o[l - k] = mag(er - pi, ei + pr);
  }
}

__device__ __forceinline__ void split_mags(const float2* a, const float2* __restrict__ t,
                                           float* o, int l, int first, int stride) {
  split_points(Padded<const float2>{a}, t, o, l, first, stride);
}

}  // namespace apda
