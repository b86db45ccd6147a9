// The four-step half-spectrum front end of the rigid single-window kernel
// (B3) in lowlat_window.cu (one block for one whole window, mean-centred
// inside), its only user: the flexible single-window kernel (B2) and the
// batched front end (B4) run the FFT of fft_common.cuh.
//
// For one float32 window x[0..n), n = n1*n2 a power of two:
//   step 1: b[r, m2] = sum_m1 cs1[r, m1] * x[m2 + n2*m1]  (r < n1: cos rows,
//           r >= n1: sin rows - the n1-point DFT over m1);
//   step 2: the twiddle W_n^{k1*m2}, in place: [br; bi] -> [cr; ci];
//   step 3: the n2-point DFT over m2 against the half tables [n2, n2/2], then
//           |X[k]| = sqrt(dr*dr + di*di) for k = k1 + n1*k2 < n/2, DC zeroed.
// Plain float32 FMA loops (no tensor cores: their float32 path is TF32 and
// would break the 1e-6 spectrum contract); build without fast math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace apda {

// The float64-built tables of ops/fft_cuda.py `_tables`.
struct FourStepTables {
  const float* cs1;  // [2*n1, n1]: c1 rows, then s1 rows
  const float* twc;  // [n1, n2]
  const float* tws;  // [n1, n2]
  const float* c2h;  // [n2, n2/2]
  const float* s2h;  // [n2, n2/2]
};

// Four-step DFT of x (minus `mean` when kCentre) -> mags[k], k = k1 + n1*k2
// < n/2, DC 0, computed by the whole block.  b is the [2*n1, n2]
// intermediate (shared or global memory).  Ends with a __syncthreads.
template <bool kCentre>
__device__ __forceinline__ void fourstep_halfspec(const float* __restrict__ x, float mean,
                                                  int n1, int n2, FourStepTables t, float* b,
                                                  float* mags) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = n1 * n2;
  // Step 1.  Neighbouring threads take neighbouring m2: the x reads
  // coalesce and the table row is a broadcast.
  for (int o = tid; o < 2 * n; o += nt) {
    const int r = o / n2;
    const int m2 = o - r * n2;
    const float* row = t.cs1 + (size_t)r * n1;
    float acc = 0.f;
    for (int m1 = 0; m1 < n1; ++m1) {
      const float xv = x[m2 + (size_t)n2 * m1];
      acc = fmaf(row[m1], kCentre ? __fsub_rn(xv, mean) : xv, acc);
    }
    b[o] = acc;
  }
  __syncthreads();
  // Step 2: twiddle W_n^{k1*m2}, in place.
  for (int o = tid; o < n; o += nt) {
    const float br = b[o], bi = b[n + o];
    const float c = t.twc[o], sn = t.tws[o];
    b[o] = br * c - bi * sn;
    b[n + o] = br * sn + bi * c;
  }
  __syncthreads();
  // Step 3 against the half tables, then |X|.  Neighbouring threads take
  // neighbouring k2: the table reads coalesce, the cr/ci row is a broadcast.
  const int n2h = n2 / 2;
  const int h = n1 * n2h;
  for (int o = tid; o < h; o += nt) {
    const int k1 = o / n2h;
    const int k2 = o - k1 * n2h;
    const float* cr = b + (size_t)k1 * n2;
    const float* ci = b + n + (size_t)k1 * n2;
    float pr = 0.f, pi = 0.f, qr = 0.f, qi = 0.f;
    for (int m2 = 0; m2 < n2; ++m2) {
      const float c = t.c2h[(size_t)m2 * n2h + k2];
      const float sn = t.s2h[(size_t)m2 * n2h + k2];
      pr = fmaf(cr[m2], c, pr);
      qr = fmaf(cr[m2], sn, qr);
      pi = fmaf(ci[m2], c, pi);
      qi = fmaf(ci[m2], sn, qi);
    }
    const float dr = __fsub_rn(pr, qi);
    const float di = __fadd_rn(qr, pi);
    const int k = k1 + n1 * k2;
    mags[k] = k == 0 ? 0.f : __fsqrt_rn(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)));
  }
  __syncthreads();
}

}  // namespace apda
