// One whole window, end to end, in one launch: the single-window latency
// route, for sm_90a.
//
// Replaces the TPU kernels of `analyze_window_lowlat`
// (apda_fft_tpu/ops/latency_pallas.py): `_flex_kernel` (flexible mode) and
// `_rigid_kernel` (rigid mode).  For one float32 window x[0..n), n = n1*n2 a
// power of two, both kernels compute
//   * the mean-centred four-step DFT against the float64-built tables of
//     `_tables` (step 1: [c1; s1] @ a with a[m1, m2] = x[m2 + n2*m1]; the
//     twiddle; step 3 against the half tables [n2, n2/2]), then
//     |X[k]| = sqrt(dr*dr + di*di) for k < n/2 with the DC bin zeroed,
//     written in bin order k = k1 + n1*k2;
//   * the noise threshold mean + 2*std (ddof=1) and the candidates (strict
//     interior local maxima above it);
// and then
//   * flexible: up to `m_budget` picks in the reference's walk order
//     (4-dp-rounded magnitude descending, ties by ascending bin), each with
//     its prominence and -3 dB width, fed one by one to the greedy finalize
//     (integer damping band, reference rounding, 5 % shoulder exclusion);
//     `n_required` as in `prominence_finalize`;
//   * rigid: the destructive Rayleigh greedy on a working copy of the
//     magnitudes (argmax of the current local maxima above the original
//     threshold, -3 dB width at 0.707*peak, 1.18*|di|/w >= 1.5 against every
//     accepted peak, a wipe of round(f*0.02/df) bins each side);
//   * the parabolic sub-bin refine on the unwiped magnitudes.
//
// What bounds it on the card: one window gives one thread block, so the
// kernel runs on one of the 132 SMs.  The front end is 2*n*(n1+n2) float32
// FMAs (1 M at n=4096, 67 M at n=65536) in plain FMA loops - no tensor cores, whose
// float32 path is TF32 and would break the 1e-6 spectrum contract.  The
// detector is a serial chain of block reductions (four per flexible pick,
// two per rigid round), each a warp-shuffle tree and two __syncthreads.
// The design keeps that chain short: the finalize runs as each pick
// arrives and stops at the k-th acceptance (later picks cannot change any
// output), and the magnitudes - read by every reduction - sit in shared
// memory.  The step-1/step-3 intermediate ([2*n1, n2]) and the rigid
// working copy go to shared memory when they fit in the 227 KB a block may
// use and to a global workspace the wrapper allocates otherwise (layout()).
//
// Arithmetic that decides (threshold, selection score, width targets, the
// finalize's rounding and ratios, the wipe count, the refine) uses explicitly
// rounded IEEE operations; build without fast math.

#include "detector_common.cuh"
#include "fourstep_common.cuh"

namespace {

using namespace apda;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Dynamic shared memory a block may use on Hopper, less the static scratch.
constexpr size_t kSmemCap = 227 * 1024 - 2048;

// Where the kernel's arrays live: shared memory when they fit, in the order
// magnitudes, rigid working copy, four-step intermediate; else the
// workspace.
struct Layout {
  size_t smem_bytes;
  size_t ws_floats;
  bool mags_smem, work_smem, b_smem;
};

Layout layout(int n, bool rigid) {
  const size_t h = (size_t)n / 2;
  Layout l = {0, 0, false, false, false};
  auto place = [&](size_t floats, bool* in_smem) {
    if (l.smem_bytes + floats * sizeof(float) <= kSmemCap) {
      l.smem_bytes += floats * sizeof(float);
      *in_smem = true;
    } else {
      l.ws_floats += floats;
    }
  };
  place(h, &l.mags_smem);
  if (rigid) place(h, &l.work_smem);
  place(2 * (size_t)n, &l.b_smem);
  return l;
}

struct Arrays {
  float* mags;
  float* work;
  float* b;
};

__device__ Arrays carve(float* smem, float* ws, int n, bool rigid, bool mags_smem,
                        bool work_smem, bool b_smem) {
  const size_t h = (size_t)n / 2;
  float* s = smem;
  float* w = ws;
  auto take = [&](size_t floats, bool in_smem) {
    float* p = in_smem ? s : w;
    (in_smem ? s : w) += floats;
    return p;
  };
  Arrays a;
  a.mags = take(h, mags_smem);
  a.work = rigid ? take(h, work_smem) : nullptr;
  a.b = take(2 * (size_t)n, b_smem);
  return a;
}

// Mean-centred four-step DFT of x -> mags[k], k = k1 + n1*k2 < n/2, DC 0.
// b is the [2*n1, n2] intermediate.  Ends with a __syncthreads.
template <typename S>
__device__ void front_end(const float* __restrict__ x, int n1, int n2, FourStepTables t,
                          float* b, float* mags, S& sc) {
  const int n = n1 * n2;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s = __fadd_rn(s, x[i]);
  s = block_reduce(s, SumF(), sc.f);
  fourstep_halfspec<true>(x, __fdiv_rn(s, (float)n), n1, n2, t, b, mags);
}

__device__ __forceinline__ float round_dec(float v, float scale) {
  return __fdiv_rn(rintf(__fmul_rn(v, scale)), scale);
}

// Parabolic sub-bin frequency of slot idx (0 for an empty slot), clamped
// to +-0.5 bin (`refine_subbin`).
__device__ float refine_slot(const float* m, int h, int idx, float ds) {
  if (idx < 0) return 0.f;
  const int s = min(max(idx, 1), h - 2);
  const float m0 = m[s - 1], m1 = m[s], m2 = m[s + 1];
  const float denom = __fadd_rn(__fsub_rn(m0, __fmul_rn(2.f, m1)), m2);
  float delta = fabsf(denom) > 1e-30f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(m0, m2)), denom)
                                      : 0.f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);
  return __fmul_rn(__fadd_rn((float)s, delta), ds);
}

// round(f*0.02/df) with the halves snapped like the float64 reference
// (`peaks_resolution._discard_count`).
__device__ __forceinline__ int discard_count(float freq, float ds) {
  const float v = __fdiv_rn(__fmul_rn(freq, 0.02f), ds);
  const float doubled = __fadd_rn(v, v);
  const float nearest = rintf(doubled);
  const bool near_half = fabsf(__fsub_rn(doubled, nearest)) < 1e-3f;
  return (int)rintf(near_half ? __fmul_rn(nearest, 0.5f) : v);
}

// Output layout: iout = [idx k | count | n_cand | n_required],
// fout = [freq | mag | prom | damping | q | refined], k each.
struct Out {
  int* idx;
  int* scalars;
  float* freq;
  float* mag;
  float* prom;
  float* damp;
  float* q;
  float* refined;
};

__device__ Out outputs(int* iout, float* fout, int k) {
  Out o = {iout, iout + k, fout, fout + k, fout + 2 * k, fout + 3 * k, fout + 4 * k,
           fout + 5 * k};
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    o.idx[i] = -1;
    o.freq[i] = o.mag[i] = o.prom[i] = o.damp[i] = o.q[i] = o.refined[i] = 0.f;
  }
  return o;
}

__global__ void __launch_bounds__(kThreads)
lowlat_flexible_kernel(const float* __restrict__ x, int n1, int n2, FourStepTables t,
                       const float* __restrict__ fs, int k, int m_budget, int refine,
                       int* iout, float* fout, float* ws, bool mags_smem, bool b_smem) {
  extern __shared__ float smem[];
  __shared__ Scratch<kWarps> sc;
  __shared__ int s_count;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = n1 * n2;
  const int h = n / 2;
  const Arrays a = carve(smem, ws, n, false, mags_smem, false, b_smem);
  const Out out = outputs(iout, fout, k);
  if (tid == 0) s_count = 0;
  front_end(x, n1, n2, t, a.b, a.mags, sc);
  const float* m = a.mags;

  float sd;
  const float thr = noise_threshold(m, h, sc, &sd);
  int c = 0;
  for (int i = tid; i < h; i += nt) c += is_candidate(m, h, i, thr) ? 1 : 0;
  const int n_cand = block_reduce(c, SumI(), sc.i);
  const float ds = __fdiv_rn(*fs, (float)n);
  const float half_sd = __fmul_rn(0.5f, sd);

  // Thread 0 runs the greedy finalize on each pick as it arrives.  Once k
  // peaks are accepted the walk is complete: later picks change nothing.
  int count = 0, consumed = 0;
  const int live = min(n_cand, m_budget);
  Pick prev = {0.f, -1};
  for (int r = 0; r < live; ++r) {
    Pick best = {-INFINITY, h};  // loses to every candidate
    for (int i = tid; i < h; i += nt) {
      if (!is_candidate(m, h, i, thr)) continue;
      const Pick p = {score_of(m[i]), i};
      if ((r == 0 || before(prev, p)) && before(p, best)) best = p;
    }
    best = block_reduce(best, First(), sc.p);
    const int j = best.i;
    const float cmag = m[j];
    float prom;
    int bins;
    scan_at(m, h, j, cmag, sc, &prom, &bins);
    if (tid == 0) {
      ++consumed;
      const float width = __fmul_rn((float)bins, ds);
      const float fn = __fmul_rn((float)j, ds);
      const float q = __fdiv_rn(fn, width);
      const float damping = __fdiv_rn(1.f, __fmul_rn(2.f, q));
      // Exact integer damping band: d = bins/(2*j) in [1/1000, 7/100].
      const bool valid = prom > half_sd && width > 0.f && 500 * bins >= j && 50 * bins <= 7 * j;
      const float freq_r = round_dec(fn, 1e4f);
      const float mag_r = round_dec(cmag, 1e4f);
      // A magnitude that rounds to 0 gets prominence ratio 0.
      const float ratio = mag_r > 0.f ? __fdiv_rn(prom, mag_r) : 0.f;
      bool near = false;
      for (int s = 0; s < count; ++s) {
        const float f2 = out.freq[s];
        const float rel = __fdiv_rn(fabsf(__fsub_rn(freq_r, f2)), f2 != 0.f ? f2 : 1.f);
        near = near || rel < 0.05f;
      }
      if (valid && !(near && ratio < 0.10f)) {
        out.idx[count] = j;
        out.freq[count] = freq_r;
        out.mag[count] = mag_r;
        out.prom[count] = prom;
        out.damp[count] = round_dec(__fmul_rn(damping, 100.f), 100.f);
        out.q[count] = round_dec(q, 100.f);
        ++count;
      }
      s_count = count;
    }
    __syncthreads();
    if (s_count >= k) break;
    prev = best;
  }
  if (tid == 0) {
    out.scalars[0] = count;
    out.scalars[1] = n_cand;
    // Smallest budget deciding this window exactly: the slots consumed up
    // to the k-th acceptance, else every pre-budget candidate.
    out.scalars[2] = count >= k ? consumed : n_cand;
  }
  __syncthreads();
  for (int s = tid; s < k; s += nt) out.refined[s] = refine ? refine_slot(m, h, out.idx[s], ds) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
lowlat_rigid_kernel(const float* __restrict__ x, int n1, int n2, FourStepTables t,
                    const float* __restrict__ fs, int k, int refine, int* iout, float* fout,
                    float* ws, bool mags_smem, bool work_smem, bool b_smem) {
  extern __shared__ float smem[];
  __shared__ Scratch<kWarps> sc;
  __shared__ int s_count;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = n1 * n2;
  const int h = n / 2;
  const Arrays a = carve(smem, ws, n, true, mags_smem, work_smem, b_smem);
  const Out out = outputs(iout, fout, k);
  if (tid == 0) s_count = 0;
  front_end(x, n1, n2, t, a.b, a.mags, sc);
  const float* m = a.mags;
  float* w = a.work;

  float sd;
  const float thr = noise_threshold(m, h, sc, &sd);
  int c = 0;
  for (int i = tid; i < h; i += nt) {
    c += is_candidate(m, h, i, thr) ? 1 : 0;
    w[i] = m[i];
  }
  const int n_cand = block_reduce(c, SumI(), sc.i);  // its barrier publishes w
  const float ds = __fdiv_rn(*fs, (float)n);

  int count = 0;
  while (true) {
    // The highest current local maximum above the original threshold,
    // first index on ties.
    Pick best = {-INFINITY, h};
    for (int i = tid; i < h; i += nt) {
      if (!is_candidate(w, h, i, thr)) continue;
      const Pick p = {w[i], i};
      if (before(p, best)) best = p;
    }
    best = block_reduce(best, First(), sc.p);
    if (best.i >= h) break;  // no candidate left
    const int j = best.i;
    const float peak = best.s;
    // -3 dB width on the current magnitudes: nearest index at or below
    // 0.707*peak on each side (left defaults to 0, right to h).
    const float half = __fmul_rn(0.707f, peak);
    I2 st = {0, h};
    for (int i = tid; i < h; i += nt) {
      if (w[i] <= half) {
        if (i <= j) st.a = max(st.a, i);
        if (i >= j) st.b = min(st.b, i);
      }
    }
    st = block_reduce(st, MaxMinI(), sc.i2);
    if (tid == 0) {
      // Accepted peaks' own widths are 0 on the wiped spectrum, so the
      // Rayleigh term is 1.18*|di|/w_new against each of them.
      const float w_new = (float)(st.b - st.a);
      bool separated = true;
      for (int s = 0; s < count; ++s) {
        const float di = (float)abs(out.idx[s] - j);
        const float rs = w_new != 0.f ? __fdiv_rn(__fmul_rn(1.18f, di), w_new) : 0.f;
        separated = separated && rs >= 1.5f;
      }
      if (separated) {
        out.idx[count] = j;
        out.freq[count] = __fmul_rn((float)j, ds);
        out.mag[count] = peak;
        ++count;
      }
      s_count = count;
    }
    // Wipe round(f*0.02/df) bins each side, taken or not.
    // Clamped so that a round always wipes its own bin; only a rate that
    // is not positive and finite reaches the clamp.
    const int nd = min(max(discard_count(__fmul_rn((float)j, ds), ds), 0), h);
    const int end = min(h, j + nd + 1);
    for (int i = max(0, j - nd) + tid; i < end; i += nt) w[i] = 0.f;
    __syncthreads();
    if (s_count >= k) break;
  }
  if (tid == 0) {
    out.scalars[0] = s_count;
    out.scalars[1] = n_cand;
    out.scalars[2] = 0;  // rigid mode has no budget
  }
  __syncthreads();
  for (int s = tid; s < k; s += nt) out.refined[s] = refine ? refine_slot(m, h, out.idx[s], ds) : 0.f;
}

}  // namespace

extern "C" {

// Floats of global workspace one launch at window length n needs (0 when
// every array fits in shared memory).
long long apda_lowlat_workspace_floats(int n, int rigid) {
  return (long long)layout(n, rigid != 0).ws_floats;
}

// Analyses the window x ([n1*n2] float32, contiguous) on `stream`.  The
// tables are `_tables(n1, n2)`, fs a 1-element device float.  Outputs:
// iout [k + 3] int32, fout [6*k] float32 (layout at `Out`).  `ws` holds
// apda_lowlat_workspace_floats(n, rigid) floats (may be null when that is
// 0).  Returns the cudaError_t of the launch (0 on success).
int apda_lowlat_window(int rigid, const float* x, int n1, int n2, const float* cs1,
                       const float* twc, const float* tws, const float* c2h, const float* s2h,
                       const float* fs, int k, int m_budget, int refine, int* iout, float* fout,
                       float* ws, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = n1 * n2;
  const Layout l = layout(n, rigid != 0);
  if (!l.mags_smem || (l.ws_floats > 0 && ws == nullptr) || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const FourStepTables t = {cs1, twc, tws, c2h, s2h};
  const cudaStream_t s = (cudaStream_t)stream;
  if (rigid) {
    // Dynamic plus static shared memory past 48 KB needs the opt-in.
    err = cudaFuncSetAttribute(lowlat_rigid_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    lowlat_rigid_kernel<<<1, kThreads, l.smem_bytes, s>>>(
        x, n1, n2, t, fs, k, refine, iout, fout, ws, l.mags_smem, l.work_smem, l.b_smem);
  } else {
    // Dynamic plus static shared memory past 48 KB needs the opt-in.
    err = cudaFuncSetAttribute(lowlat_flexible_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    lowlat_flexible_kernel<<<1, kThreads, l.smem_bytes, s>>>(
        x, n1, n2, t, fs, k, m_budget, refine, iout, fout, ws, l.mags_smem, l.b_smem);
  }
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
