// Fused candidate selection + prominence/width scans of the flexible
// (prominence) detector, one thread block per window, for sm_90a.
//
// Replaces the TPU kernel `prominence_select_scan_pallas`
// (apda_fft_tpu/ops/detector_pallas.py, body `_fused_kernel`).  For each row
// x[0..H) of a [B, H] float32 magnitude batch it computes:
//   * the noise threshold mean + 2*std (ddof=1), in two passes like the
//     reference (sum -> mean, then the sum of squared deviations / (H-1));
//   * the strict interior local maxima above it and their count n_cand;
//   * up to min(n_cand, M) picks in the reference's walk order: the
//     4-dp-rounded magnitude descending, ties by ascending bin;
//   * per pick, the prominence (peak minus the higher flanking valley, each
//     valley bounded by the nearest sample above the peak) and the -3 dB
//     width in bins at valley + 0.707*prominence;
//   * for the slots past n_cand, the fill an exhausted argmax gives:
//     bin 0, is_cand 0, magnitude x[0], and the scans at (0, x[0]).
//
// What bounds it on the card: not bytes (the row is read from device memory
// once) but a latency-bound chain of block reductions - per live round one
// selection reduction and three scan reductions (blockers, valleys, width
// stops), each a warp-shuffle tree plus two __syncthreads, on a row that
// sits in shared memory.  The design answers that with one block per window:
// B independent chains run side by side on the SMs, so the card's
// parallelism comes from the batch, while each block keeps its row in
// shared memory (H*4 bytes: 8 KB at N=4096, 128 KB at N=65536) and needs no
// second H-sized buffer.  Round s finds the candidate that comes next after
// round s-1's pick in (score desc, index asc) order, computing scores on
// the fly, so no mask-out array is written.  Rows stop after their own live
// rounds.
//
// Arithmetic that decides: the selection score rint(x*1e4)/1e4, the
// threshold and the width target use explicitly rounded IEEE operations
// (no FMA contraction, IEEE division and sqrt); build without fast math.

#include "detector_common.cuh"

namespace {

using namespace apda;

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__global__ void __launch_bounds__(kMaxThreads)
select_scan_kernel(const float* __restrict__ mags, int h, int m, int* __restrict__ cid,
                   unsigned char* __restrict__ is_cand, float* __restrict__ cmag,
                   float* __restrict__ prom, int* __restrict__ bins,
                   float* __restrict__ std_out, int* __restrict__ ncand_out) {
  extern __shared__ float x[];
  __shared__ Scratch<kMaxWarps> sc;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row = blockIdx.x;
  const float* src = mags + row * (size_t)h;
  for (int i = tid; i < h; i += nt) x[i] = src[i];
  __syncthreads();

  // Threshold: mean + 2*std, ddof=1.
  float sd;
  const float thr = noise_threshold(x, h, sc, &sd);
  auto candidate = [&](int i) { return is_candidate(x, h, i, thr); };
  int c = 0;
  for (int i = tid; i < h; i += nt) c += candidate(i) ? 1 : 0;
  const int n_cand = block_reduce(c, SumI(), sc.i);
  const int live = min(n_cand, m);
  const size_t o = row * (size_t)m;

  Pick prev = {0.f, -1};
  for (int r = 0; r < live; ++r) {
    Pick best = {-INFINITY, h};  // loses to every candidate
    for (int i = tid; i < h; i += nt) {
      if (!candidate(i)) continue;
      const Pick p = {score_of(x[i]), i};
      if ((r == 0 || before(prev, p)) && before(p, best)) best = p;
    }
    best = block_reduce(best, First(), sc.p);
    float pr;
    int bn;
    scan_at(x, h, best.i, x[best.i], sc, &pr, &bn);
    if (tid == 0) {
      cid[o + r] = best.i;
      is_cand[o + r] = 1;
      cmag[o + r] = x[best.i];
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
    prev = best;
  }
  if (live < m) {
    float pr;
    int bn;
    scan_at(x, h, 0, x[0], sc, &pr, &bn);
    for (int r = live + tid; r < m; r += nt) {
      cid[o + r] = 0;
      is_cand[o + r] = 0;
      cmag[o + r] = x[0];
      prom[o + r] = pr;
      bins[o + r] = bn;
    }
  }
  if (tid == 0) {
    std_out[row] = sd;
    ncand_out[row] = n_cand;
  }
}

}  // namespace

extern "C" {

// Launches the kernel over `b` rows of `mags` ([b, h] float32, contiguous)
// on `stream`; outputs are [b, m] slots and [b] per-row values.  Returns the
// cudaError_t of the launch (0 on success).
int apda_prominence_select_scan(const float* mags, int b, int h, int m, int* cid,
                                unsigned char* is_cand, float* cmag, float* prom,
                                int* bins, float* std_out, int* ncand_out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0) return 0;
  int threads = h >= kMaxThreads ? kMaxThreads : ((h + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)h * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(select_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  select_scan_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      mags, h, m, cid, is_cand, cmag, prom, bins, std_out, ncand_out);
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
