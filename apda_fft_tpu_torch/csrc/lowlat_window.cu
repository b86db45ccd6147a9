// One whole window, end to end, in one launch: the single-window latency
// route, for sm_90a.
//
// Replaces the TPU kernels of `analyze_window_lowlat`
// (apda_fft_tpu/ops/latency_pallas.py): `_flex_kernel` (flexible mode) and
// `_rigid_kernel` (rigid mode).  For one float32 window x[0..n), n a power of
// two >= 64, both kernels compute
//   * the half-spectrum magnitudes |X[k]| of the mean-centred window for
//     k < n/2, DC zeroed, in bin order, in shared memory;
//   * the noise threshold mean + 2*std (ddof=1) and the candidates (strict
//     interior local maxima above it);
// and then
//   * flexible: up to `m_budget` picks in the reference's walk order
//     (4-dp-rounded magnitude descending, ties by ascending bin), each with
//     its prominence and -3 dB width, fed in order to the greedy finalize
//     (integer damping band, reference rounding, 5 % shoulder exclusion),
//     which stops at the k-th acceptance; `n_required` as in
//     `prominence_finalize`;
//   * rigid: the destructive Rayleigh greedy (argmax of the current local
//     maxima above the original threshold, raw magnitude, first bin on ties;
//     -3 dB width at 0.707*peak on the current magnitudes; 1.18*|di|/w >= 1.5
//     against every accepted peak; a wipe of round(f*0.02/df) bins each
//     side, taken or not), stopping at k acceptances or when no candidate is
//     left;
//   * the parabolic sub-bin refine on the unwiped magnitudes.
//
// What bounds it on the card: one window gives one thread block (one
// cluster from n = 32768, see below), so the kernel runs on one of the 132
// SMs (eight), and its time is the latency of a chain of stages with
// barriers between them, not bytes (4*n in, a few dozen out) nor
// operations.  Both kernels keep that chain short.
//   * Front end: the FFT of fft_common.cuh (B4's, on the same float64-built
//     twiddle table; the pack subtracts the block-summed mean): log2(n)/3
//     Stockham passes, a barrier each.
//   * Selection, the select+scan kernel's (walk_common.cuh): 32-bin chunk
//     summaries, `noise_threshold` (its two block sums decide the
//     candidates), one compaction into keys and one ranking in rounds of
//     kSlots.
//   * Flexible (B2): the block's warps scan all picks of a round at once,
//     each walking outward from its peak over the chunk summaries (at most
//     two rounds at 32 warps and 64 picks), and after one barrier thread 0
//     runs the finalize over them in walk order, stopping at the k-th
//     acceptance (the scans past the stop change no output).  Picks go in
//     rounds of kSlots, so any budget runs; the route's cap is one round.
//   * Rigid (B3): the candidates are ranked by raw magnitude, and one warp
//     runs the greedy's rounds with no block barrier between them.  A wipe
//     only lowers bins to 0, so an original candidate stays one until it is
//     wiped, and a bin becomes a new candidate only just outside a wiped
//     range, staying one until it is wiped itself: a round's argmax is the
//     better of the ranked list's first unwiped entry and the best of the
//     live "edge" candidates the warp keeps (two a lane).  The wipes zero
//     the magnitudes in place (the refine reads a copy in the free FFT
//     buffer) and the minimum summary of every chunk they touch, so the
//     width is a warp walk over the summaries with the stop v <= 0.707*peak
//     (a wiped bin, 0, always stops it).  The block steps in only to rank
//     the next kSlots list entries and, where the list or the edge set has
//     outgrown its room, to select each round's peak from the row (one
//     block reduction a round).
//   * A list that outgrows its room selects from the row, one block
//     reduction a round, in both kernels.
// Where the arrays live (layout(), a function of n alone).  Up to n = 16384
// one block holds everything in its shared memory: the magnitudes, their
// chunk summaries, the candidate list and the FFT's two exchange buffers.
// From n = 32768 the buffers outgrow a block's 227 KB, and the window runs
// on one thread-block cluster of kClusterSize CTAs instead (the cluster
// kernels):
//   * the buffers are spread over the CTAs' shared memory, point i of a
//     buffer in CTA i % kClusterSize.  CTA r runs the butterflies b = r
//     (mod kClusterSize) of each Stockham pass, whose eight points lie in
//     its own share, so a pass reads only local shared memory, and only the
//     first pass (two at n = 32768) writes to the other CTAs over
//     distributed shared memory: the exchange of a six-step FFT, here in
//     the Stockham order.  Every butterfly, twiddle and operation is the
//     one-block kernels', so the magnitudes are their bits;
//   * CTA 0 takes the mean as the one-block kernels do, and the split
//     writes the magnitudes into CTA 0's shared memory; CTA 0 then runs the
//     one-block kernels' detector unchanged, its summaries and list over
//     its own shares of the spent buffers (n = 65536: 128 KB of magnitudes
//     and 68 KB of shares, 196 KB in all);
//   * the rigid kernel's unwiped copy for the refine goes to the free
//     buffer's shares in CTAs 1-4, and they stay resident until CTA 0 has
//     read the few bins the refine needs.
// So the longest window is n = 65536, whose magnitudes fill most of CTA 0;
// the wrapper allocates nothing but the outputs.

// Arithmetic that decides (threshold, selection score, width targets, the
// finalize's rounding and ratios, the wipe count, the refine) uses explicitly
// rounded IEEE operations; build without fast math.

#include "cluster_common.cuh"
#include "fft_common.cuh"

namespace {

using namespace apda;

// Most threads a block may have; the launch picks the count.
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Picks the flexible kernel scans in one round (the route's budget cap,
// `LOWLAT_MAX_BUDGET`), and ranked list entries the rigid kernel takes in
// one round of ranking.
constexpr int kSlots = 64;
// Accepted rigid peaks whose bins the Rayleigh test reads from shared
// memory (later ones from the output).
constexpr int kAccepted = 64;
// Dynamic shared memory a block may use on Hopper, less the static scratch.
constexpr size_t kSmemCap = 227 * 1024 - 2048;

// Where the kernels' arrays live.  One block: the magnitudes, chunk
// summaries and candidate list, then the FFT's two exchange buffers, all in
// its shared memory.  A cluster, where that outgrows a block: every CTA
// holds its share of both buffers after room for the magnitudes (CTA 0's),
// and CTA 0's summaries and list overlay its shares once the split is done.
struct Layout {
  size_t smem_bytes;  // dynamic shared memory of the block, or of each CTA
  int list_cap;       // keys the candidate list holds: every candidate
  bool cluster;
};

Layout layout(int n) {
  const size_t h = (size_t)n / 2;
  const size_t full = (h / 4 + 2 < (size_t)kMaxList ? h / 4 + 2 : (size_t)kMaxList) & ~(size_t)1;
  const size_t lists = 2 * sizeof(float) * n_chunks((int)h) + 8 * full;
  const size_t fft = 4 * sizeof(float) * (size_t)padded((int)h);
  if (h * sizeof(float) + lists + fft <= kSmemCap) {
    return {h * sizeof(float) + lists + fft, (int)full, false};
  }
  const size_t shares = 2 * sizeof(float2) * (size_t)padded((int)h / kClusterSize);
  return {h * sizeof(float) + (shares > lists ? shares : lists), (int)full, true};
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

// One round of the selection from the row (the route of a candidate list
// that outgrew its room), for the whole block: the candidate after `prev`
// in walk order (the first one when `first`), or {-inf, h} when none is
// left.  One block reduction.  The select+scan kernel runs the same loop
// inline: called from there, it changed that kernel's compiled code and
// slowed it on the H100, though its timed rows never take this route.
template <typename S>
__device__ __forceinline__ Pick next_pick(const float* x, int h, float thr, bool first, Pick prev,
                                          S& sc) {
  Pick best = {-INFINITY, h};  // loses to every candidate
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    if (!is_candidate(x, h, i, thr)) continue;
    const Pick p = {score_of(x[i]), i};
    if ((first || before(prev, p)) && before(p, best)) best = p;
  }
  return block_reduce(best, First(), sc.p);
}

// The finalize's step for one pick (j, cmag) with its scans, on thread 0:
// physics filters, reference rounding and the shoulder test against the
// `count` peaks accepted so far.
__device__ void finalize_pick(Out out, int j, float cmag, float prom, int bins, float ds,
                              float half_sd, int* count) {
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
  for (int s = 0; s < *count; ++s) {
    const float f2 = out.freq[s];
    const float rel = __fdiv_rn(fabsf(__fsub_rn(freq_r, f2)), f2 != 0.f ? f2 : 1.f);
    near = near || rel < 0.05f;
  }
  if (valid && !(near && ratio < 0.10f)) {
    const int c = *count;
    out.idx[c] = j;
    out.freq[c] = freq_r;
    out.mag[c] = mag_r;
    out.prom[c] = prom;
    out.damp[c] = round_dec(__fmul_rn(damping, 100.f), 100.f);
    out.q[c] = round_dec(q, 100.f);
    *count = c + 1;
  }
}

// The flexible kernel's detector, on one block whose shared memory holds the
// magnitudes m[0..h) (from the barrier after the split on), their chunk
// summaries `sm` and the candidate list `keys` (cap keys): the selection,
// the rounds of picks with their scans and finalize, the scalars and the
// refine.  n_listed and s_count are zero.  The cluster kernel's CTA 0 runs
// it; the one-block kernel runs the same steps inline (called from there,
// this function changed that kernel's compiled code: `chip_profile.py
// --sass`).
__device__ __forceinline__ void flexible_detect(const float* m, int h, int n, Summaries sm,
                                                unsigned long long* keys, int cap,
                                                const float* __restrict__ fs, int k,
                                                int m_budget, int refine, Out out,
                                                Scratch<kWarps>& sc, int* s_pick, float* s_prom,
                                                int* s_bins, int& n_listed, int& s_count) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  build_summaries(m, h, sm);  // read after noise_threshold's barriers

  float sd;
  const float thr = noise_threshold(m, h, sc, &sd);
  compact_candidates(m, h, thr, keys, cap, &n_listed);
  __syncthreads();
  const int n_cand = n_listed;
  const int live = min(n_cand, m_budget);
  const float ds = __fdiv_rn(*fs, (float)n);
  const float half_sd = __fmul_rn(0.5f, sd);

  // Rounds of up to kSlots picks: select them, scan them all on the warps,
  // then thread 0 finalizes them in walk order.  Once k peaks are accepted
  // the walk is complete: later picks change nothing.
  int count = 0, consumed = 0;  // thread 0's
  Pick prev = {0.f, -1};
  for (int lo = 0; lo < live; lo += kSlots) {
    const int hi = min(live, lo + kSlots);
    if (n_cand <= cap) {
      rank_picks(keys, n_cand, lo, hi, s_pick);
    } else {
      // The list overflowed: select from the row, one block reduction a
      // round (round r takes the candidate after round r-1's pick).
      for (int r = lo; r < hi; ++r) {
        prev = next_pick(m, h, thr, r == 0, prev, sc);
        if (tid == 0) s_pick[r - lo] = prev.i;
      }
    }
    __syncthreads();
    for (int r = warp; r < hi - lo; r += nwarps) {
      const int j = s_pick[r];
      float pr;
      int bn;
      warp_scan_at(m, h, j, m[j], sm, &pr, &bn);
      if ((tid & 31) == 0) {
        s_prom[r] = pr;
        s_bins[r] = bn;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < hi - lo && count < k; ++r) {
        ++consumed;
        finalize_pick(out, s_pick[r], m[s_pick[r]], s_prom[r], s_bins[r], ds, half_sd, &count);
      }
      s_count = count;
    }
    __syncthreads();
    if (s_count >= k) break;
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

// The one-block kernels take `ws` and `fft_smem` as they always have: the
// launch passes null and true, every window they take keeping its exchange
// buffers in shared memory.
__global__ void __launch_bounds__(kThreads)
lowlat_flexible_kernel(const float* __restrict__ x, int n, const float2* __restrict__ tw,
                       const float* __restrict__ fs, int k, int m_budget, int refine,
                       int* iout, float* fout, float2* ws, int cap, bool fft_smem) {
  extern __shared__ __align__(16) float flex_smem[];
  __shared__ Scratch<kWarps> sc;
  __shared__ int s_pick[kSlots];
  __shared__ float s_prom[kSlots];
  __shared__ int s_bins[kSlots];
  __shared__ int n_listed, s_count;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int h = n / 2;
  float* m = flex_smem;
  const Summaries sm = {m + h, m + h + n_chunks(h)};
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(m + h + 2 * n_chunks(h));
  float2* a = fft_smem ? reinterpret_cast<float2*>(keys + cap) : ws;
  float2* c = a + padded(h);
  const Out out = outputs(iout, fout, k);
  if (tid == 0) {
    n_listed = 0;
    s_count = 0;
  }

  // Front end: the mean (a block sum), the centred pack of the h complex
  // points, the FFT, the split into the magnitudes.
  float total = 0.f;
  for (int i = tid; i < n; i += nt) total = __fadd_rn(total, x[i]);
  total = block_reduce(total, SumF(), sc.f);
  pack_row<true>(x, __fdiv_rn(total, (float)n), a, h, tid, nt);
  __syncthreads();
  fft_passes(a, c, h, tid, nt, tw);
  split_mags(a, tw, m, h, tid, nt);
  __syncthreads();
  build_summaries(m, h, sm);  // read after noise_threshold's barriers

  float sd;
  const float thr = noise_threshold(m, h, sc, &sd);
  compact_candidates(m, h, thr, keys, cap, &n_listed);
  __syncthreads();
  const int n_cand = n_listed;
  const int live = min(n_cand, m_budget);
  const float ds = __fdiv_rn(*fs, (float)n);
  const float half_sd = __fmul_rn(0.5f, sd);

  // Rounds of up to kSlots picks: select them, scan them all on the warps,
  // then thread 0 finalizes them in walk order.  Once k peaks are accepted
  // the walk is complete: later picks change nothing.
  int count = 0, consumed = 0;  // thread 0's
  Pick prev = {0.f, -1};
  for (int lo = 0; lo < live; lo += kSlots) {
    const int hi = min(live, lo + kSlots);
    if (n_cand <= cap) {
      rank_picks(keys, n_cand, lo, hi, s_pick);
    } else {
      // The list overflowed: select from the row, one block reduction a
      // round (round r takes the candidate after round r-1's pick).
      for (int r = lo; r < hi; ++r) {
        prev = next_pick(m, h, thr, r == 0, prev, sc);
        if (tid == 0) s_pick[r - lo] = prev.i;
      }
    }
    __syncthreads();
    for (int r = warp; r < hi - lo; r += nwarps) {
      const int j = s_pick[r];
      float pr;
      int bn;
      warp_scan_at(m, h, j, m[j], sm, &pr, &bn);
      if ((tid & 31) == 0) {
        s_prom[r] = pr;
        s_bins[r] = bn;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < hi - lo && count < k; ++r) {
        ++consumed;
        finalize_pick(out, s_pick[r], m[s_pick[r]], s_prom[r], s_bins[r], ds, half_sd, &count);
      }
      s_count = count;
    }
    __syncthreads();
    if (s_count >= k) break;
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

// The rigid kernel's list key: ascending keys are raw magnitudes descending,
// bins ascending.  A candidate lies above a threshold >= 0, so its bits
// order as an unsigned integer.
__device__ __forceinline__ unsigned long long rigid_key(float v, int i) {
  return ((unsigned long long)(~__float_as_uint(v)) << 32) | (unsigned)i;
}

// What the rigid kernel's block does when warp 0's rounds stop.
enum Next : int { kDone, kNextBatch, kFromRow };

// The rigid kernel's detector, on one block whose shared memory holds the
// magnitudes w[0..h) (from the barrier after the split on), their chunk
// summaries `sm` and the candidate list `keys` (cap keys): the selection,
// the greedy, which wipes w in place, and the scalars; returns the bin
// width fs/n for the refine.  n_listed is zero.  The cluster kernel's CTA 0
// runs it; the one-block kernel runs the same steps inline, as the flexible
// one does.
__device__ __forceinline__ float rigid_detect(float* w, int h, int n, Summaries sm,
                                              unsigned long long* keys, int cap,
                                              const float* __restrict__ fs, int k, Out out,
                                              Scratch<kWarps>& sc, int* s_pick, int* s_acc,
                                              int& n_listed, int& s_next) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  build_summaries(w, h, sm);  // read after noise_threshold's barriers

  float sd;
  const float thr = noise_threshold(w, h, sc, &sd);
  compact_candidates(w, h, thr, keys, cap, &n_listed);
  __syncthreads();
  const int n_cand = n_listed;
  // Rigid mode ranks by the raw magnitude: the keys get it in place of the
  // rounded score.
  for (int q = tid; q < min(n_cand, cap); q += nt) {
    const int i = (int)(keys[q] & 0xffffffffu);
    keys[q] = rigid_key(w[i], i);
  }
  __syncthreads();
  const float ds = __fdiv_rn(*fs, (float)n);

  // The greedy.  Warp 0 runs the rounds; the block ranks the next kSlots
  // list entries when warp 0 has passed the last ones, or, once the list or
  // the edge set has outgrown its room, selects each round's peak from the
  // row.  Warp 0's state: the acceptances, the rank p of the list's first
  // entry not yet known to be wiped, and the edge candidates (lane l holds
  // slots l and l + 32; -1 is free).
  bool from_row = n_cand > cap;
  int lo = 0;  // rank of s_pick[0]
  int count = 0, p = 0, edge0 = -1, edge1 = -1;
  while (true) {
    Pick row = {-INFINITY, h};  // loses to every candidate
    if (from_row) {
      for (int i = tid; i < h; i += nt) {
        if (!is_candidate(w, h, i, thr)) continue;
        const Pick q = {w[i], i};
        if (before(q, row)) row = q;
      }
      row = block_reduce(row, First(), sc.p);
    } else {
      rank_picks(keys, n_cand, lo, min(n_cand, lo + kSlots), s_pick);
      __syncthreads();
    }
    if (tid < 32) {
      Next next = kDone;
      while (true) {
        Pick best = row;
        if (!from_row) {
          // The list's first entry still a candidate (a wipe is the only
          // way an original candidate stops being one), 32 ranks a ballot.
          const int hi = min(n_cand, lo + kSlots);
          while (p < hi) {
            const int r = p + lane;
            const unsigned live =
                __ballot_sync(kFull, r < hi && is_candidate(w, h, s_pick[r - lo], thr));
            if (live) {
              p += __ffs(live) - 1;
              break;
            }
            p = min(p + 32, hi);
          }
          if (p == hi && hi < n_cand) {
            next = kNextBatch;
            break;
          }
          if (p < hi) best = {w[s_pick[p - lo]], s_pick[p - lo]};
          if (__any_sync(kFull, edge0 >= 0 || edge1 >= 0)) {
            Pick e = {-INFINITY, h};
            if (edge0 >= 0) e = {w[edge0], edge0};
            if (edge1 >= 0 && before(Pick{w[edge1], edge1}, e)) e = {w[edge1], edge1};
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) e = First()(e, shfl(e, o));
            if (before(e, best)) best = e;
          }
        }
        if (best.i >= h) break;  // no candidate left
        const int j = best.i;
        const float peak = best.s;
        // The wipe: round(f*0.02/df) bins each side, taken or not.  Clamped
        // so that a round always wipes its own bin; only a rate that is not
        // positive and finite reaches the clamp.
        const int nd = min(max(discard_count(__fmul_rn((float)j, ds), ds), 0), h);
        const int start = max(0, j - nd);
        const int end = min(h, j + nd + 1);
        // -3 dB width on the current magnitudes: the nearest bin at or
        // below 0.707*peak on each side, j included (left defaults to 0,
        // right to h).
        const float half = __fmul_rn(0.707f, peak);
        const auto low = [half](float v) { return v <= half; };
        const auto chunk_low = [half](float cmin, float) { return cmin <= half; };
        const int st_a = warp_walk<-1, false>(w, h, j, low, chunk_low, sm, nullptr);
        const int st_b = warp_walk<1, false>(w, h, j, low, chunk_low, sm, nullptr);
        // Accepted peaks' own widths are 0 on the wiped spectrum, so the
        // Rayleigh term is 1.18*|di|/w_new against each of them.
        const float w_new = (float)((st_b < 0 ? h : st_b) - max(st_a, 0));
        bool separated = true;
        for (int s = lane; s < count; s += 32) {
          const float di = (float)abs((s < kAccepted ? s_acc[s] : out.idx[s]) - j);
          const float rs = w_new != 0.f ? __fdiv_rn(__fmul_rn(1.18f, di), w_new) : 0.f;
          separated = separated && rs >= 1.5f;
        }
        if (__all_sync(kFull, separated)) {
          if (lane == 0) {
            if (count < kAccepted) s_acc[count] = j;
            out.idx[count] = j;
            out.freq[count] = __fmul_rn((float)j, ds);
            out.mag[count] = peak;
          }
          ++count;
        }
        // Wipe, and zero the minimum summary of every chunk the wipe touches.
        for (int i = start + lane; i < end; i += 32) w[i] = 0.f;
        for (int cc = (start >> 5) + lane; cc <= (end - 1) >> 5; cc += 32) sm.min[cc] = 0.f;
        __syncwarp();
        if (count >= k) break;
        if (from_row) {
          next = kFromRow;
          break;
        }
        // Free the edge slots the wipe took, then keep the bins just
        // outside it that are candidates now.
        if (edge0 >= 0 && !is_candidate(w, h, edge0, thr)) edge0 = -1;
        if (edge1 >= 0 && !is_candidate(w, h, edge1, thr)) edge1 = -1;
        bool full = false;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int b = side == 0 ? start - 1 : end;
          if (!is_candidate(w, h, b, thr) || __any_sync(kFull, edge0 == b || edge1 == b)) continue;
          const unsigned free0 = __ballot_sync(kFull, edge0 < 0);
          const unsigned free1 = __ballot_sync(kFull, edge1 < 0);
          if (free0) {
            if (lane == __ffs(free0) - 1) edge0 = b;
          } else if (free1) {
            if (lane == __ffs(free1) - 1) edge1 = b;
          } else {
            full = true;
          }
        }
        if (full) {
          next = kFromRow;
          break;
        }
      }
      if (tid == 0) s_next = next;
    }
    __syncthreads();
    const int next = s_next;
    if (next == kDone) break;
    if (next == kNextBatch) {
      lo += kSlots;
    } else {
      from_row = true;
    }
  }
  if (tid == 0) {
    out.scalars[0] = count;
    out.scalars[1] = n_cand;
    out.scalars[2] = 0;  // rigid mode has no budget
  }
  __syncthreads();
  return ds;
}

__global__ void __launch_bounds__(kThreads)
lowlat_rigid_kernel(const float* __restrict__ x, int n, const float2* __restrict__ tw,
                    const float* __restrict__ fs, int k, int refine, int* iout, float* fout,
                    float2* ws, int cap, bool fft_smem) {
  extern __shared__ __align__(16) float rigid_smem[];
  __shared__ Scratch<kWarps> sc;
  __shared__ int s_pick[kSlots];
  __shared__ int s_acc[kAccepted];
  __shared__ int n_listed, s_next;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int h = n / 2;
  float* w = rigid_smem;  // the magnitudes, wiped in place by the greedy
  const Summaries sm = {w + h, w + h + n_chunks(h)};
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(w + h + 2 * n_chunks(h));
  float2* a = fft_smem ? reinterpret_cast<float2*>(keys + cap) : ws;
  float2* c = a + padded(h);
  const Out out = outputs(iout, fout, k);
  if (tid == 0) n_listed = 0;

  // Front end, as the flexible kernel's: the mean, the centred pack, the
  // FFT, the split into the magnitudes.
  float total = 0.f;
  for (int i = tid; i < n; i += nt) total = __fadd_rn(total, x[i]);
  total = block_reduce(total, SumF(), sc.f);
  pack_row<true>(x, __fdiv_rn(total, (float)n), a, h, tid, nt);
  __syncthreads();
  fft_passes(a, c, h, tid, nt, tw);
  split_mags(a, tw, w, h, tid, nt);
  __syncthreads();
  // The unwiped magnitudes, for the refine, in the free exchange buffer.
  float* m = reinterpret_cast<float*>(c);
  for (int i = tid; i < h; i += nt) m[i] = w[i];
  build_summaries(w, h, sm);  // read after noise_threshold's barriers

  float sd;
  const float thr = noise_threshold(w, h, sc, &sd);
  compact_candidates(w, h, thr, keys, cap, &n_listed);
  __syncthreads();
  const int n_cand = n_listed;
  // Rigid mode ranks by the raw magnitude: the keys get it in place of the
  // rounded score.
  for (int q = tid; q < min(n_cand, cap); q += nt) {
    const int i = (int)(keys[q] & 0xffffffffu);
    keys[q] = rigid_key(w[i], i);
  }
  __syncthreads();
  const float ds = __fdiv_rn(*fs, (float)n);

  // The greedy.  Warp 0 runs the rounds; the block ranks the next kSlots
  // list entries when warp 0 has passed the last ones, or, once the list or
  // the edge set has outgrown its room, selects each round's peak from the
  // row.  Warp 0's state: the acceptances, the rank p of the list's first
  // entry not yet known to be wiped, and the edge candidates (lane l holds
  // slots l and l + 32; -1 is free).
  bool from_row = n_cand > cap;
  int lo = 0;  // rank of s_pick[0]
  int count = 0, p = 0, edge0 = -1, edge1 = -1;
  while (true) {
    Pick row = {-INFINITY, h};  // loses to every candidate
    if (from_row) {
      for (int i = tid; i < h; i += nt) {
        if (!is_candidate(w, h, i, thr)) continue;
        const Pick q = {w[i], i};
        if (before(q, row)) row = q;
      }
      row = block_reduce(row, First(), sc.p);
    } else {
      rank_picks(keys, n_cand, lo, min(n_cand, lo + kSlots), s_pick);
      __syncthreads();
    }
    if (tid < 32) {
      Next next = kDone;
      while (true) {
        Pick best = row;
        if (!from_row) {
          // The list's first entry still a candidate (a wipe is the only
          // way an original candidate stops being one), 32 ranks a ballot.
          const int hi = min(n_cand, lo + kSlots);
          while (p < hi) {
            const int r = p + lane;
            const unsigned live =
                __ballot_sync(kFull, r < hi && is_candidate(w, h, s_pick[r - lo], thr));
            if (live) {
              p += __ffs(live) - 1;
              break;
            }
            p = min(p + 32, hi);
          }
          if (p == hi && hi < n_cand) {
            next = kNextBatch;
            break;
          }
          if (p < hi) best = {w[s_pick[p - lo]], s_pick[p - lo]};
          if (__any_sync(kFull, edge0 >= 0 || edge1 >= 0)) {
            Pick e = {-INFINITY, h};
            if (edge0 >= 0) e = {w[edge0], edge0};
            if (edge1 >= 0 && before(Pick{w[edge1], edge1}, e)) e = {w[edge1], edge1};
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) e = First()(e, shfl(e, o));
            if (before(e, best)) best = e;
          }
        }
        if (best.i >= h) break;  // no candidate left
        const int j = best.i;
        const float peak = best.s;
        // The wipe: round(f*0.02/df) bins each side, taken or not.  Clamped
        // so that a round always wipes its own bin; only a rate that is not
        // positive and finite reaches the clamp.
        const int nd = min(max(discard_count(__fmul_rn((float)j, ds), ds), 0), h);
        const int start = max(0, j - nd);
        const int end = min(h, j + nd + 1);
        // -3 dB width on the current magnitudes: the nearest bin at or
        // below 0.707*peak on each side, j included (left defaults to 0,
        // right to h).
        const float half = __fmul_rn(0.707f, peak);
        const auto low = [half](float v) { return v <= half; };
        const auto chunk_low = [half](float cmin, float) { return cmin <= half; };
        const int st_a = warp_walk<-1, false>(w, h, j, low, chunk_low, sm, nullptr);
        const int st_b = warp_walk<1, false>(w, h, j, low, chunk_low, sm, nullptr);
        // Accepted peaks' own widths are 0 on the wiped spectrum, so the
        // Rayleigh term is 1.18*|di|/w_new against each of them.
        const float w_new = (float)((st_b < 0 ? h : st_b) - max(st_a, 0));
        bool separated = true;
        for (int s = lane; s < count; s += 32) {
          const float di = (float)abs((s < kAccepted ? s_acc[s] : out.idx[s]) - j);
          const float rs = w_new != 0.f ? __fdiv_rn(__fmul_rn(1.18f, di), w_new) : 0.f;
          separated = separated && rs >= 1.5f;
        }
        if (__all_sync(kFull, separated)) {
          if (lane == 0) {
            if (count < kAccepted) s_acc[count] = j;
            out.idx[count] = j;
            out.freq[count] = __fmul_rn((float)j, ds);
            out.mag[count] = peak;
          }
          ++count;
        }
        // Wipe, and zero the minimum summary of every chunk the wipe touches.
        for (int i = start + lane; i < end; i += 32) w[i] = 0.f;
        for (int cc = (start >> 5) + lane; cc <= (end - 1) >> 5; cc += 32) sm.min[cc] = 0.f;
        __syncwarp();
        if (count >= k) break;
        if (from_row) {
          next = kFromRow;
          break;
        }
        // Free the edge slots the wipe took, then keep the bins just
        // outside it that are candidates now.
        if (edge0 >= 0 && !is_candidate(w, h, edge0, thr)) edge0 = -1;
        if (edge1 >= 0 && !is_candidate(w, h, edge1, thr)) edge1 = -1;
        bool full = false;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int b = side == 0 ? start - 1 : end;
          if (!is_candidate(w, h, b, thr) || __any_sync(kFull, edge0 == b || edge1 == b)) continue;
          const unsigned free0 = __ballot_sync(kFull, edge0 < 0);
          const unsigned free1 = __ballot_sync(kFull, edge1 < 0);
          if (free0) {
            if (lane == __ffs(free0) - 1) edge0 = b;
          } else if (free1) {
            if (lane == __ffs(free1) - 1) edge1 = b;
          } else {
            full = true;
          }
        }
        if (full) {
          next = kFromRow;
          break;
        }
      }
      if (tid == 0) s_next = next;
    }
    __syncthreads();
    const int next = s_next;
    if (next == kDone) break;
    if (next == kNextBatch) {
      lo += kSlots;
    } else {
      from_row = true;
    }
  }
  if (tid == 0) {
    out.scalars[0] = count;
    out.scalars[1] = n_cand;
    out.scalars[2] = 0;  // rigid mode has no budget
  }
  __syncthreads();
  for (int s = tid; s < k; s += nt) out.refined[s] = refine ? refine_slot(m, h, out.idx[s], ds) : 0.f;
}

// ------------------------------------------------------- cluster kernels

static_assert(kClusterSize == 8, "the spread buffers place point i in CTA i % 8");

// Point i of an exchange buffer spread over the cluster lies in CTA i % 8,
// at slot pad(i / 8) of that CTA's share p (every CTA's share at the same
// offset).  `Own` is this CTA's share, for the points i = rank (mod 8);
// `Spread` reaches any CTA's over distributed shared memory.
struct Own {
  float2* p;
  __device__ __forceinline__ float2& operator[](int i) const { return p[pad(i >> 3)]; }
};
struct Spread {
  float2* p;
  __device__ __forceinline__ float2& operator[](int i) const {
    return *cg::this_cluster().map_shared_rank(p + pad(i >> 3), i & 7);
  }
};

// The Stockham passes of fft_passes over buffers spread over the cluster.
// CTA `rank` takes the butterflies b = rank (mod 8), whose points b + r*l/R
// all lie in its own share; a pass with ns >= 8 writes its outputs there
// too (d + r*ns = b (mod 8)), and only the first pass or two (ns < 8) write
// to the other CTAs.  A pass ends with a cluster barrier where its writes
// or the next pass's leave the CTA, or where it is the last (the split
// reads every share), else with a block barrier.  The caller has passed a
// cluster barrier after the pack; on return a holds Z.
__device__ __forceinline__ void cluster_fft(float2*& a, float2*& c, int l, int rank,
                                            const float2* __restrict__ t) {
  cg::cluster_group cluster = cg::this_cluster();
  const int first = rank + kClusterSize * (int)threadIdx.x;
  const int stride = kClusterSize * (int)blockDim.x;
  int ns = 1;
  const int rem = (31 - __clz(l)) % 3;
  if (rem != 0) {
    if (rem == 1) {
      stockham_pass<2>(Own{a}, Spread{c}, l, ns, first, stride, t);
    } else {
      stockham_pass<4>(Own{a}, Spread{c}, l, ns, first, stride, t);
    }
    ns <<= rem;
    float2* s = a;
    a = c;
    c = s;
    cluster.sync();
  }
  for (; ns < l; ns *= 8) {
    if (ns >= 8) {
      stockham_pass<8>(Own{a}, Own{c}, l, ns, first, stride, t);
    } else {
      stockham_pass<8>(Own{a}, Spread{c}, l, ns, first, stride, t);
    }
    float2* s = a;
    a = c;
    c = s;
    if (ns < 8 || 8 * ns >= l) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
}

// The cluster kernels' front end, on every CTA: CTA 0 takes the window's
// mean as the one-block kernels do (a block sum at blockDim.x threads, the
// same bits), every CTA packs a slice of the centred points into their
// CTAs' shares and runs the passes.  The shares of the two buffers lie at
// `shares` in every CTA.  On return a holds Z, c is free, and a cluster
// barrier has passed.
__device__ __forceinline__ void cluster_transform(const float* __restrict__ x, int n,
                                                  const float2* __restrict__ tw, float2* shares,
                                                  float2*& a, float2*& c, float* s_mean,
                                                  Scratch<kWarps>& sc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int h = n / 2;
  if (rank == 0) {
    float total = 0.f;
    for (int i = tid; i < n; i += nt) total = __fadd_rn(total, x[i]);
    total = block_reduce(total, SumF(), sc.f);
    if (tid == 0) *s_mean = __fdiv_rn(total, (float)n);
  }
  a = shares;
  c = a + padded(h / kClusterSize);
  cluster.sync();
  pack_points<true>(x, *cluster.map_shared_rank(s_mean, 0), Spread{a}, h, rank * nt + tid,
                    kClusterSize * nt);
  cluster.sync();
  cluster_fft(a, c, h, rank, tw);
}

// The rigid cluster kernel's copy of the unwiped magnitudes: bin i in the
// free buffer's share of CTA 1 + i / (h/4), which holds h/4 floats and
// more.
struct UnwipedCopy {
  float* share;  // the free buffer's share, as floats
  int shift;     // log2(h/4)
  __device__ __forceinline__ float* at(int i) const {
    return cg::this_cluster().map_shared_rank(share + (i & ((1 << shift) - 1)), 1 + (i >> shift));
  }
};

// Where the rigid cluster kernel's split puts bin k's magnitude: CTA 0's
// array and the unwiped copy.
struct MagsAndCopy {
  float* m0;
  UnwipedCopy copy;
  struct Slot {
    float* a;
    float* b;
    __device__ __forceinline__ void operator=(float v) const {
      *a = v;
      *b = v;
    }
  };
  __device__ __forceinline__ Slot operator[](int k) const { return {m0 + k, copy.at(k)}; }
};

// The flexible kernel for a window whose FFT buffers outgrow a block (n >=
// 32768): one cluster of kClusterSize CTAs.  All CTAs run the front end
// (cluster_transform, then the split into CTA 0's shared memory); CTA 0
// then runs the one-block kernel's detector, the others leave.
__global__ void __launch_bounds__(kThreads)
lowlat_flexible_cluster_kernel(const float* __restrict__ x, int n, const float2* __restrict__ tw,
                               const float* __restrict__ fs, int k, int m_budget, int refine,
                               int* iout, float* fout, int cap) {
  extern __shared__ __align__(16) float flex_smem[];
  __shared__ Scratch<kWarps> sc;
  __shared__ int s_pick[kSlots];
  __shared__ float s_prom[kSlots];
  __shared__ int s_bins[kSlots];
  __shared__ int n_listed, s_count;
  __shared__ float s_mean;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int h = n / 2;
  float* m = flex_smem;  // CTA 0's magnitudes
  if (tid == 0) {
    n_listed = 0;
    s_count = 0;
  }
  float2 *a, *c;
  cluster_transform(x, n, tw, reinterpret_cast<float2*>(m + h), a, c, &s_mean, sc);
  split_points(Spread{a}, tw, cluster.map_shared_rank(m, 0), h, rank * nt + tid,
               kClusterSize * nt);
  cluster.sync();  // the magnitudes are in CTA 0; no CTA reads another's from here on
  if (rank != 0) return;
  // CTA 0's summaries and list overlay its own shares, spent.
  const Summaries sm = {m + h, m + h + n_chunks(h)};
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(m + h + 2 * n_chunks(h));
  flexible_detect(m, h, n, sm, keys, cap, fs, k, m_budget, refine, outputs(iout, fout, k), sc,
                  s_pick, s_prom, s_bins, n_listed, s_count);
}

// The rigid kernel for n >= 32768, on one cluster as the flexible one: the
// split also copies the magnitudes to CTAs 1-4 (UnwipedCopy), CTA 0 runs
// the one-block kernel's detector and greedy, puts back the unwiped bins
// the refine reads, and a last cluster barrier keeps CTAs 1-4 resident
// until then.
__global__ void __launch_bounds__(kThreads)
lowlat_rigid_cluster_kernel(const float* __restrict__ x, int n, const float2* __restrict__ tw,
                            const float* __restrict__ fs, int k, int refine, int* iout,
                            float* fout, int cap) {
  extern __shared__ __align__(16) float rigid_smem[];
  __shared__ Scratch<kWarps> sc;
  __shared__ int s_pick[kSlots];
  __shared__ int s_acc[kAccepted];
  __shared__ int n_listed, s_next;
  __shared__ float s_mean;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int h = n / 2;
  float* w = rigid_smem;  // CTA 0's magnitudes, wiped in place by the greedy
  if (tid == 0) n_listed = 0;
  float2 *a, *c;
  cluster_transform(x, n, tw, reinterpret_cast<float2*>(w + h), a, c, &s_mean, sc);
  const UnwipedCopy copy = {reinterpret_cast<float*>(c), 29 - __clz(h)};  // h/4 = 2^shift
  split_points(Spread{a}, tw, MagsAndCopy{cluster.map_shared_rank(w, 0), copy}, h,
               rank * nt + tid, kClusterSize * nt);
  cluster.sync();  // the magnitudes are in CTA 0, the copy in CTAs 1-4
  if (rank == 0) {
    const Summaries sm = {w + h, w + h + n_chunks(h)};
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(w + h + 2 * n_chunks(h));
    const Out out = outputs(iout, fout, k);
    const float ds = rigid_detect(w, h, n, sm, keys, cap, fs, k, out, sc, s_pick, s_acc,
                                  n_listed, s_next);
    // The refine reads bins s-1, s, s+1 of each slot's peak unwiped: put
    // them back from the copy (the greedy is done with w).
    for (int s = tid; s < k && refine; s += nt) {
      const int idx = out.idx[s];
      if (idx < 0) continue;
      const int b = min(max(idx, 1), h - 2);
      for (int i = b - 1; i <= b + 1; ++i) w[i] = *copy.at(i);
    }
    __syncthreads();
    for (int s = tid; s < k; s += nt) out.refined[s] = refine ? refine_slot(w, h, out.idx[s], ds) : 0.f;
  }
  cluster.sync();  // CTAs 1-4 hold the copy until CTA 0 is done with it
}

}  // namespace

extern "C" {

// Dynamic shared memory of the block, or of each CTA of the cluster, of a
// launch at window length n (the wrapper's message when a cluster cannot
// be placed).
long long apda_lowlat_smem_bytes(int n) { return (long long)layout(n).smem_bytes; }

// Analyses the window x ([n] float32, contiguous, 16-byte aligned) on
// `stream` with `threads` threads a block (a multiple of 32, at most 1024),
// in rigid mode or flexible mode at budget m_budget, against the twiddle
// table `_twiddle_table(n)` ([n/2] float2).  fs is a 1-element device
// float.  Outputs: iout [k + 3] int32, fout [6*k] float32 (layout at
// `Out`).  Windows whose FFT buffers outgrow a block (n >= 32768) take the
// cluster kernels.  Returns the cudaError_t of the launch (0 on success),
// or kClusterNotPlaced when the device cannot place one cluster.
int apda_lowlat_window(int rigid, const float* x, int n, const float* twiddle, const float* fs,
                       int k, int m_budget, int refine, int* iout, float* fout, int threads,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layout l = layout(n);
  if (l.smem_bytes > kSmemCap || k < 1 || threads < 32 || threads > kThreads ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  if (l.cluster) {
    static size_t checked[2][64];
    if (rigid) {
      return launch_clusters(lowlat_rigid_cluster_kernel, kClusterSize, threads, l.smem_bytes, s,
                             device, checked[1], x, n, tw, fs, k, refine, iout, fout,
                             l.list_cap);
    }
    return launch_clusters(lowlat_flexible_cluster_kernel, kClusterSize, threads, l.smem_bytes,
                           s, device, checked[0], x, n, tw, fs, k, m_budget, refine, iout, fout,
                           l.list_cap);
  }
  // Dynamic plus static shared memory past 48 KB needs the opt-in, once per
  // kernel and device for the largest size asked so far.
  static size_t opted_in[2][64];
  size_t* opted = device >= 0 && device < 64 ? &opted_in[rigid ? 1 : 0][device] : nullptr;
  if (opted == nullptr || l.smem_bytes > *opted) {
    err = rigid ? cudaFuncSetAttribute(lowlat_rigid_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)l.smem_bytes)
                : cudaFuncSetAttribute(lowlat_flexible_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)l.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (opted != nullptr) *opted = l.smem_bytes;
  }
  if (rigid) {
    lowlat_rigid_kernel<<<1, threads, l.smem_bytes, s>>>(x, n, tw, fs, k, refine, iout, fout,
                                                         nullptr, l.list_cap, true);
  } else {
    lowlat_flexible_kernel<<<1, threads, l.smem_bytes, s>>>(
        x, n, tw, fs, k, m_budget, refine, iout, fout, nullptr, l.list_cap, true);
  }
  return (int)cudaGetLastError();
}

const char* apda_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
