// apda_io: native host-side data-loader kernels for apda_fft_tpu.
//
// The gateway's host hot path is pure string/byte churn: decoding binary16
// radio payloads (reference protocol_decoder.py:116-175), rendering samples
// as "%8.6f" log-file tokens, and parsing those tokens back for analysis
// (reference utils/load_data.py:67-77).  The reference does all of this one
// value at a time in interpreted Python; these C implementations process
// whole payloads/files per call and are loaded via ctypes (no pybind11 in
// this image).
//
// Semantics match apda_fft_tpu.io.halffloat exactly, including the reference
// quirks: truncated subnormal constant 0.00006103515 (not 2^-14) and +inf
// regardless of sign bit.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unistd.h>

// One binary16 word with the reference quirks (truncated subnormal scale,
// +inf regardless of sign bit) - shared by the decode and fused-append paths.
static inline double decode_half_word(uint16_t w) {
  const int exp = (w >> 10) & 0x1F;
  const double sign = (w & 0x8000) ? -1.0 : 1.0;
  const double mant = (double)(w & 0x03FF) / 1024.0;
  if (exp == 31) return (mant != 0.0) ? NAN : INFINITY;  // +inf even if signed
  if (exp == 0) return (mant != 0.0) ? sign * 0.00006103515 * mant : 0.0;
  return sign * ldexp(1.0 + mant, exp - 15);
}

// Fast exact "%8.6f" formatter.
//
// glibc's snprintf("%8.6f") measures ~790 ns/value on this host (the
// arbitrary-precision decimal path) and dominated the fused ingest call.
// This renders the correctly-rounded 6-decimal fixed representation of a
// finite double exactly - same output as snprintf/Python format - using
// unsigned __int128 integer arithmetic, falling back to snprintf outside
// its range (|v| >= 2^63/1e6, non-finite, deep subnormals).
//
// Exactness: a finite double is m * 2^e (m < 2^53 integer).  The 6-decimal
// value is round_half_even(m * 10^6 * 2^e).  m * 10^6 < 2^73 fits __int128
// exactly; for e <= 0 the quotient/remainder by 2^-e gives the exact
// integer part and an exact tie comparison (2r vs 2^-e), for e > 0 the
// product is exact while it fits.  Ties round to even, matching IEEE-754
// correctly-rounded conversions (glibc and CPython both implement this).
//
// When q_out is non-null it also receives the QUANTIZED value - the double
// a correctly-rounded parse of the rendered decimal would return.  For
// ip < 2^53 both ip and 1e6 are exact doubles, so IEEE division ip/1e6 is
// the correctly-rounded value of the rational ip/10^6, i.e. exactly what
// strtod("w.ffffff") computes - no string re-parse needed.  (Larger ip
// falls back to strtod in the caller; binary16-derived samples never get
// there.)  NAN signals "caller must strtod".
//
// Returns bytes written (no NUL), or -1 if the fast path does not apply.
static long format_fixed6_fast(double v, char* out, long cap, double* q_out) {
  if (!std::isfinite(v)) return -1;
  const double a = std::fabs(v);
  if (a >= 9.2e12) return -1;  // v * 1e6 near 2^63: snprintf handles it
  if (cap < 32) return -1;     // max len: sign + 13 digits + '.' + 6 + ';'

  int e;
  const double frac = std::frexp(a, &e);  // a = frac * 2^e, frac in [0.5, 1)
  // m = frac * 2^53 exactly (53-bit significand, integer for normals;
  // subnormals also exact: frexp renormalizes them).
  const uint64_t m = (uint64_t)std::ldexp(frac, 53);
  const int e2 = e - 53;  // a = m * 2^e2
  unsigned __int128 scaled = (unsigned __int128)m * 1000000u;
  uint64_t ip;  // rounded integer value of a * 1e6
  if (e2 >= 0) {
    if (e2 > 50) return -1;  // cannot happen with a < 9.2e12, be safe
    ip = (uint64_t)(scaled << e2);
  } else {
    const int s = -e2;
    if (s >= 120) {
      // a < 2^-47-ish: far below 5e-7, rounds to 0.000000
      ip = 0;
    } else {
      const unsigned __int128 q = scaled >> s;
      const unsigned __int128 r = scaled - (q << s);
      const unsigned __int128 half = (unsigned __int128)1 << (s - 1);
      ip = (uint64_t)q;
      if (r > half || (r == half && (ip & 1))) ++ip;  // ties to even
    }
  }
  if (q_out) {
    *q_out = (ip < (1ull << 53))
                 ? (std::signbit(v) ? -((double)ip / 1e6) : (double)ip / 1e6)
                 : NAN;  // not exactly divisible: caller re-parses the token
  }
  const uint64_t whole = ip / 1000000u;
  const uint64_t fracd = ip % 1000000u;
  char* p = out;
  if (std::signbit(v)) *p++ = '-';
  // whole part (up to 13 digits)
  char tmp[20];
  int nt = 0;
  uint64_t w = whole;
  do {
    tmp[nt++] = (char)('0' + (w % 10));
    w /= 10;
  } while (w);
  while (nt) *p++ = tmp[--nt];
  *p++ = '.';
  // exactly 6 fraction digits
  p[5] = (char)('0' + fracd % 10u);
  p[4] = (char)('0' + (fracd / 10u) % 10u);
  p[3] = (char)('0' + (fracd / 100u) % 10u);
  p[2] = (char)('0' + (fracd / 1000u) % 10u);
  p[1] = (char)('0' + (fracd / 10000u) % 10u);
  p[0] = (char)('0' + (fracd / 100000u) % 10u);
  p += 6;
  // "%8.6f" width: every finite rendering is >= 8 chars ("0.000000"), so
  // no padding is ever emitted on this path.
  return (long)(p - out);
}

// One "%8.6f;" token: fast path, else snprintf.  Returns bytes written or
// -1 on overflow (mirrors apda_format_samples' contract).  q_out (optional)
// receives the quantized value, NAN meaning "re-parse the token" (snprintf
// path or ip >= 2^53).
static long format_token(double v, char* out, long cap, double* q_out = nullptr) {
  long k = format_fixed6_fast(v, out, cap, q_out);
  if (k >= 0) {
    if (k + 1 > cap) return -1;
    out[k] = ';';
    return k + 1;
  }
  if (q_out) *q_out = NAN;
  const int w = snprintf(out, (size_t)cap, "%8.6f;", v);
  if (w < 0 || (long)w >= cap) return -1;
  return w;
}

extern "C" {

// Decode big-endian binary16 byte pairs to float64, adding `first`.
// Returns the number of samples written to out (= n_bytes / 2).
long apda_decode_half(const uint8_t* buf, long n_bytes, double first, double* out) {
  const long n = n_bytes / 2;
  for (long i = 0; i < n; ++i) {
    const uint16_t w = (uint16_t)((buf[2 * i] << 8) | buf[2 * i + 1]);
    out[i] = decode_half_word(w) + first;
  }
  return n;
}

// Render samples as the log-file token stream "v1;v2;...;" using "%8.6f".
// Returns bytes written (excluding NUL), or -1 if cap would overflow.
// snprintf returns the UNtruncated length, so w >= cap-used means the token
// was clipped: that must report overflow (the caller falls back to Python),
// never return silently corrupt bytes destined for an acquisition log.
long apda_format_samples(const double* vals, long n, char* out, long cap) {
  long used = 0;
  for (long i = 0; i < n; ++i) {
    const long w = format_token(vals[i], out + used, cap - used);
    if (w < 0) return -1;
    used += w;
  }
  return used;
}

// Fused per-packet ingest: decode a binary16 payload (+first), render the
// "%8.6f;" token stream, and append it to the log file in ONE call - the
// gateway's packet hot path (reference GT_FFT_v5.py:172-184 did this one
// interpreted value at a time; the split native decode/format calls still
// paid two ctypes crossings and a NumPy round trip per packet).
//
// The whole token stream is formatted into a heap buffer BEFORE the file is
// opened, so every formatting failure is reported with the file untouched:
//   >= 0 : samples appended
//   -1   : formatting failed / allocation failed, file untouched (caller may
//          safely fall back to the Python two-step path)
//   -2   : I/O failure after opening (caller must NOT retry-append: bytes may
//          have been partially written, exactly like a failed Python write)
long apda_append_half_payload(const uint8_t* buf, long n_bytes, double first,
                              const char* path) {
  const long n = n_bytes / 2;
  // "%8.6f;" of a binary16-derived value + baseline is short, but the
  // baseline is attacker/file-controlled in principle; size generously and
  // overflow-check per token like apda_format_samples.
  const long cap = 64 * n + 16;
  char* out = (char*)malloc((size_t)cap);
  if (!out) return -1;
  long used = 0;
  for (long i = 0; i < n; ++i) {
    const uint16_t w = (uint16_t)((buf[2 * i] << 8) | buf[2 * i + 1]);
    const double v = decode_half_word(w) + first;
    const long k = format_token(v, out + used, cap - used);
    if (k < 0) {
      free(out);
      return -1;
    }
    used += k;
  }
  FILE* f = fopen(path, "a");
  if (!f) {
    free(out);
    return -1;
  }
  const size_t wrote = fwrite(out, 1, (size_t)used, f);
  free(out);
  if (fclose(f) != 0 || wrote != (size_t)used) return -2;
  return n;
}

// Fused ingest + in-memory feed: like apda_append_half_payload, but ALSO
// returns the samples as the analysis path will see them - parsed back from
// the exact "%8.6f" tokens just written (the on-disk quantization contract),
// with non-finite values dropped (load_data.py:76-77 semantics).  This is
// what lets the gateway analyze from memory while keeping the log file as a
// durability artifact only: one decode+format pass serves both, and the
// write-then-re-parse round-trip (reference GT_FFT_v5.py:627) disappears.
//
// out_q must hold n_bytes/2 doubles.  Returns the number of FINITE quantized
// samples written to out_q (>= 0 success; the file append covered all
// n_bytes/2 tokens), -1 formatting/allocation failure with the file
// untouched, -2 I/O failure after opening (file may hold partial bytes; the
// caller must drop its in-memory record and fall back to re-parsing).
long apda_append_half_payload_q(const uint8_t* buf, long n_bytes, double first,
                                const char* path, double* out_q) {
  const long n = n_bytes / 2;
  const long cap = 64 * n + 16;
  char* out = (char*)malloc((size_t)cap);
  if (!out) return -1;
  long used = 0;
  long nq = 0;
  for (long i = 0; i < n; ++i) {
    const uint16_t w = (uint16_t)((buf[2 * i] << 8) | buf[2 * i + 1]);
    const double v = decode_half_word(w) + first;
    double q = NAN;
    const long k = format_token(v, out + used, cap - used, &q);
    if (k < 0) {
      free(out);
      return -1;
    }
    // Quantized value: computed arithmetically inside the fast formatter
    // (exactly what a correctly-rounded parse of the token returns); the
    // rare snprintf/huge-ip path re-parses the just-rendered token with
    // strtod (it stops at the trailing ';').
    if (std::isfinite(v)) {
      if (!std::isfinite(q)) {
        char* end = nullptr;
        q = strtod(out + used, &end);
      }
      if (std::isfinite(q)) out_q[nq++] = q;
    }
    used += k;
  }
  FILE* f = fopen(path, "a");
  if (!f) {
    free(out);
    return -1;
  }
  const size_t wrote = fwrite(out, 1, (size_t)used, f);
  free(out);
  if (fclose(f) != 0 || wrote != (size_t)used) return -2;
  return nq;
}

// Fused ingest onto an ALREADY-OPEN O_APPEND fd: the gateway keeps one fd
// per in-flight acquisition, so the per-packet fopen/fwrite/fclose of the
// path-based variant (~3 syscalls + libc stream setup, the dominant cost of
// the whole ingest call) collapses to one write(2).  Durability is
// unchanged: both variants leave the bytes in the page cache with no fsync;
// O_APPEND keeps interleaved marker appends (separate opens) consistent.
//
// out_q may be NULL (append-only, no quantized feed).  Returns the number
// of finite quantized samples written to out_q (or n_bytes/2 when out_q is
// NULL), -1 on formatting/allocation failure with the fd untouched, -2 on
// a write error (bytes may be partial - caller must drop its in-memory
// record and let the file re-parse decide).
long apda_append_half_payload_qfd(const uint8_t* buf, long n_bytes,
                                  double first, int fd, double* out_q) {
  const long n = n_bytes / 2;
  const long cap = 64 * n + 16;
  char* out = (char*)malloc((size_t)cap);
  if (!out) return -1;
  long used = 0;
  long nq = 0;
  for (long i = 0; i < n; ++i) {
    const uint16_t w = (uint16_t)((buf[2 * i] << 8) | buf[2 * i + 1]);
    const double v = decode_half_word(w) + first;
    double q = NAN;
    const long k = format_token(v, out + used, cap - used, out_q ? &q : nullptr);
    if (k < 0) {
      free(out);
      return -1;
    }
    if (out_q && std::isfinite(v)) {
      if (!std::isfinite(q)) {
        char* end = nullptr;
        q = strtod(out + used, &end);
      }
      if (std::isfinite(q)) out_q[nq++] = q;
    }
    used += k;
  }
  long done = 0;
  while (done < used) {
    const ssize_t w = write(fd, out + done, (size_t)(used - done));
    if (w < 0) {
      if (errno == EINTR) continue;
      free(out);
      return -2;  // partial-write risk either way
    }
    done += w;
  }
  free(out);
  return out_q ? nq : n;
}

// Parse a ';'-separated sample region (log-file rows 4+): numeric tokens
// become samples, non-finite values are dropped, anything unparsable
// (e.g. "* MISSING PACKETS ... *" markers) is skipped - load_data.py:67-77.
//
// Tokens are parsed in place (the ctypes buffer is NUL-terminated and ';'
// / '\n' stop strtod anyway), so there is no token-length limit; a fixed
// 64-byte copy here once truncated long tokens to wrong values.  Tokens
// containing 'x'/'X' are rejected up front: strtod accepts hex floats that
// Python's float() (the fallback and the reference) does not.
long apda_parse_samples(const char* text, long len, double* out, long cap) {
  long count = 0;
  long i = 0;
  while (i < len && count < cap) {
    // token spans up to the next ';' or newline
    long j = i;
    bool hexlike = false;
    while (j < len && text[j] != ';' && text[j] != '\n') {
      if (text[j] == 'x' || text[j] == 'X') hexlike = true;
      ++j;
    }
    if (j > i && !hexlike) {
      char* end = nullptr;
      const double v = strtod(text + i, &end);
      if (end && end != text + i && end <= text + j) {
        // token must be fully consumed (modulo trailing spaces)
        while (end < text + j && (*end == ' ' || *end == '\r' || *end == '\t')) ++end;
        if (end == text + j && std::isfinite(v)) out[count++] = v;
      }
    }
    i = j + 1;
  }
  return count;
}

}  // extern "C"
