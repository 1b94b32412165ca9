// shafa_tpu_torch native runtime: host-side hot loops as a C-ABI shared
// library. Copy of shafa_tpu/runtime/runtime.cpp:1-420.
//
// The reference implements its whole runtime in C (src/modules/*.c); the
// device builds keep device compute in their kernels and move the *host* hot
// paths here: Shannon-Fano code construction (module T, t.c:74-210) and the
// .freq/.cod sidecar ASCII codecs (f.c:89-119 writer; t.c:27-65, c.c:115-177,
// d.c:466-504 readers).  At 100 GiB / 64 KiB blocks these paths touch ~1.6M
// blocks x 256 symbols and dominate host time in pure Python.
//
// Everything is bit-exact with shafa_tpu_torch/{codes,formats}.py (which
// remain the readable spec and the fallback when this library is
// unavailable); tests/test_torch_host.py holds both against shafa_tpu's.
//
// ABI conventions:
//   * all exported symbols are extern "C", prefixed sf_;
//   * functions return 0 on success, negative on malformed input;
//   * buffers the library allocates are released with sf_buf_free;
//   * code tables cross the ABI as (lens uint8[n*256], vals uint64[n*256]):
//     val = code bits LEFT-ALIGNED in a 64-bit word (MSB-first), matching the
//     .shaf packing order (c.c:133-146).  Codes longer than 64 bits cannot
//     arise from blocks < 2^63 bytes (each extra level of Shannon-Fano depth
//     beyond log2 requires the leading frequency to exceed the sum of the
//     rest, i.e. total doubles per level), so 64-bit values are exact for
//     every input the CLI can produce; parsers still validate and reject
//     longer codes defensively.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kSymbols = 256;

struct Buf {
  char* data = nullptr;
  size_t len = 0;
  size_t cap = 0;
  void reserve(size_t n) {
    if (n <= cap) return;
    size_t c = cap ? cap : 4096;
    while (c < n) c *= 2;
    data = static_cast<char*>(std::realloc(data, c));
    cap = c;
  }
  void append(const char* s, size_t n) {
    reserve(len + n);
    std::memcpy(data + len, s, n);
    len += n;
  }
  void push(char c) {
    reserve(len + 1);
    data[len++] = c;
  }
  void append_u64(uint64_t v) {
    char tmp[24];
    int n = std::snprintf(tmp, sizeof tmp, "%llu",
                          static_cast<unsigned long long>(v));
    append(tmp, static_cast<size_t>(n));
  }
};

// Run a [0, n) loop over `threads` workers (n small per item; IO-free).
template <typename F>
void parallel_for(int64_t n, int threads, F&& fn) {
  if (threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  int t = std::min<int64_t>(threads, n);
  pool.reserve(t - 1);
  for (int i = 1; i < t; ++i) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

}  // namespace

extern "C" {

void sf_buf_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Shannon-Fano construction (bit-exact with codes.py / reference t.c)
// ---------------------------------------------------------------------------

// Greedy split with the reference's early stop (t.c:130-152).
static int best_division(const int64_t* f, int first, int last) {
  int64_t total = 0;
  for (int i = first; i <= last; ++i) total += f[i];
  int64_t mindif = total, dif = total, g1 = 0;
  int division = first;
  while (dif == mindif) {
    g1 += f[division];
    dif = std::llabs(2 * g1 - total);
    if (dif < mindif) {
      ++division;
      mindif = dif;
    } else {
      dif = mindif + 1;
    }
  }
  return division - 1;
}

// One block: freqs[256] -> lens[256] (uint8), vals[256] (uint64, left-
// aligned).  Returns 0, or -1 if a code would exceed 64 bits.
static int build_codes_one(const int64_t* freqs, uint8_t* lens,
                           uint64_t* vals) {
  int order[kSymbols];
  for (int i = 0; i < kSymbols; ++i) order[i] = i;
  // stable descending by frequency == order by (-freq, symbol)  (t.c:74-104)
  std::stable_sort(order, order + kSymbols,
                   [&](int a, int b) { return freqs[a] > freqs[b]; });
  int64_t sf[kSymbols];
  for (int i = 0; i < kSymbols; ++i) sf[i] = freqs[order[i]];

  int last_nonzero = -1;
  for (int i = kSymbols - 1; i >= 0; --i) {
    if (sf[i] != 0) {
      last_nonzero = i;
      break;
    }
  }
  std::memset(lens, 0, kSymbols);
  std::memset(vals, 0, kSymbols * sizeof(uint64_t));
  if (last_nonzero < 0) return 0;  // empty stream: all codes empty
  if (last_nonzero == 0) {
    // single distinct symbol: documented deviation, code "0" (codes.py)
    lens[order[0]] = 1;
    vals[order[0]] = 0;
    return 0;
  }

  uint8_t rlen[kSymbols];
  uint64_t rval[kSymbols];
  std::memset(rlen, 0, sizeof rlen);
  std::memset(rval, 0, sizeof rval);
  struct Range {
    int start, end;
  };
  Range stack[kSymbols + 1];
  int sp = 0;
  stack[sp++] = {0, last_nonzero};
  while (sp) {
    Range r = stack[--sp];
    if (r.start == r.end) continue;
    int div = best_division(sf, r.start, r.end);
    for (int i = r.start; i <= r.end; ++i) {
      if (rlen[i] >= 64) return -1;
      // append bit: left part '0', right part '1' (t.c:182-194)
      if (i > div) rval[i] |= 1ull << (63 - rlen[i]);
      rlen[i] += 1;
    }
    stack[sp++] = {r.start, div};
    stack[sp++] = {div + 1, r.end};
  }
  for (int rank = 0; rank <= last_nonzero; ++rank) {
    lens[order[rank]] = rlen[rank];
    vals[order[rank]] = rval[rank];
  }
  return 0;
}

// Batch: freqs (n*256 int64) -> lens (n*256 u8), vals (n*256 u64).
int sf_build_codes(int64_t n_blocks, const int64_t* freqs, uint8_t* lens,
                   uint64_t* vals) {
  std::atomic<int> err(0);
  parallel_for(n_blocks, hw_threads(), [&](int64_t b) {
    if (build_codes_one(freqs + b * kSymbols, lens + b * kSymbols,
                        vals + b * kSymbols) != 0)
      err.store(-1);
  });
  return err.load();
}

// ---------------------------------------------------------------------------
// .freq codec (writer f.c:89-119; elision reader t.c:27-65)
// ---------------------------------------------------------------------------

int sf_write_freq(char mode, int64_t n_blocks, const int64_t* sizes,
                  const int64_t* freqs, char** out, int64_t* out_len) {
  Buf buf;
  buf.push('@');
  buf.push(mode);
  buf.push('@');
  buf.append_u64(static_cast<uint64_t>(n_blocks));
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t* f = freqs + b * kSymbols;
    buf.push('@');
    buf.append_u64(static_cast<uint64_t>(sizes[b]));
    buf.push('@');
    int i = 0;
    while (i < kSymbols) {
      buf.append_u64(static_cast<uint64_t>(f[i]));
      int j = i;
      while (j < kSymbols && f[j] == f[i]) {
        if (j != kSymbols - 1) buf.push(';');
        ++j;
      }
      i = j;
    }
  }
  buf.append("@0", 2);
  *out = buf.data;
  *out_len = static_cast<int64_t>(buf.len);
  return 0;
}

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool eat(char c) {
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }
  // Parse a nonnegative decimal integer; false if none present.
  bool num(int64_t* out) {
    if (p >= end || *p < '0' || *p > '9') return false;
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      ++p;
    }
    *out = v;
    return true;
  }
};

}  // namespace

// Phase 1: header only -> mode + n_blocks (caller then allocates outputs).
int sf_parse_freq_header(const char* data, int64_t len, char* mode,
                         int64_t* n_blocks) {
  Cursor c{data, data + len};
  if (!c.eat('@')) return -1;
  if (c.p >= c.end || (*c.p != 'R' && *c.p != 'N')) return -1;
  *mode = *c.p++;
  if (!c.eat('@')) return -1;
  if (!c.num(n_blocks)) return -1;
  return 0;
}

// Phase 2: full parse into caller-allocated sizes (n) and freqs (n*256).
int sf_parse_freq(const char* data, int64_t len, int64_t n_blocks,
                  int64_t* sizes, int64_t* freqs) {
  Cursor c{data, data + len};
  char mode;
  int64_t n;
  if (sf_parse_freq_header(data, len, &mode, &n) != 0 || n != n_blocks)
    return -1;
  c.p = data;
  c.eat('@');
  ++c.p;  // mode
  c.eat('@');
  c.num(&n);
  for (int64_t b = 0; b < n_blocks; ++b) {
    if (!c.eat('@')) return -1;
    if (!c.num(&sizes[b])) return -1;
    if (!c.eat('@')) return -1;
    int64_t* f = freqs + b * kSymbols;
    int64_t prev = -1;
    for (int i = 0; i < kSymbols; ++i) {
      if (i > 0 && !c.eat(';')) return -1;  // separator before every entry > 0
      if (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
        c.num(&prev);
        f[i] = prev;
      } else {
        if (prev < 0) return -1;  // elided entry with no predecessor
        f[i] = prev;  // empty token: repeat previous (t.c:50-52)
      }
    }
  }
  if (!c.eat('@')) return -1;
  int64_t z;
  if (!c.num(&z) || z != 0) return -1;
  if (c.p != c.end) return -1;
  return 0;
}

// ---------------------------------------------------------------------------
// .cod codec (writer t.c:302,350-362,396; readers c.c:115-177, d.c:466-504)
// ---------------------------------------------------------------------------

int sf_write_cod(char mode, int64_t n_blocks, const int64_t* sizes,
                 const uint8_t* lens, const uint64_t* vals, char** out,
                 int64_t* out_len) {
  Buf buf;
  buf.push('@');
  buf.push(mode);
  buf.push('@');
  buf.append_u64(static_cast<uint64_t>(n_blocks));
  for (int64_t b = 0; b < n_blocks; ++b) {
    buf.push('@');
    buf.append_u64(static_cast<uint64_t>(sizes[b]));
    buf.push('@');
    const uint8_t* ln = lens + b * kSymbols;
    const uint64_t* vl = vals + b * kSymbols;
    for (int s = 0; s < kSymbols; ++s) {
      if (s) buf.push(';');
      int n = ln[s];
      if (n) {
        buf.reserve(buf.len + n);
        uint64_t v = vl[s];
        for (int k = 0; k < n; ++k)
          buf.data[buf.len + k] = (v >> (63 - k)) & 1 ? '1' : '0';
        buf.len += n;
      }
    }
  }
  buf.append("@0", 2);
  *out = buf.data;
  *out_len = static_cast<int64_t>(buf.len);
  return 0;
}

int sf_parse_cod_header(const char* data, int64_t len, char* mode,
                        int64_t* n_blocks) {
  return sf_parse_freq_header(data, len, mode, n_blocks);  // same shape
}

// Full parse into caller-allocated sizes (n), lens (n*256), vals (n*256).
// Returns 0; -1 malformed; -2 a code exceeds 64 bits (caller falls back to
// the Python string path, which has no length limit).
int sf_parse_cod(const char* data, int64_t len, int64_t n_blocks,
                 int64_t* sizes, uint8_t* lens, uint64_t* vals) {
  Cursor c{data, data + len};
  char mode;
  int64_t n;
  if (sf_parse_cod_header(data, len, &mode, &n) != 0 || n != n_blocks)
    return -1;
  c.p = data + 2;  // '@' mode
  ++c.p;           // '@'
  c.num(&n);
  for (int64_t b = 0; b < n_blocks; ++b) {
    if (!c.eat('@')) return -1;
    if (!c.num(&sizes[b])) return -1;
    if (!c.eat('@')) return -1;
    uint8_t* ln = lens + b * kSymbols;
    uint64_t* vl = vals + b * kSymbols;
    for (int s = 0; s < kSymbols; ++s) {
      if (s > 0 && !c.eat(';')) return -1;
      int nbits = 0;
      uint64_t v = 0;
      while (c.p < c.end && (*c.p == '0' || *c.p == '1')) {
        if (nbits >= 64) return -2;
        if (*c.p == '1') v |= 1ull << (63 - nbits);
        ++nbits;
        ++c.p;
      }
      ln[s] = static_cast<uint8_t>(nbits);
      vl[s] = v;
    }
  }
  if (!c.eat('@')) return -1;
  int64_t z;
  if (!c.num(&z) || z != 0) return -1;
  if (c.p != c.end) return -1;
  return 0;
}

// ---------------------------------------------------------------------------
// .shaf framing (writer c.c:351,256-258; reader d.c:673,697-706)
// ---------------------------------------------------------------------------

int sf_parse_shaf_header(const char* data, int64_t len, int64_t* n_blocks) {
  Cursor c{data, data + len};
  if (!c.eat('@')) return -1;
  if (!c.num(n_blocks)) return -1;
  return 0;
}

// Frame scan: offsets (n) and sizes (n) of each block's raw payload within
// `data`.  No copying — payloads may contain '@', so parse by length.
int sf_parse_shaf_frames(const char* data, int64_t len, int64_t n_blocks,
                         int64_t* offsets, int64_t* sizes) {
  Cursor c{data, data + len};
  int64_t n;
  if (sf_parse_shaf_header(data, len, &n) != 0 || n != n_blocks) return -1;
  c.eat('@');
  c.num(&n);  // advance past the validated header
  for (int64_t b = 0; b < n_blocks; ++b) {
    if (!c.eat('@')) return -1;
    int64_t sz;
    if (!c.num(&sz)) return -1;
    if (!c.eat('@')) return -1;
    if (c.end - c.p < sz) return -1;
    offsets[b] = c.p - data;
    sizes[b] = sz;
    c.p += sz;
  }
  if (c.p != c.end) return -1;  // no trailer; trailing bytes are an error
  return 0;
}

}  // extern "C"
