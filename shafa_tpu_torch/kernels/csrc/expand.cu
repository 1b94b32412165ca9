// K4: RLE expansion of decoded rows, from the RLE rows themselves.
//
// Replaces shafa_tpu/kernels/expand_pallas.py::_expand_kernel (pallas_call
// at expand_pallas.py:191) together with its input stage, the token scan of
// rle_expand_prep (:201; shafa_tpu/kernels/rle.py:156-206). Input: (B, P)
// RLE rows and their lengths. The state before a byte is how many
// escape-payload bytes are still pending, 0-2, 0 at the row's start; a byte
// in state 0 starts a token; a 0x00 start emits x[i+1] max(x[i+2], 1)
// times and leaves 2 pending, any other start emits itself once. Escape
// fields past the row's length read as 0 (rle.token_fields). Output: every
// row's expanded bytes, the rows back to back, exactly their total.
//
// Bound on the H100: device-memory bytes, the RLE bytes read once and the
// expanded bytes written once (this design reads the RLE bytes twice).
//
// Design, with tiles of 4096 RLE bytes of one row (256 threads x 16
// consecutive bytes, one int4 load each; a thread reads the next 4 bytes
// for the fields of a token in its last two):
//   A  each tile's summary: for each of the 3 entry states, the exit state
//      (2 bits each, 6 in all) and the sum of the counts of the tokens that
//      start in the tile. Summaries compose in row order: (f, c) then
//      (g, d) is (g o f, s -> c[s] + d[f(s)]). Warp reductions in lane
//      order, then thread 0 over the warps.
//   B  one block per row scans its tiles' summaries from state 0: every
//      tile's entry state and int64 output offset within the row, and the
//      row's expanded size. R: one block places the rows back to back.
//   The host downloads the sizes and allocates exactly their total: the
//   tiles' output spans cover [0, total) once, so nothing is zeroed.
//   C  each tile: its threads' entry states (a warp scan of their 3-state
//      functions, one thread walking the tile's entry state through the
//      warp aggregates), their tokens, and a block scan of their (count,
//      token) sums. A span of at most 20 KB (5 tiles' input; the mixed and
//      text corpora's spans are about 1.5 tiles) is expanded in shared
//      memory, each thread filling its tokens' runs, and stored from there
//      as 16-byte words, a warp's stores 512 contiguous bytes. A longer
//      span (up to 85 times its input, escapes of count 255) is written
//      output-centrically from the tokens' (offset, symbol) staged in
//      shared memory: each warp takes a run of the span's words, a thread
//      every 32nd, finds each word's first token by a galloping search over
//      the staged offsets from its last token, and fills the word token by
//      token. Either way the two edge words, which a neighbouring tile may
//      share, are written byte by byte, only the span's bytes, and nothing
//      at or past total.
// A thread finds its tokens with bit masks: from its entry state on every
// valid byte starts one, but for the payload bytes of the escapes it
// meets, so it visits only its 0x00 bytes (chain).
// The TPU kernel placed symbol deltas into 2048-byte pages with one-hot MXU
// products and carried windows from page to page, behind a sentinel offset
// for its masking (expand_pallas.py:57-61,270-276); none of that is needed
// where a block can search its own tokens.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // consecutive RLE bytes per thread
constexpr int TILE = THREADS * ITEMS;  // RLE bytes per tile

// A 3-state function: the image of state s in bits 2s, 2s + 1.
constexpr uint32_t IDENT3 = 0u | 1u << 2 | 2u << 4;

__device__ __forceinline__ int image(uint32_t f, int s) {
  return (int)((f >> (2 * s)) & 3u);
}

// "a then c" of two 3-state functions.
__device__ __forceinline__ uint32_t compose3(uint32_t a, uint32_t c) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) r |= (uint32_t)image(c, image(a, s)) << (2 * s);
  return r;
}

// A summary of a run of bytes: f, and c[s] the sum of the counts of the
// tokens that start in it when it is entered in state s.
template <typename T>
struct Sum {
  uint32_t f;
  T c[3];
};

template <typename T>
__device__ __forceinline__ Sum<T> identity_sum() {
  return Sum<T>{IDENT3, {0, 0, 0}};
}

template <typename T>
__device__ __forceinline__ T pick(const T (&c)[3], int s) {
  return s == 0 ? c[0] : s == 1 ? c[1] : c[2];
}

// "a then b".
template <typename T>
__device__ __forceinline__ Sum<T> combine(const Sum<T>& a, const Sum<T>& b) {
  Sum<T> r;
  r.f = compose3(a.f, b.f);
#pragma unroll
  for (int s = 0; s < 3; ++s) r.c[s] = a.c[s] + pick(b.c, image(a.f, s));
  return r;
}

template <typename T>
__device__ __forceinline__ Sum<T> shfl_sum(const Sum<T>& v, int d, bool up) {
  Sum<T> r;
  r.f = up ? __shfl_up_sync(0xFFFFFFFFu, v.f, d)
           : __shfl_down_sync(0xFFFFFFFFu, v.f, d);
#pragma unroll
  for (int s = 0; s < 3; ++s)
    r.c[s] = up ? __shfl_up_sync(0xFFFFFFFFu, v.c[s], d)
                : __shfl_down_sync(0xFFFFFFFFu, v.c[s], d);
  return r;
}

struct Args {
  const uint8_t* x;  // (B, P) RLE rows
  const int* lens;   // (B,) RLE bytes per row
  long long p;       // row width, a multiple of 16
  int n_tiles;
};

// A thread's 16 bytes from lane j0 on, and the 4 after them (zero past the
// row width): byte i of the 20 is byte i & 3 of w[i >> 2], picked by
// selects, so that a run-time i leaves w in registers.
struct Bytes {
  uint32_t w[5];
  long long j0;   // the row lane of byte 0
  long long len;  // the row's length, at most P

  __device__ __forceinline__ uint32_t at(int i) const {
    const uint32_t word = i < 8 ? (i < 4 ? w[0] : w[1])
                                : (i < 12 ? w[2] : i < 16 ? w[3] : w[4]);
    return (word >> (8 * (i & 3))) & 0xFFu;
  }
  __device__ __forceinline__ bool valid(int i) const { return j0 + i < len; }
  // an escape's field at byte i (0 past the row's length)
  __device__ __forceinline__ uint32_t field(int i) const {
    return valid(i) ? at(i) : 0u;
  }
};

__device__ __forceinline__ Bytes load_bytes(const Args& a, int row,
                                            long long j0, long long len) {
  Bytes by;
  by.j0 = j0;
  by.len = len;
  const uint8_t* src = a.x + row * a.p + j0;
  const int4 v = *reinterpret_cast<const int4*>(src);
  by.w[0] = (uint32_t)v.x;
  by.w[1] = (uint32_t)v.y;
  by.w[2] = (uint32_t)v.z;
  by.w[3] = (uint32_t)v.w;
  by.w[4] = j0 + ITEMS < a.p ? __ldg(reinterpret_cast<const uint32_t*>(
                                   src + ITEMS))
                             : 0u;
  return by;
}

// The thread's valid bytes (0-16) and the mask of those that are 0x00
// (bit i: byte i; __vcmpeq4 marks a zero byte 0xFF, the multiply gathers
// the 4 marks of a word into 4 bits).
__device__ __forceinline__ int n_valid(const Bytes& by) {
  return (int)max(min(by.len - by.j0, (long long)ITEMS), 0ll);
}

__device__ __forceinline__ uint32_t zero_mask(const Bytes& by, int v) {
  uint32_t z = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t e = (__vcmpeq4(by.w[k], 0u) >> 7) & 0x01010101u;
    z |= ((e * 0x00204081u) >> 21 & 0xFu) << (4 * k);
  }
  return z & ((1u << v) - 1u);
}

// The thread's tokens entered in state e: bit i of the result marks a token
// start at byte i; cnt gets the sum of their counts and q the exit state.
// Every valid byte from e on starts a token, except the two payload bytes
// after each escape start: the loop visits the 0x00 bytes that start
// tokens, in order (none at all in most threads of text). The entry state
// acts as an escape started at byte e - 3.
__device__ __forceinline__ uint32_t chain(const Bytes& by, uint32_t zero,
                                          int v, int e, int& cnt, int& q) {
  uint32_t starts = v > e ? ((1u << v) - 1u) & ~((1u << e) - 1u) : 0u;
  int last = e - 3, extra = 0;
  for (uint32_t z = zero & starts; z;) {
    const int p = __ffs(z) - 1;
    starts &= ~(6u << p);  // the escape's payload bytes
    extra += (int)max(by.field(p + 2), 1u) - 1;
    last = p;
    z = zero & starts & ~((2u << p) - 1u);
  }
  cnt = __popc(starts) + extra;
  q = max(last + 3 - v, 0);
  return starts;
}

__device__ __forceinline__ Sum<int> thread_sum(const Bytes& by, uint32_t zero,
                                               int v) {
  Sum<int> s;
  s.f = 0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    int q;
    chain(by, zero, v, e, s.c[e], q);
    s.f |= (uint32_t)q << (2 * e);
  }
  return s;
}

// A: each tile's summary, (f, c0, c1, c2) as an int4.
__global__ void __launch_bounds__(THREADS)
expand_tile_sums(Args a, int4* __restrict__ tile_sum) {
  __shared__ Sum<int> warp_sum[WARPS];
  const int row = blockIdx.y;
  const long long t = (long long)row * a.n_tiles + blockIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long len = min((long long)a.lens[row], a.p);
  if (tile0 >= len) {
    if (threadIdx.x == 0) tile_sum[t] = make_int4((int)IDENT3, 0, 0, 0);
    return;
  }
  const long long j0 = tile0 + ITEMS * threadIdx.x;
  Sum<int> s = identity_sum<int>();
  if (j0 < len) {
    const Bytes by = load_bytes(a, row, j0, len);
    const int v = n_valid(by);
    s = thread_sum(by, zero_mask(by, v), v);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Sum<int> o = shfl_sum(s, d, false);
    if (lane + d < 32) s = combine(s, o);
  }
  if (lane == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Sum<int> r = warp_sum[0];
    for (int w = 1; w < WARPS; ++w) r = combine(r, warp_sum[w]);
    tile_sum[t] = make_int4((int)r.f, r.c[0], r.c[1], r.c[2]);
  }
}

// B: every tile's entry state and output offset within its row, and the
// row's expanded size. One block per row walks it in chunks of B_THREADS *
// B_ITEMS tiles: each thread combines B_ITEMS consecutive summaries, a warp
// scan and one thread over the warp aggregates give each thread's entry
// state and offset, and the thread walks them through its tiles.
constexpr int B_THREADS = 512;
constexpr int B_WARPS = B_THREADS / 32;
constexpr int B_ITEMS = 8;

__global__ void __launch_bounds__(B_THREADS)
expand_tile_bases(const int4* __restrict__ tile_sum,
                  uint8_t* __restrict__ tile_entry,
                  long long* __restrict__ tile_base,
                  long long* __restrict__ out_len, int n_tiles) {
  __shared__ Sum<long long> warp_agg[B_WARPS];
  __shared__ int warp_q[B_WARPS];
  __shared__ long long warp_base[B_WARPS];
  __shared__ int carry_q;
  __shared__ long long carry_base;
  const long long row0 = (long long)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    carry_q = 0;
    carry_base = 0;
  }
  for (int base = 0; base < n_tiles; base += B_THREADS * B_ITEMS) {
    const int t0 = base + threadIdx.x * B_ITEMS;
    Sum<int> own[B_ITEMS];
    Sum<long long> g = identity_sum<long long>();
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      own[i] = identity_sum<int>();
      if (t0 + i < n_tiles) {
        const int4 v = tile_sum[row0 + t0 + i];
        own[i] = Sum<int>{(uint32_t)v.x, {v.y, v.z, v.w}};
      }
      g = combine(g, Sum<long long>{own[i].f, {own[i].c[0], own[i].c[1],
                                               own[i].c[2]}});
    }
    Sum<long long> incl = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Sum<long long> o = shfl_sum(incl, d, true);
      if (lane >= d) incl = combine(o, incl);
    }
    Sum<long long> excl = shfl_sum(incl, 1, true);
    if (lane == 0) excl = identity_sum<long long>();
    __syncthreads();  // the carry and the warp arrays are reused
    if (lane == 31) warp_agg[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      int q = carry_q;
      long long b = carry_base;
      for (int w = 0; w < B_WARPS; ++w) {
        warp_q[w] = q;
        warp_base[w] = b;
        b += pick(warp_agg[w].c, q);
        q = image(warp_agg[w].f, q);
      }
      carry_q = q;
      carry_base = b;
    }
    __syncthreads();
    int q = image(excl.f, warp_q[warp]);
    long long b = warp_base[warp] + pick(excl.c, warp_q[warp]);
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      if (t0 + i < n_tiles) {
        tile_entry[row0 + t0 + i] = (uint8_t)q;
        tile_base[row0 + t0 + i] = b;
      }
      b += pick(own[i].c, q);
      q = image(own[i].f, q);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out_len[blockIdx.x] = carry_base;
}

// R: row_base = the exclusive sum of out_len over the rows. One block.
constexpr int R_THREADS = 1024;

__global__ void __launch_bounds__(R_THREADS)
expand_row_bases(const long long* __restrict__ out_len,
                 long long* __restrict__ row_base, int b) {
  __shared__ long long warp_tot[R_THREADS / 32];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int base = 0; base < b; base += R_THREADS) {
    const int r = base + threadIdx.x;
    const long long v = r < b ? out_len[r] : 0;
    long long incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += o;
    }
    __syncthreads();  // warp_tot and carry are reused
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_tot[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long o = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += o;
      }
      warp_tot[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const long long before = carry + (warp ? warp_tot[warp - 1] : 0);
    if (r < b) row_base[r] = before + incl - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_tot[R_THREADS / 32 - 1];
  }
}

// C: every tile's tokens, then its output span as 16-byte words. A span
// of at most STAGE bytes (from its first word on) is expanded in shared
// memory and stored from there; a longer one is written from its staged
// tokens, word by word.
constexpr int STAGE = 5 * TILE;

// Bytes [pos, pos + n) of the shared buffer s set to sym.
__device__ __forceinline__ void fill(uint8_t* s, int pos, int n,
                                     uint32_t sym) {
  const int end = pos + n;
  for (; pos < end && (pos & 3); ++pos) s[pos] = (uint8_t)sym;
  for (; pos + 4 <= end; pos += 4)
    *reinterpret_cast<uint32_t*>(s + pos) = sym * 0x01010101u;
  for (; pos < end; ++pos) s[pos] = (uint8_t)sym;
}

// Word w of the output, whose bytes are v: stored whole inside [g0, end),
// else only its bytes that lie there.
__device__ __forceinline__ void store_word(uint8_t* __restrict__ out,
                                           long long w, const uint32_t (&v)[4],
                                           long long g0, long long end) {
  const long long lo = 16 * w;
  if (lo >= g0 && lo + 16 <= end) {
    *reinterpret_cast<int4*>(out + lo) =
        make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (lo + i >= g0 && lo + i < end)
        out[lo + i] = (uint8_t)(v[i >> 2] >> (8 * (i & 3)));
  }
}

__global__ void __launch_bounds__(THREADS)
expand_tiles(Args a, const uint8_t* __restrict__ tile_entry,
             const long long* __restrict__ tile_base,
             const long long* __restrict__ row_base,
             uint8_t* __restrict__ out, long long total) {
  using u64 = unsigned long long;
  __shared__ union {
    struct {
      int off[TILE];  // the tokens' first output byte in the span
      uint8_t sym[TILE];
    } tok;
    int4 words[STAGE / 16];  // a short span, from its first word on
  } sm;
  __shared__ uint32_t warp_f[WARPS];
  __shared__ int warp_q[WARPS];
  __shared__ u64 warp_tot[WARPS];
  const long long t = blockIdx.x;
  const int row = (int)(t / a.n_tiles);
  const long long tile0 = (t - (long long)row * a.n_tiles) * TILE;
  const long long len = min((long long)a.lens[row], a.p);
  if (tile0 >= len) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j0 = tile0 + ITEMS * threadIdx.x;
  Bytes by{};
  uint32_t f = IDENT3, zero = 0;
  int v = 0;
  if (j0 < len) {
    by = load_bytes(a, row, j0, len);
    v = n_valid(by);
    zero = zero_mask(by, v);
    f = thread_sum(by, zero, v).f;
  }
  // every thread's entry state
  uint32_t incl = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl = compose3(o, incl);
  }
  uint32_t excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = IDENT3;
  if (lane == 31) warp_f[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int q = tile_entry[t];
    for (int w = 0; w < WARPS; ++w) {
      warp_q[w] = q;
      q = image(warp_f[w], q);
    }
  }
  __syncthreads();
  const int entry = image(excl, warp_q[warp]);
  // the thread's count (high half) and tokens (low half), scanned
  uint32_t starts = 0;
  u64 own = 0;
  if (j0 < len) {
    int cnt, q;
    starts = chain(by, zero, v, entry, cnt, q);
    own = (u64)cnt << 32 | (u64)__popc(starts);
  }
  u64 scan = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 o = __shfl_up_sync(0xFFFFFFFFu, scan, d);
    if (lane >= d) scan += o;
  }
  if (lane == 31) warp_tot[warp] = scan;
  __syncthreads();
  u64 before = 0, tile_tot = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) before = tile_tot;
    tile_tot += warp_tot[w];
  }
  before += scan - own;
  const int ntok = (int)(tile_tot & 0xFFFFFFFFu);
  const long long g0 = row_base[row] + tile_base[t];
  const int lead = (int)(g0 & 15);  // the span's offset in its first word
  const bool short_span = lead + (long long)(tile_tot >> 32) <= STAGE;
  if (j0 < len) {
    uint8_t* sb = reinterpret_cast<uint8_t*>(sm.words);
    int off = (int)(before >> 32);
    int k = (int)(before & 0xFFFFFFFFu);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (starts >> i & 1u) {
        const bool esc = zero >> i & 1u;
        const uint32_t sym = esc ? by.field(i + 1) : by.at(i);
        const int n = esc ? (int)max(by.field(i + 2), 1u) : 1;
        if (short_span) {
          if (n == 1)
            sb[lead + off] = (uint8_t)sym;
          else
            fill(sb, lead + off, n, sym);
        } else {
          sm.tok.off[k] = off;
          sm.tok.sym[k] = (uint8_t)sym;
          ++k;
        }
        off += n;
      }
    }
  }
  __syncthreads();
  const long long end = min(g0 + (long long)(tile_tot >> 32), total);
  if (ntok == 0 || end <= g0) return;
  const long long w0 = g0 >> 4;
  if (short_span) {
    for (long long w = w0 + threadIdx.x; 16 * w < end; w += THREADS) {
      const int4 x = sm.words[w - w0];
      const uint32_t v[4] = {(uint32_t)x.x, (uint32_t)x.y, (uint32_t)x.z,
                             (uint32_t)x.w};
      store_word(out, w, v, g0, end);
    }
    return;
  }
  // warp w takes a run of the span's words, its lanes 32 words apart
  const long long words = ((end + 15) >> 4) - w0;
  const long long per = ((words + WARPS - 1) / WARPS + 31) & ~31ll;
  const long long wend = w0 + min(per * (warp + 1), words);
  int tk = 0;  // the thread's words come in order: so do their tokens
  for (long long w = w0 + per * warp + lane; w < wend; w += 32) {
    const int rel = (int)(16 * w - g0);  // negative in the first word
    // the last token with off <= max(rel, 0): a galloping search from tk
    int jump = 1;
    while (tk + jump < ntok && sm.tok.off[tk + jump] <= rel) jump <<= 1;
    int hi = min(tk + jump, ntok);
    tk += jump >> 1;
    while (hi - tk > 1) {
      const int mid = (tk + hi) >> 1;
      if (sm.tok.off[mid] <= rel) tk = mid; else hi = mid;
    }
    // the word's bytes token by token: [i, e) from token tk
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 16;) {
      while (tk + 1 < ntok && sm.tok.off[tk + 1] <= rel + i) ++tk;
      const int e = tk + 1 < ntok ? min(sm.tok.off[tk + 1] - rel, 16) : 16;
      const uint32_t s4 = sm.tok.sym[tk] * 0x01010101u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b0 = min(max(i - 4 * j, 0), 4);
        const int b1 = min(max(e - 4 * j, 0), 4);
        v[j] |= s4 & (uint32_t)(((1ull << (8 * b1)) - 1) &
                                ~((1ull << (8 * b0)) - 1));
      }
      i = e;
    }
    store_word(out, w, v, g0, end);
  }
}

}  // namespace

extern "C" {

// RLE bytes per tile: the wrappers size the (B, n_tiles) scratch with it.
int shafa_expand_tile_bytes() { return TILE; }

// Passes A, B and R. x: (B, P) u8, P a multiple of 16; lens: (B,) i32;
// tile_sum: (B, n_tiles) int4 scratch; tile_entry: (B, n_tiles) u8,
// tile_base: (B, n_tiles) i64, out_len, row_base: (B,) i64, all read by
// shafa_expand.
int shafa_expand_sizes(const uint8_t* x, const int* lens, int b, long long p,
                       void* tile_sum, uint8_t* tile_entry,
                       long long* tile_base, long long* out_len,
                       long long* row_base, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (p % 16) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const Args a{x, lens, p, n_tiles};
  int4* sums = static_cast<int4*>(tile_sum);
  expand_tile_sums<<<dim3(n_tiles, b), THREADS, 0, stream>>>(a, sums);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  expand_tile_bases<<<b, B_THREADS, 0, stream>>>(sums, tile_entry, tile_base,
                                                 out_len, n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  expand_row_bases<<<1, R_THREADS, 0, stream>>>(out_len, row_base, b);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// Pass C, after shafa_expand_sizes on the same x and lens: out: (total,)
// u8, 16-byte aligned; the rows' bytes back to back, none written at or
// past total (rows that end past it are cut there).
int shafa_expand(const uint8_t* x, const int* lens, int b, long long p,
                 const uint8_t* tile_entry, const long long* tile_base,
                 const long long* row_base, uint8_t* out, long long total,
                 cudaStream_t stream) {
  if (b <= 0 || p <= 0 || total <= 0) return 0;
  if (p % 16) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const Args a{x, lens, p, n_tiles};
  expand_tiles<<<(unsigned)((long long)b * n_tiles), THREADS, 0, stream>>>(
      a, tile_entry, tile_base, row_base, out, total);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
