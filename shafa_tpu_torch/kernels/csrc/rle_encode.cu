// K8: the RLE encode of byte rows, with the histogram of its output.
//
// Replaces shafa_tpu/kernels/rle.py::rle_encode_batch_pallas (:84-104): the
// run analysis _rle_analyze (:52-81), traced into the same program, and the
// emission that it hands to K1 (emit_pallas.emit_bits_rows, pallas_call at
// emit_pallas.py:328); and the histogram of the RLE rows that the fused
// encode takes next (shafa_tpu/device.py:143-147, XLA in the JAX package).
// Input: (B, P) rows and their lengths. A run is a stretch of equal bytes
// of one row below its length; a sub-run is a run cut every 255 bytes from
// its start. A sub-run of 4 or more bytes, or of the byte 0x00, is written
// as the triple (0x00, byte, length), any other as its bytes. Output: each
// row's RLE bytes from the start of its (2P + 8, rounded up to 512) output
// row, its length, and the (B, 256) counts of the bytes written.
//
// Bound on the H100: device-memory bytes, the input read once and the RLE
// bytes written once.
//
// Design: one launch, after memsets of the look-back words, the lengths and
// the histogram on the same stream. Persistent blocks take tiles of 8192
// bytes of one row from a ticket, the rows' tiles interleaved as in K1 (a
// tile past its row's length is skipped and publishes nothing). Each thread
// loads its 32 consecutive bytes once (two int4s) and marks where runs
// start; 8 threads load the 256 bytes past the tile likewise (the halo: a
// sub-run that starts in the tile ends at most 254 bytes past it), clipped
// at the row's length. Two carries come from the row's earlier tiles by
// decoupled look-backs (look_back), run by warp 0:
//   1. the run start in force at the tile's first byte, the max of the
//      earlier tiles' last run starts (a run may span any number of tiles).
//      A tile with a run start publishes its last one at once as its
//      prefix; one without publishes an empty aggregate, walks back to the
//      nearest prefix and publishes that. Only a tile whose first byte
//      continues a run waits for this carry.
//   2. the tile's output offset in its row, the sum of the earlier tiles'
//      byte counts, int64. The tile with the row's last byte writes the
//      row's length; rows of length 0 keep the memset's 0.
// Each thread classifies its bytes with bit masks over its 32 bytes (plan):
// the sub-run starts (run starts, and at most one 255 split of the run in
// force), the escaped starts (a sub-run start of 0x00, or with no other
// sub-run start in the next 3 bytes), and, by a segmented smear, the bytes
// inside escaped sub-runs; every other byte is a literal. A byte's output
// is itself (a literal), the triple (an escaped start) or nothing, so the
// thread's output is its bytes' in order (the escape's owner is the thread,
// and the tile, where its sub-run starts). A block scan of the threads'
// counts gives the tile's count and each thread's offset. A thread whose 32
// bytes are all literals stores them into the tile's shared staging buffer
// as 4-byte words (funnel shifts), any other byte by byte; the tile stores
// the staged bytes as 16-byte words, the two edge words that a neighbouring
// tile shares byte by byte. The histogram's bins live in shared memory:
// with at most KEEP_ROWS rows the block keeps 256 bins a row over every
// tile it takes and adds them to hist once at its end, otherwise one set
// that it adds after each tile.
// The counts are integer atomics, exact in any order.
// The TPU kernel's input was one (val, bitlen) payload a lane from the run
// analysis, whose cummax/cummin scans ran in XLA; here the output is byte
// granular, so the tiles write bytes and build no payloads.
#include <algorithm>
#include <atomic>
#include <climits>

#include "fsm_common.cuh"

namespace {

using shafa_fsm::u64;
using shafa_fsm::STATUS_AGGREGATE;
using shafa_fsm::STATUS_PREFIX;
using shafa_fsm::STATUS_VALUE;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 32;              // consecutive input bytes per thread
constexpr int WORDS = ITEMS / 4;
constexpr int TILE = THREADS * ITEMS;  // input bytes per tile
constexpr int MAX_RUN = 255;
constexpr int MIN_ESCAPE_RUN = 4;
constexpr int HALO = MAX_RUN - 1;      // bytes past a tile a sub-run reaches
constexpr int HALO_THREADS = 256 / ITEMS;  // load the 256 bytes past it
constexpr int STAGE_LEAD = 16;         // bytes before a tile's staged output
// a tile's output (at most 3 bytes an input byte) between STAGE_LEAD bytes
// and the 32 that the reads of its last 16-byte word may reach past it
constexpr int STAGE = STAGE_LEAD + 3 * TILE + 32;
constexpr int KEEP_ROWS = 8;           // rows whose bins a block keeps
// blocks an SM the registers must allow: 48 registers a thread (49 round up
// to 56 on the H100 and leave room for 4 blocks, about 5% slower)
constexpr int MIN_BLOCKS = 5;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const uint8_t* x;      // (B, P) rows
  const int* lens;       // (B,) bytes per row
  long long p;           // row width, a multiple of 16, below 2^30
  int b;                 // rows
  int n_tiles;           // tiles per row
  int total;             // B * n_tiles
  u64* status;           // (2, B, n_tiles) look-back words, zeroed
  int* ticket;           // zeroed
  uint8_t* out;          // (B, out_stride) RLE rows
  long long out_stride;
  long long* out_len;    // (B,), zeroed
  unsigned long long* hist;  // (B, 256), zeroed
};

__device__ __forceinline__ int row_len(const Args& a, int row) {
  return (int)min(max((long long)__ldg(a.lens + row), 0ll), a.p);
}

// Ticket t is tile t / B of row t % B: the rows' tiles interleave, so that
// each row's look-back walks past fewer tiles that have not published yet.
// A ticket taken from a.ticket (atomicAdd) becomes a.total, no tile, once
// it passes the longest row (max_len bytes).
__device__ __forceinline__ int tile_of(const Args& a, int ticket,
                                       int max_len) {
  return ticket < a.total && (long long)(ticket / a.b) * TILE < max_len
             ? ticket : a.total;
}

// A thread's 32 bytes from j0 on: byte i is byte i & 3 of w[i >> 2];
// v of them lie below the row's length; bit i of starts is set where byte
// i starts a run.
struct Chunk {
  uint32_t w[WORDS];
  int j0;
  int v;
  uint32_t starts;

  // byte i, i known at compile time (w stays in registers)
  __device__ __forceinline__ uint32_t at(int i) const {
    return (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
  }
};

// The low n bits (n in [0, 32]).
__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// Bit 7 of each byte of a ^ b that is not 0.
__device__ __forceinline__ uint32_t ne_bytes(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return (x | ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu)) & 0x80808080u;
}

// Bit 7 of each byte of e gathered into 4 bits (bit k: byte k).
__device__ __forceinline__ uint32_t gather_bytes(uint32_t e) {
  return ((((e >> 7) & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

__device__ __forceinline__ Chunk load_chunk(const Args& a, int row, int j0,
                                            int len) {
  Chunk c;
  c.j0 = j0;
  c.v = max(min(len - j0, ITEMS), 0);
  c.starts = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) c.w[k] = 0;
  if (c.v == 0) return c;
  const uint8_t* src = a.x + (long long)row * a.p + j0;
#pragma unroll
  for (int h = 0; h < WORDS / 4; ++h) {
    // P is a multiple of 16: a 16-byte word holds no byte past it or none
    if (h == 0 || j0 + 16 * h < a.p) {
      const int4 q = reinterpret_cast<const int4*>(src)[h];
      c.w[4 * h] = (uint32_t)q.x;
      c.w[4 * h + 1] = (uint32_t)q.y;
      c.w[4 * h + 2] = (uint32_t)q.z;
      c.w[4 * h + 3] = (uint32_t)q.w;
    }
  }
  // the byte before: at a row's start, one that differs from byte 0
  uint32_t prev = j0 > 0 ? (uint32_t)src[-1] : (~c.w[0] & 0xFFu);
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const uint32_t shifted = (c.w[k] << 8) | prev;
    prev = c.w[k] >> 24;
    // each byte that differs from the byte before it
    m |= gather_bytes(ne_bytes(c.w[k], shifted)) << (4 * k);
  }
  c.starts = m & low_bits(c.v);
  return c;
}

// What a thread writes, as bit masks over its bytes: subs, the sub-run
// starts; esc, the sub-run starts written as a triple; lit, the bytes
// written as themselves. Its output is, byte by byte in order, the triple
// at each esc bit and the byte at each lit bit.
struct Plan {
  uint32_t subs, esc, lit;
};

// rs: the last run start before the thread's bytes (-1 at a row's first
// byte); nxt: the first run start after them, or the row's length, or a
// bound at least 254 bytes past the tile's end, whichever comes first.
__device__ __forceinline__ Plan plan(const Chunk& c, int rs, int nxt) {
  const uint32_t valid = low_bits(c.v);
  uint32_t subs = c.starts;
  bool carried_esc = false;  // the sub-run of the thread's first byte started
                             // before it and is escaped
  const int first = c.starts ? __ffs(c.starts) - 1 : ITEMS;
  if (first > 0 && c.v > 0) {
    // the run in force splits at rs + 255 m: at most once in 32 bytes
    const int m = (c.j0 - rs) % MAX_RUN;
    if (m == 0) {
      subs |= 1u;
    } else {
      if (MAX_RUN - m < min(first, c.v)) subs |= 1u << (MAX_RUN - m);
      const int s = c.j0 - m;  // the start of the first byte's sub-run
      const int end = subs ? c.j0 + __ffs(subs) - 1 : min(nxt, s + MAX_RUN);
      carried_esc = end - s >= MIN_ESCAPE_RUN || c.at(0) == 0;
    }
  }
  uint32_t zero = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    zero |= gather_bytes(~ne_bytes(c.w[k], 0u) & 0x80808080u) << (4 * k);
  // a sub-run is long where no boundary follows its start within 3 bytes
  const int dn = nxt - c.j0;
  const u64 bound = subs | ((unsigned)dn < 64u ? 1ull << dn : 0ull);
  const uint32_t lng =
      (uint32_t)~((bound >> 1) | (bound >> 2) | (bound >> 3));
  Plan pl;
  pl.subs = subs;
  pl.esc = subs & (lng | zero) & valid;
  // bytes inside escaped sub-runs: each escaped start, and the first byte
  // if its sub-run is carried and escaped, smeared up to the next sub-run
  // start (a segmented scan over 32 bits in 5 steps)
  uint32_t g = pl.esc | (carried_esc ? 1u : 0u);
  uint32_t pr = ~subs;
  g |= pr & (g << 1);
  pr &= pr << 1;
  g |= pr & (g << 2);
  pr &= pr << 2;
  g |= pr & (g << 4);
  pr &= pr << 4;
  g |= pr & (g << 8);
  pr &= pr << 8;
  g |= pr & (g << 16);
  pl.lit = valid & ~g;
  return pl;
}

// The length of the sub-run that starts at the thread's byte i.
__device__ __forceinline__ int sub_len(const Chunk& c, uint32_t subs, int i,
                                       int nxt) {
  const uint32_t later = subs & ~((2u << i) - 1u);
  const int next = later ? c.j0 + __ffs(later) - 1 : nxt;
  return min(next - (c.j0 + i), MAX_RUN);
}

// Decoupled look-back, run by one warp over the status words of a row's
// tiles before tile k: fold (sum, or max) the values of the tiles back to
// the nearest one that has published its prefix, its value included. A
// lane waits only while a tile between it and the nearest prefix has
// published nothing. A word holds its flag and its value, so one 64-bit
// access reads or writes both.
template <bool SUM>
__device__ __forceinline__ long long look_back(const u64* st, int k) {
  const int lane = threadIdx.x & 31;
  long long acc = 0;
  for (int end = k;; end -= 32) {
    const int t = end - 1 - lane;  // lane 0: the nearest tile
    u64 w = t >= 0 ? 0 : STATUS_PREFIX;
    unsigned prefix;
    for (;;) {
      if (!(w >> 62)) w = shafa_fsm::load_status(st + t);
      const unsigned known = __ballot_sync(FULL, (w >> 62) != 0);
      prefix = __ballot_sync(FULL, (w >> 62) == 2);
      // the lanes up to the nearest prefix, or all of them
      const unsigned upto = prefix ? (prefix & (0u - prefix)) * 2u - 1u
                                   : FULL;
      if ((known & upto) == upto) break;
    }
    const int last = prefix ? __ffs(prefix) - 1 : 31;
    long long v = lane <= last ? (long long)(w & STATUS_VALUE) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const long long o = __shfl_xor_sync(FULL, v, d);
      v = SUM ? v + o : max(v, o);
    }
    acc = SUM ? acc + v : max(acc, v);
    if (prefix) return acc;
  }
}

// Word w of a row's output, whose bytes are q: stored whole inside
// [g0, end), else only its bytes that lie there.
__device__ __forceinline__ void store_word(uint8_t* __restrict__ out,
                                           long long w, int4 q, long long g0,
                                           long long end) {
  const long long lo = 16 * w;
  if (lo >= g0 && lo + 16 <= end) {
    *reinterpret_cast<int4*>(out + lo) = q;
  } else {
    const uint32_t v[4] = {(uint32_t)q.x, (uint32_t)q.y, (uint32_t)q.z,
                           (uint32_t)q.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (lo + i >= g0 && lo + i < end)
        out[lo + i] = (uint8_t)(v[i >> 2] >> (8 * (i & 3)));
  }
}

// Adds a block's 256 bins of one row to hist and zeroes them; each thread
// takes one byte value.
__device__ __forceinline__ void flush_bins(uint32_t* bins,
                                           unsigned long long* hist) {
  static_assert(THREADS == 256, "a thread a byte value");
  if (const uint32_t count = bins[threadIdx.x]) {
    atomicAdd(hist + threadIdx.x, (unsigned long long)count);
    bins[threadIdx.x] = 0;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rle_enc_onepass(Args a) {
  extern __shared__ uint32_t s_bins[];  // (rows kept or 1, 256)
  __shared__ int4 stage[STAGE / 16];
  __shared__ int warp_max[WARPS];
  __shared__ int warp_min[WARPS];
  __shared__ int warp_sum[WARPS];
  __shared__ int s_halo, s_carry, s_tile, s_max_len;
  __shared__ long long s_base;
  uint8_t* const sbytes = reinterpret_cast<uint8_t*>(stage);
  uint32_t* const swords = reinterpret_cast<uint32_t*>(stage);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool keep = a.b <= KEEP_ROWS;
  for (int i = threadIdx.x; i < (keep ? a.b : 1) * 256; i += THREADS)
    s_bins[i] = 0;
  if (threadIdx.x == 0) s_max_len = 0;
  __syncthreads();
  int mine = 0;
  for (int r = threadIdx.x; r < a.b; r += THREADS)
    mine = max(mine, row_len(a, r));
  atomicMax(&s_max_len, mine);
  __syncthreads();
  // A block takes its next ticket once its tile's offset is known, and a
  // tile waits only on tiles of smaller tickets, so the smallest unfinished
  // tile always runs. (Taking it earlier, to fetch the next tile's bytes
  // while this one runs, made the later tiles of a row wait longer in
  // their look-backs: slower on the H100.)
  if (threadIdx.x == 0) s_tile = tile_of(a, atomicAdd(a.ticket, 1), s_max_len);
  __syncthreads();
  int t = s_tile;
  while (t < a.total) {
    const int row = t % a.b;
    const int k = t / a.b;
    const int tile0 = k * TILE;
    const int len = row_len(a, row);
    if (tile0 >= len) {  // past a row shorter than the longest
      __syncthreads();   // every thread has read s_tile
      if (threadIdx.x == 0)
        s_tile = tile_of(a, atomicAdd(a.ticket, 1), s_max_len);
      __syncthreads();
      t = s_tile;
      continue;
    }
    const int tile_end = tile0 + TILE;
    const Chunk c = load_chunk(a, row, tile0 + ITEMS * threadIdx.x, len);
    if (warp == 0) {
      // the first run start in the halo, else the halo's end
      const int halo_end = min(tile_end + HALO, len);
      int first = INT_MAX;
      if (lane < HALO_THREADS) {
        const Chunk h = load_chunk(a, row, tile_end + ITEMS * lane, halo_end);
        if (h.starts) first = h.j0 + __ffs(h.starts) - 1;
      }
      first = __reduce_min_sync(FULL, first);
      if (lane == 0) s_halo = min(first, halo_end);
    }
    // the last run start before the thread's bytes, and the first after
    int pre = c.starts ? c.j0 + 31 - __clz(c.starts) : -1;
    int suf = c.starts ? c.j0 + __ffs(c.starts) - 1 : INT_MAX;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, pre, d);
      if (lane >= d) pre = max(pre, o);
      const int u = __shfl_down_sync(FULL, suf, d);
      if (lane + d < 32) suf = min(suf, u);
    }
    if (lane == 31) warp_max[warp] = pre;
    if (lane == 0) warp_min[warp] = suf;
    int before = __shfl_up_sync(FULL, pre, 1);
    int after = __shfl_down_sync(FULL, suf, 1);
    if (lane == 0) before = -1;
    if (lane == 31) after = INT_MAX;
    __syncthreads();
    int tile_last = -1;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before = max(before, warp_max[w]);
      if (w > warp) after = min(after, warp_min[w]);
      tile_last = max(tile_last, warp_max[w]);
    }
    // carry 1: only a tile whose first byte continues a run needs it
    const bool need = warp_min[0] != tile0;
    const u64* st1 = a.status + (long long)row * a.n_tiles;
    if (warp == 0) {
      u64* mine1 = a.status + (long long)row * a.n_tiles + k;
      if (lane == 0)
        shafa_fsm::store_status(mine1, tile_last >= 0
            ? STATUS_PREFIX | (u64)(tile_last + 1) : STATUS_AGGREGATE);
      if (need) {
        const int carry = (int)look_back<false>(st1, k) - 1;
        if (lane == 0) {
          if (tile_last < 0)
            shafa_fsm::store_status(mine1, STATUS_PREFIX | (u64)(carry + 1));
          s_carry = carry;
        }
      }
    }
    if (need) {
      __syncthreads();
      before = max(before, s_carry);
    }
    const int nxt = min(after, s_halo);
    const Plan pl = plan(c, before, nxt);
    const int count = __popc(pl.lit) + 3 * __popc(pl.esc);
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int off = incl - count, tile_tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) off += warp_sum[w];
      tile_tot += warp_sum[w];
    }
    // the tile's count, for the later tiles of its row (carry 2)
    u64* st2 = a.status + (long long)(a.b + row) * a.n_tiles;
    if (threadIdx.x == 0)
      shafa_fsm::store_status(st2 + k, (k ? STATUS_AGGREGATE : STATUS_PREFIX)
                                           | (u64)tile_tot);
    // stage the thread's output from byte STAGE_LEAD + off on (the tile's
    // offset in its row is not needed for it), and count its bytes
    uint32_t* bins = s_bins + (keep ? row * 256 : 0);
    const int o = STAGE_LEAD + off;
    int zeros = 0;  // 0x00 bytes written: escape marks and 0x00 symbols
    if (pl.lit == ~0u) {
      // 32 literals: the thread's own bytes, as words shifted into place
      const int sh = o & 3;
      uint32_t* wp = swords + (o >> 2);
      if (sh == 0) {
#pragma unroll
        for (int m = 0; m < WORDS; ++m) wp[m] = c.w[m];
      } else {
#pragma unroll
        for (int m = 1; m < WORDS; ++m)
          wp[m] = __funnelshift_l(c.w[m - 1], c.w[m], 8 * sh);
        // the two edge words, shared with the neighbouring threads
        uint8_t* head = sbytes + o;
        uint8_t* tail = reinterpret_cast<uint8_t*>(wp + WORDS);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i < 4 - sh) head[i] = (uint8_t)(c.w[0] >> (8 * i));
          if (i < sh)
            tail[i] = (uint8_t)(c.w[WORDS - 1] >> (8 * (4 - sh + i)));
        }
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) atomicAdd(bins + c.at(i), 1u);
    } else if (pl.lit | pl.esc) {
      uint8_t* sb = sbytes + o;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const uint32_t sym = c.at(i);
        if (pl.esc >> i & 1u) {
          const int n = sub_len(c, pl.subs, i, nxt);
          sb[0] = 0;
          sb[1] = (uint8_t)sym;
          sb[2] = (uint8_t)n;
          sb += 3;
          if (sym) atomicAdd(bins + sym, 1u);
          atomicAdd(bins + n, 1u);
          zeros += sym ? 1 : 2;
        } else if (pl.lit >> i & 1u) {
          *sb++ = (uint8_t)sym;
          atomicAdd(bins + sym, 1u);
        }
      }
    }
    zeros = __reduce_add_sync(FULL, zeros);
    if (lane == 0 && zeros) atomicAdd(bins, (unsigned)zeros);
    // carry 2, while the other warps count and stage: the sum of the
    // counts of the row's earlier tiles
    if (warp == 0) {
      long long base = 0;
      if (k) {
        base = look_back<true>(st2, k);
        if (lane == 0)
          shafa_fsm::store_status(st2 + k,
                                  STATUS_PREFIX | (u64)(base + tile_tot));
      }
      if (lane == 0) {
        s_base = base;
        if (tile_end >= len) a.out_len[row] = base + tile_tot;
        s_tile = tile_of(a, atomicAdd(a.ticket, 1), s_max_len);
      }
    }
    __syncthreads();
    // the row's 16-byte words that hold the tile's bytes [g0, end): word w
    // starts at byte d = 16 w - g0 of the tile's output, staged at byte
    // STAGE_LEAD + d, read as 4-byte words shifted into place
    const long long g0 = s_base;
    const long long end = g0 + tile_tot;
    uint8_t* orow = a.out + (long long)row * a.out_stride;
    if (tile_tot > 0) {
      for (long long w = (g0 >> 4) + threadIdx.x; 16 * w < end;
           w += THREADS) {
        const int d = STAGE_LEAD + (int)(16 * w - g0);
        const uint32_t* sw = swords + (d >> 2);
        const int sh = 8 * (d & 3);
        const int4 q = make_int4((int)__funnelshift_r(sw[0], sw[1], sh),
                                 (int)__funnelshift_r(sw[1], sw[2], sh),
                                 (int)__funnelshift_r(sw[2], sw[3], sh),
                                 (int)__funnelshift_r(sw[3], sw[4], sh));
        store_word(orow, w, q, g0, end);
      }
    }
    if (!keep) flush_bins(s_bins, a.hist + (long long)row * 256);
    t = s_tile;
  }
  if (keep) {
    __syncthreads();
    for (int r = 0; r < a.b; ++r)
      flush_bins(s_bins + r * 256, a.hist + (long long)r * 256);
  }
}

// Devices whose resident block counts launch() keeps; others ask each time.
constexpr int MAX_DEVICES = 64;

// Persistent blocks: as many as fit on the current device at once (their
// shared bins depend on the rows kept), at most one a tile. The counts are
// kept per device and rows kept; a race writes the same value twice.
int launch(Args a, cudaStream_t stream) {
  static std::atomic<int> resident[MAX_DEVICES][KEEP_ROWS + 1];
  const int kept = a.b <= KEEP_ROWS ? a.b : 0;
  const size_t smem = (size_t)(kept ? kept : 1) * 256 * sizeof(uint32_t);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int fit = dev < MAX_DEVICES ? resident[dev][kept].load() : 0;
  if (!fit) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rle_enc_onepass,
                                                  THREADS, smem);
    SHAFA_RETURN_IF_LAUNCH_FAILED();
    fit = per_sm * sms;
    if (dev < MAX_DEVICES) resident[dev][kept].store(fit);
  }
  const int blocks = std::max(1, std::min(a.total, fit));
  rle_enc_onepass<<<blocks, THREADS, smem, stream>>>(a);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Input bytes per tile: the wrapper sizes the look-back scratch with it.
int shafa_rle_encode_tile_bytes() { return TILE; }

// x: (B, P) u8, P a multiple of 16 below 2^30, 16-byte aligned; lens: (B,)
// i32; status: 2 * B * ceil(P / TILE) + 1 u64 scratch (the look-back's
// words, then the ticket); out: (B, out_stride) u8, 16-byte aligned,
// out_stride a multiple of 16 of at least 2P + 8; out_len: (B,) i64; hist:
// (B, 256) i64. Scratch, out_len and hist are zeroed here on the stream.
int shafa_rle_encode(const uint8_t* x, const int* lens, int b, long long p,
                     u64* status, uint8_t* out, long long out_stride,
                     long long* out_len, long long* hist,
                     cudaStream_t stream) {
  if (b <= 0) return 0;
  if (p <= 0 || p % 16 || p >= (1ll << 30) || out_stride % 16
      || out_stride < 2 * p + 8 || !aligned16(x) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (p + TILE - 1) / TILE;
  // the ticket runs past total by up to one a block
  if ((long long)b * n_tiles >= INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const int total = (int)(b * n_tiles);
  const Args a{x, lens, p, b, (int)n_tiles, total, status,
               reinterpret_cast<int*>(status + 2ll * total), out, out_stride,
               out_len, reinterpret_cast<unsigned long long*>(hist)};
  cudaError_t err = cudaMemsetAsync(status, 0,
                                    (2 * (size_t)total + 1) * sizeof(u64),
                                    stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out_len, 0, (size_t)b * sizeof(long long), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(hist, 0, (size_t)b * 256 * sizeof(long long),
                          stream);
  if (err != cudaSuccess) return (int)err;
  return launch(a, stream);
}

}  // extern "C"
