// K3 and K7: the "bits to the next boundary" state machine of the prefix
// decode, for codes of at most 16 bits.
//
// K3 replaces shafa_tpu/kernels/decode.py::_stage2_kernel_v5 (pallas_call at
// decode.py:1373), K7 replaces decode.py::_stage2_kernel_v4 (pallas_call at
// decode.py:1413). Input: K2's planes, ls8[s, r*P + j] = sym | len << 8 of
// the code starting at bit 8j+s. The state before payload byte j is the
// number of bits until the next symbol boundary, in [0, S) for S = 8 or 16.
// A byte maps entry state q >= 8 to q - 8 and q < 8 to E[q], the state at
// the byte's end after the chain of codes that starts at bit q
// (decode.py:1175-1186, :960-967; lengths are `& 31` clipped to [1, S]).
// From its entry state a byte replays at most 8 ordered symbols, clipped at
// out_counts; a row whose payload holds fewer symbols than its count
// underruns. K3 writes the symbols straight into the row. K7 writes them as
// two packs per byte (val1: the first four, val2: the rest, MSB first;
// len1 / len2 their bits), which K1's bits variant concatenates; lanes past
// the row's payload get zero packs.
//
// Bound on the H100: device-memory bytes (32 B of planes per payload byte,
// read twice by K3 and three times by K7; K7 also writes 16 B of packs) and
// the 16-state function compositions. A function of the 16 states packs
// into one u64, the image of state s in nibble s.
//
// K3's design is K6's (fsm32.cu), with 2048-byte tiles:
//   A  each tile composes its bytes' functions: warp reductions in lane
//      order, then thread 0 over the warp aggregates;
//   B  one block per row turns the tile functions into every tile's entry
//      state (EntryStates over chunks of 4096 tiles);
//   P  each tile turns its entry state into every byte's (EntryStates: a
//      warp scan of functions, one thread walking the state through the
//      warp aggregates), replays the bytes' symbols into registers, takes
//      its first output position from a decoupled look-back over its row's
//      earlier tiles' symbol counts (fsm_common.cuh), stages its symbols in
//      shared memory at their offsets within the tile, and writes them out
//      as whole words: plain stores inside its span of the zeroed row,
//      atomicOr on the two edge words it may share with its neighbours.
// Compositions are byte permutes: a function's nibbles index a table of 8
// bytes per permute (compose, then_byte). Unlike K6, a thread owns two
// groups of 4 consecutive bytes, at tile lanes 4t and 4(t + THREADS), not
// 8 consecutive bytes: a group's lanes of a plane are one int4, so a
// warp's loads cover 512 contiguous bytes without staging the planes in
// shared memory (measured faster: the 16-state functions are cheap enough
// to scan once per group index).
//
// K7 keeps the passes of the first port (namespace k7): A composes each
// 1024-byte tile's function (CUB block scan), B walks a row's tiles with one
// warp, C stores every byte's entry state and counts each tile's symbols,
// D (scan.cu) scans the tile counts, E' replays each byte and writes its
// packs.
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "fsm_common.cuh"

namespace {

using u64 = shafa_fsm::u64;

constexpr u64 IDENT = 0xFEDCBA9876543210ull;

__device__ __forceinline__ int apply_fn(u64 f, int q) {
  return (int)((f >> (4 * q)) & 15);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

namespace k3 {

using shafa_fsm::Byte;
using shafa_fsm::byte_at;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 2;                   // 4-byte groups per thread
constexpr int TILE = 4 * THREADS * GROUPS;  // payload bytes per block

// Eight byte values < 16 (b0: images 0-3, b1: images 4-7) -> 8 nibbles.
__device__ __forceinline__ uint32_t pack_nibbles(uint32_t b0, uint32_t b1) {
  return __byte_perm(b0 | (b0 >> 4), b1 | (b1 >> 4), 0x6420u);
}

// 8 nibbles -> 8 bytes (b0: nibbles 0-3, b1: nibbles 4-7).
__device__ __forceinline__ void spread_nibbles(uint32_t w, uint32_t& b0,
                                               uint32_t& b1) {
  const uint32_t even = w & 0x0F0F0F0Fu;
  const uint32_t odd = (w >> 4) & 0x0F0F0F0Fu;
  b0 = __byte_perm(even, odd, 0x5140u);
  b1 = __byte_perm(even, odd, 0x7362u);
}

// "a then c": the state after a byte (or run of bytes) with function a,
// then one with c. c's 16 images become 16 bytes; the low 3 bits of each
// image a(s) pick a byte of c's first and of its last 8 (a selector nibble
// of a byte permute is the image with bit 3 cleared), bit 3 picks between
// the two.
__device__ __forceinline__ u64 compose(u64 a, u64 c) {
  uint32_t c0, c1, c2, c3;
  spread_nibbles((uint32_t)c, c0, c1);
  spread_nibbles((uint32_t)(c >> 32), c2, c3);
  uint32_t r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = (uint32_t)(a >> (32 * h));
    uint32_t q[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t idx = x >> (16 * k);  // 4 images in the low 16 bits
      const uint32_t sel = idx & 0x7777u;
      const uint32_t lo = __byte_perm(c0, c1, sel);
      const uint32_t hi = __byte_perm(c2, c3, sel);
      q[k] = __byte_perm(lo, hi, 0x3210u + ((idx >> 1) & 0x4444u));
    }
    r[h] = pack_nibbles(q[0], q[1]);
  }
  return ((u64)r[1] << 32) | r[0];
}

// "g then the byte whose E is (e_lo, e_hi)": each image x = g(s) becomes
// E[x] (a byte permute over E's 8 bytes) where x < 8 and x - 8 elsewhere.
__device__ __forceinline__ u64 then_byte(u64 g, uint32_t e_lo,
                                         uint32_t e_hi) {
  uint32_t r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = (uint32_t)(g >> (32 * h));
    const uint32_t ex =
        pack_nibbles(__byte_perm(e_lo, e_hi, x & 0x7777u),
                     __byte_perm(e_lo, e_hi, (x >> 16) & 0x7777u));
    const uint32_t mask = ((x >> 3) & 0x11111111u) * 0xFu;  // images >= 8
    r[h] = (x & 0x77777777u & mask) | (ex & ~mask);
  }
  return ((u64)r[1] << 32) | r[0];
}

// Four lengths (one per byte) `& 31`, clipped to [1, S].
struct ClipLens {
  uint32_t s4;  // S in each byte
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return __vmaxu4(__vminu4(x & 0x1F1F1F1Fu, s4), 0x01010101u);
  }
};

// The function of the 4 bytes from payload byte j on (bytes past plen
// left out).
__device__ __forceinline__ u64 group_fn(const Byte (&by)[4], long long j,
                                        long long plen) {
  u64 g = IDENT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (j + i < plen) {
      uint32_t e_lo, e_hi;
      shafa_fsm::byte_e(by[i], e_lo, e_hi);
      g = then_byte(g, e_lo, e_hi);
    }
  }
  return g;
}

// Replay of a byte entered in state q: symbol k of the byte in byte k of
// (lo, hi), their count returned, q left at the next byte's entry state.
__device__ __forceinline__ int replay(const Byte& by, int& q, uint32_t& lo,
                                      uint32_t& hi) {
  u64 a = 0;
  int n = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (q >= 8) break;
    a |= (u64)byte_at(by.sym_lo, by.sym_hi, q) << (8 * n);
    q += (int)byte_at(by.len_lo, by.len_hi, q);
    ++n;
  }
  q -= 8;
  lo = (uint32_t)a;
  hi = (uint32_t)(a >> 32);
  return n;
}

// Inclusive scan of the functions of a warp's first WIDTH lanes in lane
// order: lane l gets lanes 0..l composed, lane 0's first.
template <int WIDTH>
__device__ __forceinline__ u64 warp_scan_fn(u64 f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < WIDTH; d <<= 1) {
    const u64 g = __shfl_up_sync(0xFFFFFFFFu, f, d);
    if (lane >= d) f = compose(g, f);
  }
  return f;
}

// A block's exclusive scan of its threads' functions, applied to the
// block's entry state: every thread's entry state. A warp scans its
// functions; one thread walks the state through the N warp aggregates;
// each thread applies its warp's exclusive prefix to its warp's entry
// state.
template <int N>
struct EntryStates {
  u64 warp_fn[N];
  int warp_entry[N];

  // entry: the block's entry state, read by thread 0 only. Returns the
  // carried state after the whole block (thread 0 only).
  __device__ __forceinline__ int run(u64 g, int entry, int& q) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const u64 incl = warp_scan_fn<32>(g);
    u64 excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    if (lane == 0) excl = IDENT;
    if (lane == 31) warp_fn[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < N; ++w) {
        warp_entry[w] = entry;
        entry = apply_fn(warp_fn[w], entry);
      }
    }
    __syncthreads();
    q = apply_fn(excl, warp_entry[warp]);
    return entry;
  }
};

struct Args {
  const int* ls8;     // (8, B*P)
  const int* plens;   // (B,) payload bytes per row
  const int* counts;  // (B,) symbols to decode per row
  ClipLens clip;
  long long p;        // payload bytes per row of the planes
  long long n;        // B * P
  int n_tiles;
};

// The 4 bytes of a group from lane on (r*P + j, j a multiple of 4): int4
// loads of the 8 planes, streamed past the caches (no pass reads them
// again before they are evicted).
__device__ __forceinline__ void load_group(const Args& a, long long lane,
                                           Byte (&by)[4]) {
  int4 v[8];
#pragma unroll
  for (int b = 0; b < 8; ++b)
    v[b] = __ldcs(reinterpret_cast<const int4*>(a.ls8 + b * a.n + lane));
  const int x[8][4] = {
      {v[0].x, v[0].y, v[0].z, v[0].w}, {v[1].x, v[1].y, v[1].z, v[1].w},
      {v[2].x, v[2].y, v[2].z, v[2].w}, {v[3].x, v[3].y, v[3].z, v[3].w},
      {v[4].x, v[4].y, v[4].z, v[4].w}, {v[5].x, v[5].y, v[5].z, v[5].w},
      {v[6].x, v[6].y, v[6].z, v[6].w}, {v[7].x, v[7].y, v[7].z, v[7].w}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    by[i].len_lo = a.clip(
        shafa_fsm::gather4(x[0][i], x[1][i], x[2][i], x[3][i], 0x0051u));
    by[i].len_hi = a.clip(
        shafa_fsm::gather4(x[4][i], x[5][i], x[6][i], x[7][i], 0x0051u));
    by[i].sym_lo =
        shafa_fsm::gather4(x[0][i], x[1][i], x[2][i], x[3][i], 0x0040u);
    by[i].sym_hi =
        shafa_fsm::gather4(x[4][i], x[5][i], x[6][i], x[7][i], 0x0040u);
  }
}

// Composition of a warp's functions in lane order (lane 0 gets the result).
__device__ __forceinline__ u64 warp_reduce_fn(u64 f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 g = __shfl_down_sync(0xFFFFFFFFu, f, d);
    if (lane + d < 32) f = compose(f, g);
  }
  return f;
}

// A: composed transition function of each tile. Each warp composes its
// groups in lane order, group by group; thread 0 composes the warp
// aggregates in (group, warp) order.
__global__ void __launch_bounds__(THREADS)
fsm16_tile_fn(Args a, u64* __restrict__ tile_fn) {
  __shared__ u64 warp_fn[GROUPS][WARPS];
  const int row = blockIdx.y;
  const long long t = (long long)row * a.n_tiles + blockIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long plen = a.plens[row];
  if (tile0 >= plen) {
    if (threadIdx.x == 0) tile_fn[t] = IDENT;
    return;
  }
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
    const long long j = tile0 + 4 * (threadIdx.x + THREADS * h);
    u64 g = IDENT;
    if (j < plen) {
      Byte by[4];
      load_group(a, row * a.p + j, by);
      g = group_fn(by, j, plen);
    }
    g = warp_reduce_fn(g);
    if ((threadIdx.x & 31) == 0) warp_fn[h][threadIdx.x >> 5] = g;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 f = IDENT;
    for (int h = 0; h < GROUPS; ++h)
      for (int w = 0; w < WARPS; ++w) f = compose(f, warp_fn[h][w]);
    tile_fn[t] = f;
  }
}

// B: entry state of every tile (row state starts at 0). One block per row
// walks it in chunks of B_THREADS * B_ITEMS tiles: each thread composes
// B_ITEMS consecutive tile functions, EntryStates gives each thread's entry
// state, and the thread walks it through its tiles.
constexpr int B_THREADS = 512;
constexpr int B_ITEMS = 8;

__global__ void __launch_bounds__(B_THREADS)
fsm16_tile_entry(const u64* __restrict__ tile_fn,
                 int* __restrict__ tile_entry, int n_tiles) {
  __shared__ EntryStates<B_THREADS / 32> es;
  __shared__ int carry;
  const long long row0 = (long long)blockIdx.x * n_tiles;
  if (threadIdx.x == 0) carry = 0;
  for (int base = 0; base < n_tiles; base += B_THREADS * B_ITEMS) {
    const int t0 = base + threadIdx.x * B_ITEMS;
    u64 f[B_ITEMS];
    u64 g = IDENT;
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      f[i] = t0 + i < n_tiles ? tile_fn[row0 + t0 + i] : IDENT;
      g = compose(g, f[i]);
    }
    __syncthreads();  // es and carry are reused
    int q;
    const int out = es.run(g, carry, q);
    if (threadIdx.x == 0) carry = out;
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      if (t0 + i < n_tiles) tile_entry[row0 + t0 + i] = q;
      q = apply_fn(f[i], q);
    }
  }
}

// The tile's symbols, staged at byte d + (their index within the tile) of
// sbuf, as whole words of the row: its bytes [before, end) from word
// before / 4 on. Words inside the span are stored; the edge words, which a
// neighbouring tile may share, are OR-ed into the zeroed row with only the
// span's bytes set. Thread t writes words t + THREADS * k, so a warp's
// stores cover 128 contiguous bytes.
__device__ __forceinline__ void write_symbols(const uint32_t* sbuf,
                                              uint32_t* __restrict__ dst,
                                              long long before,
                                              long long end) {
  const long long w0 = before >> 2;
  const long long w1 = (end + 3) >> 2;
  for (long long w = w0 + threadIdx.x; w < w1; w += THREADS) {
    const uint32_t v = sbuf[w - w0];
    const long long lo = 4 * w;
    if (lo >= before && lo + 4 <= end) {
      dst[w] = v;
    } else {
      const int a0 = (int)max(before - lo, 0ll);  // first byte kept
      const int a1 = (int)min(end - lo, 4ll);     // one past the last
      const uint32_t keep = (a1 == 4 ? 0xFFFFFFFFu : (1u << (8 * a1)) - 1u) &
                            ~((1u << (8 * a0)) - 1u);
      atomicOr(dst + w, v & keep);
    }
  }
}

// P: every byte's entry state, replay, the look-back, the symbols below
// min(count, out_stride) into the zeroed row, and the underrun flag,
// written by the tile that holds the row's last payload byte (tile 0 of a
// row without payload). The groups' entry states come from one
// EntryStates run per group index, the state carried from one to the next.
__global__ void __launch_bounds__(THREADS)
fsm16_tile_rows(Args a, const int* __restrict__ tile_entry,
                u64* __restrict__ status, int* __restrict__ ticket,
                uint8_t* __restrict__ out, long long out_stride,
                int* __restrict__ under) {
  using CountScan = cub::BlockScan<int, THREADS>;
  __shared__ uint32_t sbuf[(8 * TILE + 8) / 4];  // at most 8 symbols a byte
  __shared__ EntryStates<WARPS> es;
  __shared__ typename CountScan::TempStorage scan;
  __shared__ int tile_id;
  __shared__ long long tile_before;
  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = tile_id;
  const int row = t / a.n_tiles;
  const int k = t - row * a.n_tiles;
  const long long tile0 = (long long)k * TILE;
  const long long plen = a.plens[row];
  const long long count = a.counts[row];
  if (tile0 >= plen) {
    if (k == 0 && threadIdx.x == 0) under[row] = count > 0 ? 1 : 0;
    return;
  }
  int carry = threadIdx.x == 0 ? tile_entry[t] : 0;
  Byte by[GROUPS][4];
  int q[GROUPS];
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
    const long long j = tile0 + 4 * (threadIdx.x + THREADS * h);
    u64 g = IDENT;
    if (j < plen) {
      load_group(a, row * a.p + j, by[h]);
      g = group_fn(by[h], j, plen);
    }
    carry = es.run(g, carry, q[h]);
  }
  uint32_t sym_lo[GROUPS][4], sym_hi[GROUPS][4];
  uint32_t nbs[GROUPS];
  int excl[GROUPS], tot[GROUPS];
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
    const long long j = tile0 + 4 * (threadIdx.x + THREADS * h);
    nbs[h] = 0;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sym_lo[h][i] = sym_hi[h][i] = 0;
      if (j + i < plen) {
        const int n = replay(by[h][i], q[h], sym_lo[h][i], sym_hi[h][i]);
        nbs[h] |= (uint32_t)n << (4 * i);
        cnt += n;
      }
    }
    if (h) __syncthreads();  // scan is reused
    CountScan(scan).ExclusiveSum(cnt, excl[h], tot[h]);
  }
  int tile_cnt = 0;
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
    excl[h] += tile_cnt;
    tile_cnt += tot[h];
  }
  if (threadIdx.x < 32) {
    const long long b = shafa_fsm::look_back(
        status + (long long)row * a.n_tiles, k, tile_cnt);
    if (threadIdx.x == 0) {
      tile_before = b;
      if (plen <= tile0 + TILE) under[row] = b + tile_cnt < count ? 1 : 0;
    }
  }
  __syncthreads();
  // the symbols at their offsets within the tile, after before & 3 bytes,
  // so that sbuf's words are the row's
  const long long before = tile_before;
  uint8_t* sb = reinterpret_cast<uint8_t*>(sbuf);
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
    int pos = (int)(before & 3) + excl[h];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nb = (int)((nbs[h] >> (4 * i)) & 15u);
      for (int s = 0; s < nb; ++s)
        sb[pos + s] = (uint8_t)((s < 4 ? sym_lo[h][i] : sym_hi[h][i]) >>
                                (8 * (s & 3)));
      pos += nb;
    }
  }
  __syncthreads();
  const long long end = min(before + tile_cnt, min(count, out_stride));
  if (end > before)
    write_symbols(sbuf, reinterpret_cast<uint32_t*>(out + row * out_stride),
                  before, end);
}

}  // namespace k3

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

namespace k7 {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;               // consecutive payload bytes per thread
constexpr int TILE = THREADS * ITEMS;  // payload bytes per block

// "a then c": the state after a byte with function a, then one with c.
__device__ __forceinline__ u64 compose(u64 a, u64 c) {
  u64 r = 0;
#pragma unroll
  for (int s = 0; s < 16; ++s)
    r |= (u64)apply_fn(c, apply_fn(a, s)) << (4 * s);
  return r;
}

struct Compose {
  __device__ __forceinline__ u64 operator()(u64 a, u64 c) const {
    return compose(a, c);
  }
};

struct Byte {
  uint32_t lens;  // nibble b: (code length at bit b) - 1, length clipped to [1, S]
  u64 syms;       // byte b: symbol of the code at bit b
};

__device__ __forceinline__ Byte load_byte(const int* __restrict__ ls8,
                                          long long n, long long lane,
                                          int s_states) {
  Byte by{0u, 0ull};
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int ls = ls8[b * n + lane];
    const int len = min(max((ls >> 8) & 31, 1), s_states);
    by.lens |= (uint32_t)(len - 1) << (4 * b);
    by.syms |= (u64)(ls & 255) << (8 * b);
  }
  return by;
}

__device__ __forceinline__ int code_len(const Byte& by, int q) {
  return (int)((by.lens >> (4 * q)) & 15) + 1;
}

// Transition function of one byte: q < 8 -> E[q], q >= 8 -> q - 8.
__device__ __forceinline__ u64 byte_fn(const Byte& by, int s_states) {
  uint32_t e_packed = 0;
#pragma unroll
  for (int bit = 7; bit >= 0; --bit) {
    const int nb = bit + code_len(by, bit);
    const int e = nb >= 8 ? nb - 8 : (int)((e_packed >> (4 * nb)) & 15);
    e_packed |= (uint32_t)min(max(e, 0), s_states - 1) << (4 * bit);
  }
  return ((u64)0x76543210u << 32) | e_packed;
}

// Replay of a byte entered in state q: symbol k of the byte in byte k of
// *syms (when given), the number of symbols returned.
__device__ __forceinline__ int replay(const Byte& by, int q, u64* syms) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (q < 8) {
      if (syms) *syms |= ((by.syms >> (8 * q)) & 255) << (8 * n);
      q += code_len(by, q);
      ++n;
    }
  }
  return n;
}

struct Args {
  const int* ls8;         // (8, B*P)
  const int* plens;       // (B,) payload bytes per row
  const int* counts;      // (B,) symbols to decode per row
  int s_states;
  long long p;            // payload bytes per row of the planes
  long long n;            // B * P
  int n_tiles;
};

// A: composed transition function of each tile.
__global__ void __launch_bounds__(THREADS)
fsm_tile_fn(Args a, u64* __restrict__ tile_fn) {
  using Scan = cub::BlockScan<u64, THREADS>;
  __shared__ typename Scan::TempStorage tmp;
  const int row = blockIdx.y;
  const long long t = (long long)row * a.n_tiles + blockIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  if (tile0 >= a.plens[row]) {
    if (threadIdx.x == 0) tile_fn[t] = IDENT;
    return;
  }
  u64 g = IDENT;
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    if (j < a.p)
      g = compose(g, byte_fn(load_byte(a.ls8, a.n, row * a.p + j, a.s_states),
                             a.s_states));
  }
  u64 incl, agg;
  Scan(tmp).InclusiveScan(g, incl, Compose(), agg);
  if (threadIdx.x == 0) tile_fn[t] = agg;
}

// B: entry state of every tile (row state starts at 0). One warp per row.
__global__ void fsm_tile_entry(const u64* __restrict__ tile_fn,
                               int* __restrict__ tile_entry, int n_tiles) {
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += 32) {
    const int t = base + lane;
    u64 f = t < n_tiles ? tile_fn[row0 + t] : IDENT;
    for (int d = 1; d < 32; d <<= 1) {
      const u64 g = __shfl_up_sync(full, f, d);
      if (lane >= d) f = compose(g, f);
    }
    u64 before = __shfl_up_sync(full, f, 1);
    if (lane == 0) before = IDENT;
    if (t < n_tiles) tile_entry[row0 + t] = apply_fn(before, carry);
    carry = apply_fn(__shfl_sync(full, f, 31), carry);
  }
}

// C: entry state of every byte (kept in ent) and symbols per tile.
__global__ void __launch_bounds__(THREADS)
fsm_tile_count(Args a, const int* __restrict__ tile_entry,
               uint8_t* __restrict__ ent, long long* __restrict__ tile_cnt) {
  using Scan = cub::BlockScan<u64, THREADS>;
  using Reduce = cub::BlockReduce<int, THREADS>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  const int row = blockIdx.y;
  const long long t = (long long)row * a.n_tiles + blockIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long plen = a.plens[row];
  if (tile0 >= plen) {
    if (threadIdx.x == 0) tile_cnt[t] = 0;
    return;
  }
  Byte by[ITEMS];
  u64 f[ITEMS];
  u64 g = IDENT;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    by[i] = Byte{0u, 0ull};
    f[i] = IDENT;
    if (j < a.p) {
      by[i] = load_byte(a.ls8, a.n, row * a.p + j, a.s_states);
      f[i] = byte_fn(by[i], a.s_states);
    }
    g = compose(g, f[i]);
  }
  u64 excl, agg;
  Scan(tmp.scan).ExclusiveScan(g, excl, IDENT, Compose(), agg);
  int q = apply_fn(excl, tile_entry[t]);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    if (j < plen) {
      ent[row * a.p + j] = (uint8_t)q;
      cnt += replay(by[i], q, nullptr);
    }
    q = apply_fn(f[i], q);
  }
  __syncthreads();  // tmp is reused
  const int total = Reduce(tmp.reduce).Sum(cnt);
  if (threadIdx.x == 0) tile_cnt[t] = total;
}

// The first n of four symbols, MSB first: byte k of v (symbol k) goes to
// bits 31-8k, and the bits past the n symbols are zero.
__device__ __forceinline__ uint32_t msb_first(uint32_t v, long long n) {
  return n > 0 ? shafa_bswap32(v) & (0xFFFFFFFFu << (32 - 8 * (int)n)) : 0u;
}

// E': replay the thread's ITEMS bytes from their stored entry states and
// write the packs; lanes past the row's payload get zeros.
__global__ void __launch_bounds__(THREADS)
fsm_tile_packs(Args a, const uint8_t* __restrict__ ent,
               const long long* __restrict__ tile_off,
               const long long* __restrict__ totals, int* __restrict__ packs,
               int* __restrict__ under) {
  using ReplayScan = cub::BlockScan<int, THREADS>;
  __shared__ ReplayScan::TempStorage tmp;
  const int row = blockIdx.y;
  const long long count = a.counts[row];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    under[row] = totals[row] < count ? 1 : 0;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long plen = a.plens[row];
  int* val1 = packs + row * a.p;
  int* val2 = val1 + a.n;
  int* len1 = val2 + a.n;
  int* len2 = len1 + a.n;
  if (tile0 >= plen) {
    for (int i = 0; i < ITEMS; ++i) {
      const long long j = tile0 + threadIdx.x * ITEMS + i;
      if (j < a.p) val1[j] = val2[j] = len1[j] = len2[j] = 0;
    }
    return;
  }
  int nb[ITEMS];
  u64 sym[ITEMS];
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    nb[i] = 0;
    sym[i] = 0;
    if (j < plen) {
      nb[i] = replay(load_byte(a.ls8, a.n, row * a.p + j, a.s_states),
                     ent[row * a.p + j], &sym[i]);
      cnt += nb[i];
    }
  }
  int excl, agg;
  ReplayScan(tmp).ExclusiveSum(cnt, excl, agg);
  long long before = tile_off[(long long)row * a.n_tiles + blockIdx.x] + excl;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    if (j < a.p) {
      const long long allowed = min(max(count - before, 0ll), (long long)nb[i]);
      const long long n1 = min(allowed, 4ll);
      const long long n2 = max(allowed - 4, 0ll);
      val1[j] = (int)msb_first((uint32_t)sym[i], n1);
      val2[j] = (int)msb_first((uint32_t)(sym[i] >> 32), n2);
      len1[j] = (int)(8 * n1);
      len2[j] = (int)(8 * n2);
    }
    before += nb[i];
  }
}

}  // namespace k7

}  // namespace

extern "C" {

// Bytes per tile of K3 and of K7: the wrappers size the (B, n_tiles)
// scratch with them.
int shafa_fsm_decode_tile_bytes() { return k3::TILE; }
int shafa_fsm_packs_tile_bytes() { return k7::TILE; }

// K3. ls8: (8, B*P), P a multiple of 8; plens, counts: (B,); tile_fn: (B,
// n_tiles) u64, tile_entry: (B, n_tiles) i32, status: B * n_tiles + 1 u64
// (the look-back's words, then the ticket), all scratch; out: (B,
// out_stride) u8, zeroed by the caller, out_stride a multiple of 4; under:
// (B,) i32.
int shafa_fsm_decode(const int* ls8, const int* plens, const int* counts,
                     int s_states, int b, long long p, u64* tile_fn,
                     int* tile_entry, u64* status, uint8_t* out,
                     long long out_stride, int* under, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (s_states != 8 && s_states != 16) return (int)cudaErrorInvalidValue;
  if (p % 8 || out_stride % 4) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + k3::TILE - 1) / k3::TILE);
  const long long tiles = (long long)b * n_tiles;
  const k3::Args a{ls8, plens, counts, k3::ClipLens{0x01010101u * s_states},
                   p, (long long)b * p, n_tiles};
  k3::fsm16_tile_fn<<<dim3(n_tiles, b), k3::THREADS, 0, stream>>>(a, tile_fn);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  k3::fsm16_tile_entry<<<b, k3::B_THREADS, 0, stream>>>(tile_fn, tile_entry,
                                                        n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  // the look-back's words and the ticket start at 0
  const cudaError_t err =
      cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(u64), stream);
  if (err != cudaSuccess) return (int)err;
  k3::fsm16_tile_rows<<<(unsigned)tiles, k3::THREADS, 0, stream>>>(
      a, tile_entry, status, reinterpret_cast<int*>(status + tiles), out,
      out_stride, under);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// K7. ls8: (8, B*P); plens, counts: (B,); tile_fn (u64), tile_entry (i32),
// tile_cnt, tile_off (i64): (B, n_tiles) scratch; totals: (B,) i64 scratch;
// ent: (B, P) u8 scratch; packs: (4, B, P) i32 (val1, val2, len1, len2);
// under: (B,) i32.
int shafa_fsm_packs(const int* ls8, const int* plens, const int* counts,
                    int s_states, int b, long long p, u64* tile_fn,
                    int* tile_entry, long long* tile_cnt, long long* tile_off,
                    long long* totals, uint8_t* ent, int* packs, int* under,
                    cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (s_states != 8 && s_states != 16) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + k7::TILE - 1) / k7::TILE);
  const k7::Args a{ls8, plens, counts, s_states, p, (long long)b * p, n_tiles};
  const dim3 grid(n_tiles, b);
  k7::fsm_tile_fn<<<grid, k7::THREADS, 0, stream>>>(a, tile_fn);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  k7::fsm_tile_entry<<<b, 32, 0, stream>>>(tile_fn, tile_entry, a.n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  k7::fsm_tile_count<<<grid, k7::THREADS, 0, stream>>>(a, tile_entry, ent,
                                                       tile_cnt);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  const int rc = shafa_row_exclusive_scan(tile_cnt, tile_off, totals, b,
                                          a.n_tiles, stream);
  if (rc) return rc;
  k7::fsm_tile_packs<<<grid, k7::THREADS, 0, stream>>>(a, ent, tile_off,
                                                       totals, packs, under);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
