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
// Bound on the H100: device-memory bytes (the 32 B of planes per payload
// byte are read three times; K7 also writes 16 B of packs) and the 16-nibble
// function compositions.
//
// Design: the TPU kernels walk a row's tiles in order and carry the entry
// state and the symbol count in SMEM. Here each carry is a scan across
// tiles. A byte's transition function packs into one u64 (16 nibbles), and
// composition is associative, so:
//   A  each tile composes its bytes' functions (block scan);
//   B  one warp per row scans the tile functions -> every tile's entry state;
//   C  each tile turns its entry state into every byte's entry state (block
//      scan of functions), keeps it (1 B per byte) and counts its symbols;
//   D  scan.cu scans the tile counts -> every tile's first output position;
//   E  (K3) each byte replays its symbols from its entry state and writes
//      those below the row's count at their output positions;
//   E' (K7) each byte replays its symbols and writes its packs, clipped at
//      the row's count.
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int ITEMS = 4;               // consecutive payload bytes per thread
constexpr int TILE = THREADS * ITEMS;  // payload bytes per block
constexpr u64 IDENT = 0xFEDCBA9876543210ull;

__device__ __forceinline__ int apply_fn(u64 f, int q) {
  return (int)((f >> (4 * q)) & 15);
}

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

using ReplayScan = cub::BlockScan<int, THREADS>;

// E and E': replay of the thread's ITEMS bytes from their stored entry
// states (symbol k of item i in byte k of sym[i], their count in nb[i]);
// returns the row position of the thread's first symbol.
__device__ __forceinline__ long long replay_items(
    const Args& a, const uint8_t* __restrict__ ent,
    const long long* __restrict__ tile_off, long long plen,
    int (&nb)[ITEMS], u64 (&sym)[ITEMS], ReplayScan::TempStorage& tmp) {
  const int row = blockIdx.y;
  const long long tile0 = (long long)blockIdx.x * TILE;
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
  return tile_off[(long long)row * a.n_tiles + blockIdx.x] + excl;
}

// E (K3): replay and write the symbols below the row's count.
__global__ void __launch_bounds__(THREADS)
fsm_tile_emit(Args a, const uint8_t* __restrict__ ent,
              const long long* __restrict__ tile_off,
              const long long* __restrict__ totals, uint8_t* __restrict__ out,
              long long out_stride, int* __restrict__ under) {
  __shared__ ReplayScan::TempStorage tmp;
  const int row = blockIdx.y;
  const long long count = a.counts[row];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    under[row] = totals[row] < count ? 1 : 0;
  const long long plen = a.plens[row];
  if ((long long)blockIdx.x * TILE >= plen) return;
  int nb[ITEMS];
  u64 sym[ITEMS];
  long long before = replay_items(a, ent, tile_off, plen, nb, sym, tmp);
  uint8_t* dst = out + row * out_stride;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long allowed =
        min(max(min(count, out_stride) - before, 0ll), (long long)nb[i]);
    for (int k = 0; k < allowed; ++k)
      dst[before + k] = (uint8_t)(sym[i] >> (8 * k));
    before += nb[i];
  }
}

// The first n of four symbols, MSB first: byte k of v (symbol k) goes to
// bits 31-8k, and the bits past the n symbols are zero.
__device__ __forceinline__ uint32_t msb_first(uint32_t v, long long n) {
  return n > 0 ? shafa_bswap32(v) & (0xFFFFFFFFu << (32 - 8 * (int)n)) : 0u;
}

// E' (K7): replay and write the packs; lanes past the row's payload get
// zeros.
__global__ void __launch_bounds__(THREADS)
fsm_tile_packs(Args a, const uint8_t* __restrict__ ent,
               const long long* __restrict__ tile_off,
               const long long* __restrict__ totals, int* __restrict__ packs,
               int* __restrict__ under) {
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
  long long before = replay_items(a, ent, tile_off, plen, nb, sym, tmp);
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

// A-D of one call: entry states in ent, first output positions in tile_off,
// symbols per row in totals.
int entry_states(const Args& a, int b, dim3 grid, u64* tile_fn,
                 int* tile_entry, long long* tile_cnt, long long* tile_off,
                 long long* totals, uint8_t* ent, cudaStream_t stream) {
  fsm_tile_fn<<<grid, THREADS, 0, stream>>>(a, tile_fn);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  fsm_tile_entry<<<b, 32, 0, stream>>>(tile_fn, tile_entry, a.n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  fsm_tile_count<<<grid, THREADS, 0, stream>>>(a, tile_entry, ent, tile_cnt);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return shafa_row_exclusive_scan(tile_cnt, tile_off, totals, b, a.n_tiles,
                                  stream);
}

}  // namespace

extern "C" {

// Bytes per tile: the wrappers size the (B, n_tiles) scratch with it.
int shafa_fsm_tile_bytes() { return TILE; }

// K3. ls8: (8, B*P); plens, counts: (B,); tile_fn (u64), tile_entry (i32),
// tile_cnt, tile_off (i64): (B, n_tiles) scratch; totals: (B,) i64 scratch;
// ent: (B, P) u8 scratch; out: (B, out_stride) u8, rows cut at out_stride;
// under: (B,) i32.
int shafa_fsm_decode(const int* ls8, const int* plens, const int* counts,
                     int s_states, int b, long long p, u64* tile_fn,
                     int* tile_entry, long long* tile_cnt, long long* tile_off,
                     long long* totals, uint8_t* ent, uint8_t* out,
                     long long out_stride, int* under, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (s_states != 8 && s_states != 16) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const Args a{ls8, plens, counts, s_states, p, (long long)b * p, n_tiles};
  const dim3 grid(n_tiles, b);
  const int rc = entry_states(a, b, grid, tile_fn, tile_entry, tile_cnt,
                              tile_off, totals, ent, stream);
  if (rc) return rc;
  fsm_tile_emit<<<grid, THREADS, 0, stream>>>(a, ent, tile_off, totals, out,
                                              out_stride, under);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// K7. Arguments as shafa_fsm_decode's; packs: (4, B, P) i32 (val1, val2,
// len1, len2) in place of out.
int shafa_fsm_packs(const int* ls8, const int* plens, const int* counts,
                    int s_states, int b, long long p, u64* tile_fn,
                    int* tile_entry, long long* tile_cnt, long long* tile_off,
                    long long* totals, uint8_t* ent, int* packs, int* under,
                    cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (s_states != 8 && s_states != 16) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const Args a{ls8, plens, counts, s_states, p, (long long)b * p, n_tiles};
  const dim3 grid(n_tiles, b);
  const int rc = entry_states(a, b, grid, tile_fn, tile_entry, tile_cnt,
                              tile_off, totals, ent, stream);
  if (rc) return rc;
  fsm_tile_packs<<<grid, THREADS, 0, stream>>>(a, ent, tile_off, totals,
                                               packs, under);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
