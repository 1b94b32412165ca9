// K6: the 32-state boundary machine of the prefix decode for codes of 17-32
// bits, with symbol replay and the count clip.
//
// Replaces shafa_tpu/kernels/decode.py::_stage2_kernel (v3, pallas_call at
// decode.py:820, run at s_states=32). Input: K5's planes, ls8[s, r*P + j] =
// sym | len << 8 of the code starting at bit 8j+s. The state before payload
// byte j is the number of bits until the next symbol boundary, in [0, 32).
// A byte maps entry state q >= 8 to q - 8 and q < 8 to E[q], the state at
// the byte's end after the chain of codes that starts at bit q
// (decode.py:665-672; lengths clipped to [1, 32], so E stays in [0, 31]).
// From its entry state a byte replays at most 8 ordered symbols. Those below
// the row's count go MSB first into two packs per byte (val1: the first
// four, val2: the rest; len1 / len2 their bits), which K1's bits variant
// concatenates into the decoded rows. A row whose payload holds fewer
// symbols than its count underruns.
//
// Bound on the H100: device-memory bytes (32 B of planes per payload byte,
// read three times, and 16 B of packs written) and the compositions of
// 32-state functions.
//
// Design: K3's three levels (fsm_decode.cu), the carries of the TPU kernel
// (SMEM entry state and running count, decode.py:649-727) turned into scans
// across tiles. K3 packs a function into 16 nibbles of a u64; 32 states of
// 5 bits do not fit, so here a function is 32 bytes (Fn: byte k of w[i] is
// the image of state 4i + k) and composition is a table lookup done with
// byte permutes (prmt): 7 per 4 states.
//   A  each tile composes its bytes' functions (block scan);
//   B  one warp per row scans the tile functions -> every tile's entry state;
//   C  each tile turns its entry state into every byte's entry state (block
//      scan of functions), keeps it (1 B per byte) and counts its symbols;
//   D  scan.cu scans the tile counts -> every tile's first output position;
//   E  each byte replays its symbols from its entry state and writes its
//      packs, clipped at the row's count (zero past the row's payload).
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;               // consecutive payload bytes per thread
constexpr int TILE = THREADS * ITEMS;  // payload bytes per block

// A function of the 32 states: byte k of w[i] is the image of state 4i + k.
struct Fn {
  uint32_t w[8];
};

__device__ __forceinline__ Fn identity() {
  Fn f;
#pragma unroll
  for (int i = 0; i < 8; ++i) f.w[i] = 0x03020100u + 0x04040404u * i;
  return f;
}

__device__ __forceinline__ int apply_fn(const Fn& f, int q) {
  uint32_t w = f.w[0];
#pragma unroll
  for (int i = 1; i < 8; ++i)
    if ((q >> 2) == i) w = f.w[i];
  return (int)((w >> (8 * (q & 3))) & 0xFFu);
}

// Four byte values < 16 -> the 4-nibble selector of a byte permute.
__device__ __forceinline__ uint32_t nibbles(uint32_t bytes) {
  const uint32_t t = bytes | (bytes >> 4);
  return (t & 0xFFu) | ((t >> 8) & 0xFF00u);
}

// "a then c": the state after a byte (or run of bytes) with function a,
// then one with c. Each image a(s) < 32 indexes c's 32 bytes: its low 3
// bits pick a byte within each pair of words, bit 3 the word of the pair,
// bit 4 the pair.
__device__ __forceinline__ Fn compose(const Fn& a, const Fn& c) {
  Fn r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t idx = a.w[i];
    const uint32_t lo = nibbles(idx & 0x07070707u);
    const uint32_t p0 = __byte_perm(c.w[0], c.w[1], lo);
    const uint32_t p1 = __byte_perm(c.w[2], c.w[3], lo);
    const uint32_t p2 = __byte_perm(c.w[4], c.w[5], lo);
    const uint32_t p3 = __byte_perm(c.w[6], c.w[7], lo);
    const uint32_t b3 = 0x3210u + 4u * nibbles((idx >> 3) & 0x01010101u);
    const uint32_t b4 = 0x3210u + 4u * nibbles((idx >> 4) & 0x01010101u);
    r.w[i] = __byte_perm(__byte_perm(p0, p2, b4), __byte_perm(p1, p3, b4),
                         b3);
  }
  return r;
}

struct Compose {
  __device__ __forceinline__ Fn operator()(const Fn& a, const Fn& c) const {
    return compose(a, c);
  }
};

struct Byte {
  u64 lens;  // byte b: length of the code at bit b, clipped to [1, 32]
  u64 syms;  // byte b: symbol of the code at bit b
};

__device__ __forceinline__ Byte load_byte(const int* __restrict__ ls8,
                                          long long n, long long lane) {
  Byte by{0ull, 0ull};
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int ls = ls8[b * n + lane];
    const int len = min(max((ls >> 8) & 63, 1), 32);
    by.lens |= (u64)len << (8 * b);
    by.syms |= (u64)(ls & 255) << (8 * b);
  }
  return by;
}

__device__ __forceinline__ int code_len(const Byte& by, int q) {
  return (int)((by.lens >> (8 * q)) & 0xFFu);
}

// Transition function of one byte: q < 8 -> E[q], q >= 8 -> q - 8.
__device__ __forceinline__ Fn byte_fn(const Byte& by) {
  u64 e = 0;  // byte b: E[b]
#pragma unroll
  for (int bit = 7; bit >= 0; --bit) {
    const int nb = bit + code_len(by, bit);
    const int x = nb >= 8 ? nb - 8 : (int)((e >> (8 * nb)) & 0xFFu);
    e |= (u64)x << (8 * bit);
  }
  Fn f;
  f.w[0] = (uint32_t)e;
  f.w[1] = (uint32_t)(e >> 32);
#pragma unroll
  for (int i = 2; i < 8; ++i) f.w[i] = 0x03020100u + 0x04040404u * (i - 2);
  return f;
}

// Replay of a byte entered in state q: its symbols MSB first into *syms (8
// B), their count returned, q left at the next byte's entry state.
__device__ __forceinline__ int replay(const Byte& by, int& q, u64* syms) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (q < 8) {
      if (syms) *syms |= ((by.syms >> (8 * q)) & 0xFFull) << (56 - 8 * n);
      q += code_len(by, q);
      ++n;
    }
  }
  q -= 8;
  return n;
}

__device__ __forceinline__ Fn shfl_up_fn(const Fn& f, int d) {
  Fn g;
#pragma unroll
  for (int i = 0; i < 8; ++i) g.w[i] = __shfl_up_sync(0xFFFFFFFFu, f.w[i], d);
  return g;
}

__device__ __forceinline__ Fn shfl_fn(const Fn& f, int src) {
  Fn g;
#pragma unroll
  for (int i = 0; i < 8; ++i) g.w[i] = __shfl_sync(0xFFFFFFFFu, f.w[i], src);
  return g;
}

struct Args {
  const int* ls8;     // (8, B*P)
  const int* plens;   // (B,) payload bytes per row
  const int* counts;  // (B,) symbols to decode per row
  long long p;        // payload bytes per row of the planes
  long long n;        // B * P
  int n_tiles;
};

// A: composed transition function of each tile.
__global__ void __launch_bounds__(THREADS)
fsm32_tile_fn(Args a, Fn* __restrict__ tile_fn) {
  using Scan = cub::BlockScan<Fn, THREADS>;
  __shared__ typename Scan::TempStorage tmp;
  const int row = blockIdx.y;
  const long long t = (long long)row * a.n_tiles + blockIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long plen = a.plens[row];
  if (tile0 >= plen) {
    if (threadIdx.x == 0) tile_fn[t] = identity();
    return;
  }
  Fn g = identity();
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    if (j < plen) g = compose(g, byte_fn(load_byte(a.ls8, a.n, row * a.p + j)));
  }
  Fn incl, agg;
  Scan(tmp).InclusiveScan(g, incl, Compose(), agg);
  if (threadIdx.x == 0) tile_fn[t] = agg;
}

// B: entry state of every tile (row state starts at 0). One warp per row.
__global__ void fsm32_tile_entry(const Fn* __restrict__ tile_fn,
                                 int* __restrict__ tile_entry, int n_tiles) {
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += 32) {
    const int t = base + lane;
    Fn f = t < n_tiles ? tile_fn[row0 + t] : identity();
    for (int d = 1; d < 32; d <<= 1) {
      const Fn g = shfl_up_fn(f, d);
      if (lane >= d) f = compose(g, f);
    }
    Fn before = shfl_up_fn(f, 1);
    if (lane == 0) before = identity();
    if (t < n_tiles) tile_entry[row0 + t] = apply_fn(before, carry);
    carry = apply_fn(shfl_fn(f, 31), carry);
  }
}

// C: entry state of every byte (kept in ent) and symbols per tile.
__global__ void __launch_bounds__(THREADS)
fsm32_tile_count(Args a, const int* __restrict__ tile_entry,
                 uint8_t* __restrict__ ent, long long* __restrict__ tile_cnt) {
  using Scan = cub::BlockScan<Fn, THREADS>;
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
  Fn g = identity();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    by[i] = Byte{0ull, 0ull};
    if (j < plen) {
      by[i] = load_byte(a.ls8, a.n, row * a.p + j);
      g = compose(g, byte_fn(by[i]));
    }
  }
  Fn excl, agg;
  Scan(tmp.scan).ExclusiveScan(g, excl, identity(), Compose(), agg);
  int q = apply_fn(excl, tile_entry[t]);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    if (j < plen) {
      ent[row * a.p + j] = (uint8_t)q;
      cnt += replay(by[i], q, nullptr);
    }
  }
  __syncthreads();  // tmp is reused
  const int total = Reduce(tmp.reduce).Sum(cnt);
  if (threadIdx.x == 0) tile_cnt[t] = total;
}

__device__ __forceinline__ uint32_t top_bytes(uint32_t v, long long n) {
  return n > 0 ? v & (0xFFFFFFFFu << (32 - 8 * (int)n)) : 0u;
}

// E: replay and write the packs; lanes past the row's payload get zeros.
__global__ void __launch_bounds__(THREADS)
fsm32_tile_emit(Args a, const uint8_t* __restrict__ ent,
                const long long* __restrict__ tile_off,
                const long long* __restrict__ totals, int* __restrict__ packs,
                int* __restrict__ under) {
  using Scan = cub::BlockScan<int, THREADS>;
  __shared__ typename Scan::TempStorage tmp;
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
      int q = ent[row * a.p + j];
      nb[i] = replay(load_byte(a.ls8, a.n, row * a.p + j), q, &sym[i]);
      cnt += nb[i];
    }
  }
  int excl, agg;
  Scan(tmp).ExclusiveSum(cnt, excl, agg);
  long long before = tile_off[(long long)row * a.n_tiles + blockIdx.x] + excl;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = tile0 + threadIdx.x * ITEMS + i;
    if (j < a.p) {
      const long long allowed =
          min(max(count - before, 0ll), (long long)nb[i]);
      const long long n1 = min(allowed, 4ll);
      const long long n2 = max(allowed - 4, 0ll);
      val1[j] = (int)top_bytes((uint32_t)(sym[i] >> 32), n1);
      val2[j] = (int)top_bytes((uint32_t)sym[i], n2);
      len1[j] = (int)(8 * n1);
      len2[j] = (int)(8 * n2);
    }
    before += nb[i];
  }
}

}  // namespace

extern "C" {

// Bytes per tile: the wrapper sizes the (B, n_tiles) scratch with it.
int shafa_fsm32_tile_bytes() { return TILE; }

// ls8: (8, B*P); plens, counts: (B,); tile_fn: (B, n_tiles) 32-byte
// functions, tile_entry (i32), tile_cnt, tile_off (i64): (B, n_tiles)
// scratch; totals: (B,) i64 scratch; ent: (B, P) u8 scratch; packs: (4, B,
// P) i32 (val1, val2, len1, len2); under: (B,) i32.
int shafa_fsm32(const int* ls8, const int* plens, const int* counts, int b,
                long long p, void* tile_fn, int* tile_entry,
                long long* tile_cnt, long long* tile_off, long long* totals,
                uint8_t* ent, int* packs, int* under, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const Args a{ls8, plens, counts, p, (long long)b * p, n_tiles};
  Fn* fns = static_cast<Fn*>(tile_fn);
  const dim3 grid(n_tiles, b);
  fsm32_tile_fn<<<grid, THREADS, 0, stream>>>(a, fns);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  fsm32_tile_entry<<<b, 32, 0, stream>>>(fns, tile_entry, n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  fsm32_tile_count<<<grid, THREADS, 0, stream>>>(a, tile_entry, ent, tile_cnt);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  const int rc = shafa_row_exclusive_scan(tile_cnt, tile_off, totals, b,
                                          n_tiles, stream);
  if (rc) return rc;
  fsm32_tile_emit<<<grid, THREADS, 0, stream>>>(a, ent, tile_off, totals,
                                                packs, under);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
