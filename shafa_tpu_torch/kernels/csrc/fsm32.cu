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
// the row's count go MSB first into two packs per byte (the first four, the
// rest), which K6 writes interleaved into (B, 2P) vals and lens, lane 2j
// and 2j + 1 for byte j, the layout K1's bits variant concatenates into the
// decoded rows (decode.py:1444). A row whose payload holds fewer symbols
// than its count underruns.
//
// Bound on the H100: device-memory bytes (32 B of planes per payload byte,
// read twice, and 16 B of packs written) and the compositions of 32-state
// functions. K3 packs a function into 16 nibbles of a u64; 32 states of 5
// bits do not fit, so here a function is 32 bytes (Fn: byte k of w[i] is
// the image of state 4i + k) and composition is a table lookup done with
// byte permutes (prmt): 7 per 4 states. Composing with one byte's function
// takes 1 permute per 4 states (then_byte), and a byte's lengths, symbols
// and E table live in pairs of u32 read by byte permutes.
//
// Design: the TPU kernel carries the entry state and the running count in
// SMEM from tile to tile (decode.py:649-727). Here, with 2048-byte tiles:
//   A  each tile composes its bytes' functions: a warp scan, then warp 0
//      over the warp aggregates;
//   B  one block per row turns the tile functions into every tile's entry
//      state (EntryStates over chunks of 4096 tiles);
//   P  each tile turns its entry state into every byte's (EntryStates: a
//      warp scan of functions, one thread walking the state through the
//      warp aggregates), replays the bytes' symbols into registers, takes
//      its first output position from a decoupled look-back over its row's
//      earlier tiles' symbol counts, and writes the packs clipped at the
//      row's count. Tiles take row-major ids from a ticket, so a tile waits
//      only on tiles already running.
// A thread owns 8 consecutive payload bytes, which makes its lanes of a
// plane 32 bytes apart from its neighbour's: read straight from device
// memory, a warp's loads and stores would each touch 32 sectors and use
// half of each. So A and P copy the tile's plane slices, four planes (32
// KB) at a time, into shared memory with int4 loads that cover 512
// contiguous bytes a warp, and P writes its packs back through the same
// buffer (stage_packs, write_packs). The byte's E table and the look-back
// are fsm_common.cuh's, shared with K3.
#include <cub/block/block_scan.cuh>

#include "fsm_common.cuh"

namespace {

using namespace shafa_fsm;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;               // consecutive payload bytes per thread
constexpr int TILE = THREADS * ITEMS;  // payload bytes per block

// A function of the 32 states: byte k of w[i] is the image of state 4i + k.
struct alignas(16) Fn {
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

// Four lengths of six bits (one per byte) clipped to [1, 32].
__device__ __forceinline__ uint32_t clip_lens(uint32_t x) {
  x &= 0x3F3F3F3Fu;
  const uint32_t over = ((x + 0x5F5F5F5Fu) & 0x80808080u) >> 7;  // > 32
  x = (x & ~(over * 0xFFu)) | (over * 0x20u);
  return x | ((~(x + 0x7F7F7F7Fu) & 0x80808080u) >> 7);  // 0 -> 1
}

// Shared memory of passes A and P: the tile's lanes of 4 of the 8 planes
// at a time, stage[b * TILE + j] (32 KB); P then reuses it for its packs.
constexpr int STAGE_BYTES = 4 * TILE * 4;

// Thread t's ITEMS consecutive payload bytes (tile lanes 8t..8t+7) from
// the tile's lanes [0, avail) of the 8 planes (from lane0 = r*P + tile0
// on), read by the whole block. Four planes at a time go to stage: thread
// t copies lanes 4t + 4 * THREADS * k, so a warp's int4 loads cover 512
// contiguous bytes; then each thread reads its own lanes (two int4 a
// plane) and keeps their lo (then hi) words of lengths and symbols. A
// copy reads up to the multiple of 4 above avail, which stays inside the
// row since P - tile0 is a multiple of 8. mine: the thread has bytes below
// the row's payload length.
__device__ __forceinline__ void load_items(const int* __restrict__ ls8,
                                           long long n, long long lane0,
                                           long long avail, bool mine,
                                           int4* stage, Byte (&by)[ITEMS]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half) __syncthreads();  // the first half's reads are done
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int* plane = ls8 + (4 * half + b) * n + lane0;
#pragma unroll
      for (int k = 0; k < TILE / (4 * THREADS); ++k) {
        const int j = 4 * (threadIdx.x + THREADS * k);
        if (j < avail)
          stage[(b * TILE + j) / 4] =
              __ldg(reinterpret_cast<const int4*>(plane + j));
      }
    }
    __syncthreads();
    if (!mine) continue;
    int v[4][ITEMS];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int4* src = stage + (b * TILE + ITEMS * threadIdx.x) / 4;
      const int4 lo = src[0];
      const int4 hi = src[1];
      v[b][0] = lo.x, v[b][1] = lo.y, v[b][2] = lo.z, v[b][3] = lo.w;
      v[b][4] = hi.x, v[b][5] = hi.y, v[b][6] = hi.z, v[b][7] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const uint32_t len =
          clip_lens(gather4(v[0][i], v[1][i], v[2][i], v[3][i], 0x0051u));
      const uint32_t sym = gather4(v[0][i], v[1][i], v[2][i], v[3][i],
                                   0x0040u);
      if (half == 0) {
        by[i].len_lo = len;
        by[i].sym_lo = sym;
      } else {
        by[i].len_hi = len;
        by[i].sym_hi = sym;
      }
    }
  }
}

// "g then the byte whose E is (e_lo, e_hi)": each image x = g(s) < 32
// becomes E[x] (one byte permute over E's 8 bytes) where x < 8 and x - 8
// elsewhere, four states per word.
__device__ __forceinline__ Fn then_byte(const Fn& g, uint32_t e_lo,
                                        uint32_t e_hi) {
  Fn r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = g.w[i];
    const uint32_t ex = __byte_perm(e_lo, e_hi, nibbles(x & 0x07070707u));
    // bit 7 of a byte: x >= 8 (x & 0x18 is 0, 8, 16 or 24: no carry out)
    const uint32_t big = ((x & 0x18181818u) + 0x78787878u) & 0x80808080u;
    const uint32_t mask = (big >> 7) * 0xFFu;
    const uint32_t less8 = ((x | 0x80808080u) - 0x08080808u) & 0x7F7F7F7Fu;
    r.w[i] = (less8 & mask) | (ex & ~mask);
  }
  return r;
}

// g then the functions of ITEMS bytes from payload byte j0 on, in order
// (bytes past plen left out).
__device__ __forceinline__ Fn items_fn(Fn g, const Byte (&by)[ITEMS],
                                       long long j0, long long plen) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (j0 + i < plen) {
      uint32_t e_lo, e_hi;
      byte_e(by[i], e_lo, e_hi);
      g = then_byte(g, e_lo, e_hi);
    }
  }
  return g;
}

// Replay of a byte entered in state q: its symbols MSB first in (hi, lo)
// (the first in the top byte of hi), their count returned, q left at the
// next byte's entry state.
__device__ __forceinline__ int replay(const Byte& by, int& q, uint32_t& hi,
                                      uint32_t& lo) {
  uint32_t a_hi = 0, a_lo = 0;  // the symbols so far, the last lowest
  int n = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (q >= 8) break;
    a_hi = __funnelshift_l(a_lo, a_hi, 8);
    a_lo = (a_lo << 8) | byte_at(by.sym_lo, by.sym_hi, q);
    q += (int)byte_at(by.len_lo, by.len_hi, q);
    ++n;
  }
  q -= 8;
  const u64 a = n ? (((u64)a_hi << 32) | a_lo) << (64 - 8 * n) : 0ull;
  hi = (uint32_t)(a >> 32);
  lo = (uint32_t)a;
  return n;
}

__device__ __forceinline__ Fn shfl_up_fn(const Fn& f, int d) {
  Fn g;
#pragma unroll
  for (int i = 0; i < 8; ++i) g.w[i] = __shfl_up_sync(0xFFFFFFFFu, f.w[i], d);
  return g;
}

// Inclusive scan of the functions of a warp's first WIDTH lanes in lane
// order: lane l gets lanes 0..l composed, lane 0's first.
template <int WIDTH>
__device__ __forceinline__ Fn warp_scan_fn(Fn f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < WIDTH; d <<= 1) {
    const Fn g = shfl_up_fn(f, d);
    if (lane >= d) f = compose(g, f);
  }
  return f;
}

// A block's exclusive scan of its threads' functions, applied to the
// block's entry state: every thread's entry state. A warp scans its
// functions; one thread walks the state through the WARPS warp aggregates
// (a byte lookup each); each thread applies its warp's exclusive prefix
// to its warp's entry state.
template <int WARPS>
struct EntryStates {
  Fn warp_fn[WARPS];
  int warp_entry[WARPS];

  // entry: the block's entry state, read by thread 0 only. Returns the
  // carried state after the whole block (thread 0 only).
  __device__ __forceinline__ int run(const Fn& g, int entry, int& q) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Fn incl = warp_scan_fn<32>(g);
    Fn excl = shfl_up_fn(incl, 1);
    if (lane == 0) excl = identity();
    if (lane == 31) warp_fn[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < WARPS; ++w) {
        warp_entry[w] = entry;
        entry = reinterpret_cast<const uint8_t*>(&warp_fn[w])[entry];
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
  long long p;        // payload bytes per row of the planes
  long long n;        // B * P
  int n_tiles;
};

// A: composed transition function of each tile. A warp scans its
// threads' functions, warp 0 scans the warp aggregates.
__global__ void __launch_bounds__(THREADS)
fsm32_tile_fn(Args a, Fn* __restrict__ tile_fn) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int4 stage[STAGE_BYTES / 16];
  __shared__ Fn warp_fn[WARPS];
  const int row = blockIdx.y;
  const long long t = (long long)row * a.n_tiles + blockIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long plen = a.plens[row];
  if (tile0 >= plen) {
    if (threadIdx.x == 0) tile_fn[t] = identity();
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j0 = tile0 + threadIdx.x * ITEMS;
  Byte by[ITEMS];
  load_items(a.ls8, a.n, row * a.p + tile0, plen - tile0, j0 < plen, stage,
             by);
  const Fn g = j0 < plen ? items_fn(identity(), by, j0, plen) : identity();
  const Fn incl = warp_scan_fn<32>(g);
  if (lane == 31) warp_fn[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const Fn f = warp_scan_fn<WARPS>(lane < WARPS ? warp_fn[lane]
                                                  : identity());
    if (lane == WARPS - 1) tile_fn[t] = f;
  }
}

// B: entry state of every tile (row state starts at 0). One block per row
// walks it in chunks of B_THREADS * B_ITEMS tiles: each thread composes
// B_ITEMS consecutive tile functions, EntryStates gives each thread's entry
// state, and the thread walks it through its tiles.
constexpr int B_THREADS = 512;
constexpr int B_ITEMS = 8;

__global__ void __launch_bounds__(B_THREADS)
fsm32_tile_entry(const Fn* __restrict__ tile_fn,
                 int* __restrict__ tile_entry, int n_tiles) {
  __shared__ EntryStates<B_THREADS / 32> es;
  __shared__ int carry;
  const long long row0 = (long long)blockIdx.x * n_tiles;
  if (threadIdx.x == 0) carry = 0;
  for (int base = 0; base < n_tiles; base += B_THREADS * B_ITEMS) {
    const int t0 = base + threadIdx.x * B_ITEMS;
    Fn g = identity();
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i)
      if (t0 + i < n_tiles) g = compose(g, tile_fn[row0 + t0 + i]);
    __syncthreads();  // es and carry are reused
    int q;
    const int out = es.run(g, carry, q);
    if (threadIdx.x == 0) carry = out;
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      if (t0 + i < n_tiles) {
        tile_entry[row0 + t0 + i] = q;
        q = reinterpret_cast<const uint8_t*>(tile_fn + row0 + t0 + i)[q];
      }
    }
  }
}

__device__ __forceinline__ uint32_t top_bytes(uint32_t v, int n) {
  return n > 0 ? v & (0xFFFFFFFFu << (32 - 8 * n)) : 0u;
}

// The packs of a tile leave through stage: thread t's 2 * ITEMS lanes of
// vals (and of lens) are 16-byte chunks 4t + c, c < 4, of the tile's 4 *
// THREADS chunks. Chunk q sits at slot 4(q / 4) + (q % 4 ^ (q / 8) % 4), so
// the writes of 8 neighbouring threads fall in 8 distinct 16-byte slots of
// the banks, and the copy-out reads 8 neighbouring chunks likewise.
constexpr int CHUNKS = 2 * TILE / 4;  // int4 chunks of vals per tile

__device__ __forceinline__ int chunk_slot(int q) {
  return 4 * (q >> 2) + ((q & 3) ^ ((q >> 3) & 3));
}

__device__ __forceinline__ void stage_packs(int4* stage,
                                            const int (&v)[2 * ITEMS],
                                            const int (&l)[2 * ITEMS]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s = chunk_slot(4 * threadIdx.x + c);
    stage[s] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    stage[CHUNKS + s] =
        make_int4(l[4 * c], l[4 * c + 1], l[4 * c + 2], l[4 * c + 3]);
  }
}

// The tile's vals and lens from lane 2 * tile0 of the row on, up to the
// row's 2P lanes: thread t writes chunks t + THREADS * k, so a warp's int4
// stores cover 512 contiguous bytes. stage null: zeros.
__device__ __forceinline__ void write_packs(const int4* stage,
                                            int* __restrict__ vals,
                                            int* __restrict__ lens,
                                            long long avail) {
#pragma unroll
  for (int k = 0; k < CHUNKS / THREADS; ++k) {
    const int q = threadIdx.x + THREADS * k;
    if (4 * q < avail) {
      const int4 zero = make_int4(0, 0, 0, 0);
      reinterpret_cast<int4*>(vals)[q] = stage ? stage[chunk_slot(q)] : zero;
      reinterpret_cast<int4*>(lens)[q] =
          stage ? stage[CHUNKS + chunk_slot(q)] : zero;
    }
  }
}

// P: every byte's entry state, replay, the look-back, the packs (lane 2j:
// byte j's first pack, lane 2j + 1: its second; zeros past the row's
// payload) and the underrun flag, written by the tile that holds the row's
// last payload byte (tile 0 of a row without payload).
__global__ void __launch_bounds__(THREADS)
fsm32_tile_packs(Args a, const int* __restrict__ tile_entry,
                 u64* __restrict__ status, int* __restrict__ ticket,
                 int* __restrict__ vals, int* __restrict__ lens,
                 int* __restrict__ under) {
  using CountScan = cub::BlockScan<int, THREADS>;
  __shared__ int4 stage[STAGE_BYTES / 16];
  __shared__ EntryStates<THREADS / 32> es;
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
  const long long j0 = tile0 + threadIdx.x * ITEMS;
  int* vtile = vals + 2 * (row * a.p + tile0);
  int* ltile = lens + 2 * (row * a.p + tile0);
  if (tile0 >= plen) {
    if (k == 0 && threadIdx.x == 0) under[row] = count > 0 ? 1 : 0;
    write_packs(nullptr, vtile, ltile, 2 * (a.p - tile0));
    return;
  }
  const int entry = threadIdx.x == 0 ? tile_entry[t] : 0;
  Byte by[ITEMS];
  load_items(a.ls8, a.n, row * a.p + tile0, plen - tile0, j0 < plen, stage,
             by);
  const Fn g = j0 < plen ? items_fn(identity(), by, j0, plen) : identity();
  int q;
  es.run(g, entry, q);
  uint32_t sym_hi[ITEMS], sym_lo[ITEMS];
  uint32_t nbs = 0;  // 4 bits per byte: its symbols
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sym_hi[i] = sym_lo[i] = 0;
    if (j0 + i < plen) {
      const int n = replay(by[i], q, sym_hi[i], sym_lo[i]);
      nbs |= (uint32_t)n << (4 * i);
      cnt += n;
    }
  }
  int excl_cnt, tile_cnt;
  CountScan(scan).ExclusiveSum(cnt, excl_cnt, tile_cnt);
  if (threadIdx.x < 32) {
    const long long b =
        look_back(status + (long long)row * a.n_tiles, k, tile_cnt);
    if (threadIdx.x == 0) {
      tile_before = b;
      if (plen <= tile0 + TILE) under[row] = b + tile_cnt < count ? 1 : 0;
    }
  }
  __syncthreads();
  long long before = tile_before + excl_cnt;
  int v[2 * ITEMS], l[2 * ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int nb = (int)((nbs >> (4 * i)) & 15u);
    const int allowed = (int)min(max(count - before, 0ll), (long long)nb);
    const int n1 = min(allowed, 4);
    const int n2 = max(allowed - 4, 0);
    v[2 * i] = (int)top_bytes(sym_hi[i], n1);
    v[2 * i + 1] = (int)top_bytes(sym_lo[i], n2);
    l[2 * i] = 8 * n1;
    l[2 * i + 1] = 8 * n2;
    before += nb;
  }
  // the planes' last reads were before EntryStates' barriers
  stage_packs(stage, v, l);
  __syncthreads();
  write_packs(stage, vtile, ltile, 2 * (a.p - tile0));
}

}  // namespace

extern "C" {

// Bytes per tile: the wrapper sizes the (B, n_tiles) scratch with it.
int shafa_fsm32_tile_bytes() { return TILE; }

// ls8: (8, B*P), P a multiple of 8; plens, counts: (B,); tile_fn: (B,
// n_tiles) 32-byte functions, tile_entry: (B, n_tiles) i32, status: B *
// n_tiles + 1 u64 (the look-back's words, then the ticket), all scratch;
// vals, lens: (B, 2P) i32, lane 2j byte j's first pack, lane 2j + 1 its
// second; under: (B,) i32.
int shafa_fsm32(const int* ls8, const int* plens, const int* counts, int b,
                long long p, void* tile_fn, int* tile_entry, u64* status,
                int* vals, int* lens, int* under, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (p % ITEMS) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const long long tiles = (long long)b * n_tiles;
  const Args a{ls8, plens, counts, p, (long long)b * p, n_tiles};
  Fn* fns = static_cast<Fn*>(tile_fn);
  fsm32_tile_fn<<<dim3(n_tiles, b), THREADS, 0, stream>>>(a, fns);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  fsm32_tile_entry<<<b, B_THREADS, 0, stream>>>(fns, tile_entry, n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  // the look-back's words and the ticket start at 0
  const cudaError_t err =
      cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(u64), stream);
  if (err != cudaSuccess) return (int)err;
  fsm32_tile_packs<<<(unsigned)tiles, THREADS, 0, stream>>>(
      a, tile_entry, status, reinterpret_cast<int*>(status + tiles), vals,
      lens, under);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
