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
// bytes written once (this design reads the input three times).
//
// Design, with tiles of 4096 bytes of one row (256 threads x 16
// consecutive bytes, one int4 load each):
//   A  each tile's last run start (the last byte that differs from the one
//      before it; byte 0 of a row always starts a run).
//   B  one block per row: an exclusive max-scan over its tiles gives the
//      run start in force at each tile's first byte. A run may span any
//      number of tiles, so this carry has no fixed reach.
//   C1 each tile: its threads' run starts in force (a block max-scan) and
//      the next run start after each thread's bytes (a block min-scan from
//      the right, then the first run start in the 254 bytes past the tile,
//      clipped at the row's length: a sub-run is at most 255 bytes long).
//      A thread marks its sub-run starts: run starts, and every 255th byte
//      after one (a counter taken modulo 255 from the run start in force).
//      The tile where a sub-run starts owns all of its output: 3 bytes if
//      it is escaped, else its 1-3 bytes. C1 writes each tile's byte count.
//   B2 one block per row: an exclusive sum over its tiles' counts gives
//      each tile's int64 output offset in the row, and the row's length.
//   C2 each tile again, as C1, then a block scan of its threads' counts:
//      each thread writes its sub-runs' bytes into shared memory (at most
//      3 bytes an input byte), and the tile stores them as 16-byte words,
//      the two edge words that a neighbouring tile may share byte by byte.
//      Its threads count the bytes they write in per-warp shared bins (a
//      warp adds its 0x00 bytes, the most frequent, once), and the tile
//      adds the bins to the row's global histogram, zeroed on the stream
//      before pass A.
// The TPU kernel's input was one (val, bitlen) payload a lane from the run
// analysis, whose cummax/cummin scans ran in XLA; here the output is byte
// granular, so the tiles write bytes and build no payloads.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // consecutive input bytes per thread
constexpr int TILE = THREADS * ITEMS;  // input bytes per tile
constexpr int MAX_RUN = 255;
constexpr int MIN_ESCAPE_RUN = 4;
constexpr int HALO = MAX_RUN - 1;      // bytes past a tile a sub-run reaches
constexpr int STAGE = 3 * TILE + 16;   // a tile's output and its lead bytes
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const uint8_t* x;  // (B, P) rows
  const int* lens;   // (B,) bytes per row
  long long p;       // row width, a multiple of 16, below 2^30
  int n_tiles;
};

__device__ __forceinline__ int row_len(const Args& a, int row) {
  return (int)min(max((long long)a.lens[row], 0ll), a.p);
}

// A thread's 16 bytes from j0 on: byte i is byte i & 3 of w[i >> 2];
// v of them lie below the row's length; bit i of starts is set where byte
// i starts a run.
struct Chunk {
  uint32_t w[4];
  int j0;
  int v;
  uint32_t starts;

  __device__ __forceinline__ uint32_t at(int i) const {
    const uint32_t word = i < 8 ? (i < 4 ? w[0] : w[1])
                                : (i < 12 ? w[2] : w[3]);
    return (word >> (8 * (i & 3))) & 0xFFu;
  }
};

__device__ __forceinline__ Chunk load_chunk(const Args& a, int row, int j0,
                                            int len) {
  Chunk c;
  c.j0 = j0;
  c.v = max(min(len - j0, ITEMS), 0);
  c.starts = 0;
  c.w[0] = c.w[1] = c.w[2] = c.w[3] = 0;
  if (c.v == 0) return c;
  const uint8_t* src = a.x + (long long)row * a.p + j0;
  const int4 q = *reinterpret_cast<const int4*>(src);
  c.w[0] = (uint32_t)q.x;
  c.w[1] = (uint32_t)q.y;
  c.w[2] = (uint32_t)q.z;
  c.w[3] = (uint32_t)q.w;
  // the byte before: at a row's start, one that differs from byte 0
  uint32_t prev = j0 > 0 ? (uint32_t)src[-1] : (~c.w[0] & 0xFFu);
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t shifted = (c.w[k] << 8) | prev;
    prev = c.w[k] >> 24;
    // 0xFF in each byte that differs from the byte before it, gathered
    // into 4 bits (bit k of a word: byte k)
    const uint32_t e = (__vcmpne4(c.w[k], shifted) >> 7) & 0x01010101u;
    m |= ((e * 0x00204081u) >> 21 & 0xFu) << (4 * k);
  }
  c.starts = m & ((1u << c.v) - 1u);
  return c;
}

__device__ __forceinline__ int block_max(int v, int* warp_v) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) warp_v[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = warp_v[0];
  for (int w = 1; w < WARPS; ++w) r = max(r, warp_v[w]);
  return r;
}

// A: each tile's last run start, -1 where it has none (or lies past the
// row's length).
__global__ void __launch_bounds__(THREADS)
rle_enc_changes(Args a, int* __restrict__ tile_last) {
  __shared__ int warp_v[WARPS];
  const long long t = blockIdx.x;
  const int row = (int)(t / a.n_tiles);
  const int tile0 = (int)(t - (long long)row * a.n_tiles) * TILE;
  const int len = row_len(a, row);
  int last = -1;
  if (tile0 < len) {
    const Chunk c = load_chunk(a, row, tile0 + ITEMS * threadIdx.x, len);
    if (c.starts) last = c.j0 + 31 - __clz(c.starts);
  }
  last = block_max(last, warp_v);
  if (threadIdx.x == 0) tile_last[t] = last;
}

// B and B2: one block per row, an exclusive scan over the row's tiles (max
// from -1, or sum from 0) into out; the sum's total goes to total[row]. The
// row is walked in chunks of S_THREADS * S_ITEMS tiles: each thread folds
// S_ITEMS consecutive values, a warp scan and the warps' aggregates give
// each thread's start, and the thread walks it through its values.
constexpr int S_THREADS = 512;
constexpr int S_WARPS = S_THREADS / 32;
constexpr int S_ITEMS = 8;

template <bool SUM>
__device__ __forceinline__ long long fold(long long a, long long b) {
  return SUM ? a + b : max(a, b);
}

template <bool SUM>
__global__ void __launch_bounds__(S_THREADS)
rle_enc_scan(const int* __restrict__ in, long long* __restrict__ out,
             long long* __restrict__ total, int n_tiles) {
  __shared__ long long warp_agg[S_WARPS];
  __shared__ long long carry;
  constexpr long long IDENT = SUM ? 0 : -1;
  const long long row0 = (long long)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = IDENT;
  for (int base = 0; base < n_tiles; base += S_THREADS * S_ITEMS) {
    const int t0 = base + threadIdx.x * S_ITEMS;
    long long own[S_ITEMS];
    long long g = IDENT;
#pragma unroll
    for (int i = 0; i < S_ITEMS; ++i) {
      own[i] = t0 + i < n_tiles ? (long long)in[row0 + t0 + i] : IDENT;
      g = fold<SUM>(g, own[i]);
    }
    long long incl = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = fold<SUM>(o, incl);
    }
    const long long excl = __shfl_up_sync(FULL, incl, 1);
    __syncthreads();  // the carry and warp_agg of the last chunk are read
    if (lane == 31) warp_agg[warp] = incl;
    __syncthreads();
    long long before = carry;
    for (int w = 0; w < warp; ++w) before = fold<SUM>(before, warp_agg[w]);
    if (lane > 0) before = fold<SUM>(before, excl);
#pragma unroll
    for (int i = 0; i < S_ITEMS; ++i) {
      if (t0 + i < n_tiles) out[row0 + t0 + i] = before;
      before = fold<SUM>(before, own[i]);
    }
    __syncthreads();
    if (threadIdx.x == S_THREADS - 1) carry = before;
  }
  __syncthreads();
  if (SUM && threadIdx.x == 0) total[blockIdx.x] = carry;
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

// C1 (EMIT false): each tile's output bytes into tile_bytes. C2 (EMIT
// true): each tile's output bytes at out + row * out_stride + tile_base,
// and their counts added to hist.
template <bool EMIT>
__global__ void __launch_bounds__(THREADS)
rle_enc_tiles(Args a, const long long* __restrict__ tile_rs,
              int* __restrict__ tile_bytes,
              const long long* __restrict__ tile_base,
              uint8_t* __restrict__ out, long long out_stride,
              unsigned long long* __restrict__ hist) {
  __shared__ int warp_max[WARPS];
  __shared__ int warp_min[WARPS];
  __shared__ int warp_sum[WARPS];
  __shared__ int halo_next;
  __shared__ int4 stage[EMIT ? STAGE / 16 : 1];
  __shared__ int bins[EMIT ? WARPS : 1][256];
  const long long t = blockIdx.x;
  const int row = (int)(t / a.n_tiles);
  const int tile0 = (int)(t - (long long)row * a.n_tiles) * TILE;
  const int len = row_len(a, row);
  if (tile0 >= len) {
    if (!EMIT && threadIdx.x == 0) tile_bytes[t] = 0;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_end = tile0 + TILE;
  if constexpr (EMIT) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) bins[w][threadIdx.x] = 0;
  }
  // the first run start in [tile_end, tile_end + HALO) below the length,
  // else the end of that span
  if (threadIdx.x == 0) halo_next = min(tile_end + HALO, len);
  __syncthreads();
  {
    int cand = INT_MAX;
    const int j = tile_end + (int)threadIdx.x;
    const uint8_t* xr = a.x + (long long)row * a.p;
    if (threadIdx.x < HALO && j < len && xr[j] != xr[j - 1]) cand = j;
    cand = __reduce_min_sync(FULL, cand);
    if (lane == 0 && cand != INT_MAX) atomicMin(&halo_next, cand);
  }

  const Chunk c = load_chunk(a, row, tile0 + ITEMS * threadIdx.x, len);
  // the last run start before the thread's bytes, and the first after them
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
  __syncthreads();
  int before = __shfl_up_sync(FULL, pre, 1);
  int after = __shfl_down_sync(FULL, suf, 1);
  if (lane == 0) before = -1;
  if (lane == 31) after = INT_MAX;
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
  for (int w = warp + 1; w < WARPS; ++w) after = min(after, warp_min[w]);
  const int run_start = max((int)tile_rs[t], before);
  const int next_after = min(after, halo_next);

  // sub-run starts: run starts, and bytes 255k past the run start in force
  uint32_t subs = 0;
  {
    int k = c.j0 > 0 ? (c.j0 - 1 - run_start) % MAX_RUN : 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (i < c.v) {
        k = (c.starts >> i & 1u) ? 0 : (k == MAX_RUN - 1 ? 0 : k + 1);
        if (k == 0) subs |= 1u << i;
      }
    }
  }
  // each sub-run's byte and length, in order
  auto sub_run = [&](uint32_t rest, uint32_t& sym, int& n) {
    const int i = __ffs(rest) - 1;
    const uint32_t later = c.starts & ~((2u << i) - 1u);
    const int next = later ? c.j0 + __ffs(later) - 1 : next_after;
    sym = c.at(i);
    n = min(next - (c.j0 + i), MAX_RUN);
  };
  int bytes = 0;
  for (uint32_t rest = subs; rest; rest &= rest - 1) {
    uint32_t sym;
    int n;
    sub_run(rest, sym, n);
    bytes += (n >= MIN_ESCAPE_RUN || sym == 0) ? 3 : n;
  }

  if constexpr (!EMIT) {
    const int s = __reduce_add_sync(FULL, bytes);
    if (lane == 0) warp_sum[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      int r = 0;
      for (int w = 0; w < WARPS; ++w) r += warp_sum[w];
      tile_bytes[t] = r;
    }
  } else {
    // the thread's offset in the tile's output
    int incl = bytes;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int off = incl - bytes, tile_tot = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) off += warp_sum[w];
      tile_tot += warp_sum[w];
    }
    const long long g0 = tile_base[t];
    const int lead = (int)(g0 & 15);  // the tile's offset in its first word
    uint8_t* sb = reinterpret_cast<uint8_t*>(stage) + lead + off;
    int zeros = 0;  // 0x00 bytes written: escape marks and 0x00 symbols
    for (uint32_t rest = subs; rest; rest &= rest - 1) {
      uint32_t sym;
      int n;
      sub_run(rest, sym, n);
      if (n >= MIN_ESCAPE_RUN || sym == 0) {
        sb[0] = 0;
        sb[1] = (uint8_t)sym;
        sb[2] = (uint8_t)n;
        sb += 3;
        zeros += sym == 0 ? 2 : 1;
        if (sym) atomicAdd(&bins[warp][sym], 1);
        atomicAdd(&bins[warp][n], 1);
      } else {
        for (int q = 0; q < n; ++q) sb[q] = (uint8_t)sym;
        sb += n;
        atomicAdd(&bins[warp][sym], n);
      }
    }
    zeros = __reduce_add_sync(FULL, zeros);
    if (lane == 0 && zeros) atomicAdd(&bins[warp][0], zeros);
    __syncthreads();
    uint8_t* orow = out + (long long)row * out_stride;
    const long long end = g0 + tile_tot;
    const long long w0 = g0 >> 4;
    if (tile_tot > 0)
      for (long long w = w0 + threadIdx.x; 16 * w < end; w += THREADS)
        store_word(orow, w, stage[w - w0], g0, end);
    int count = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) count += bins[w][threadIdx.x];
    if (count)
      atomicAdd(&hist[(long long)row * 256 + threadIdx.x],
                (unsigned long long)count);
  }
}

}  // namespace

extern "C" {

// Input bytes per tile: the wrapper sizes the (B, n_tiles) scratch with it.
int shafa_rle_encode_tile_bytes() { return TILE; }

// x: (B, P) u8, P a multiple of 16 below 2^30; lens: (B,) i32; tile_i32:
// (2, B, n_tiles) i32 and tile_i64: (2, B, n_tiles) i64 scratch; out:
// (B, out_stride) u8, out_stride a multiple of 16 of at least 2P + 8;
// out_len: (B,) i64; hist: (B, 256) i64, zeroed here on the stream.
int shafa_rle_encode(const uint8_t* x, const int* lens, int b, long long p,
                     int* tile_i32, long long* tile_i64, uint8_t* out,
                     long long out_stride, long long* out_len,
                     long long* hist, cudaStream_t stream) {
  if (b <= 0) return 0;
  if (p <= 0 || p % 16 || p >= (1ll << 30) || out_stride % 16
      || out_stride < 2 * p + 8)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((p + TILE - 1) / TILE);
  const long long cells = (long long)b * n_tiles;
  const Args a{x, lens, p, n_tiles};
  int* tile_last = tile_i32;
  int* tile_bytes = tile_i32 + cells;
  long long* tile_rs = tile_i64;
  long long* tile_base = tile_i64 + cells;
  unsigned long long* h = reinterpret_cast<unsigned long long*>(hist);
  const cudaError_t err =
      cudaMemsetAsync(hist, 0, (size_t)b * 256 * sizeof(long long), stream);
  if (err != cudaSuccess) return (int)err;
  rle_enc_changes<<<(unsigned)cells, THREADS, 0, stream>>>(a, tile_last);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  rle_enc_scan<false><<<b, S_THREADS, 0, stream>>>(tile_last, tile_rs,
                                                   nullptr, n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  rle_enc_tiles<false><<<(unsigned)cells, THREADS, 0, stream>>>(
      a, tile_rs, tile_bytes, nullptr, nullptr, 0, nullptr);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  rle_enc_scan<true><<<b, S_THREADS, 0, stream>>>(tile_bytes, tile_base,
                                                  out_len, n_tiles);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  rle_enc_tiles<true><<<(unsigned)cells, THREADS, 0, stream>>>(
      a, tile_rs, nullptr, tile_base, out, out_stride, h);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
